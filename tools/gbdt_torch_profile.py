"""Where a GBDT fit of the PyTorch port spends its time on the card.

    python3 tools/gbdt_torch_profile.py [--rows 200000] [--rounds 20]

Uses the data of ``chip_smoke.py``'s main path (x ~ N(0,1), 64 features,
seed 3; y = x0 + x1*x2 > 0; 63 leaves, ``min_data_in_leaf=20``). For each
growth policy it prints one JSON line with:

- ``binning_s``: host time of ``BinMapper.fit`` + ``transform`` alone;
- ``train_s``: wall time of ``train(..., device="cuda")`` (binning
  included), measured without the profiler;
- under ``torch.profiler`` (a second, traced fit): the summed device time
  of all kernels, the device-busy share of the traced fit's wall time, the
  number of kernel launches per tree, the top kernels by device time, and
  the histogram builders' device time with all their passes (memset, scan,
  hist, convert; ``histogram_parts_ms`` lists each with its count, so that
  memsets of other origin would show as a count above the histogram calls).

The first line names the card, PyTorch, and the card's power limit.

Needs a CUDA device; exits nonzero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmlspark_tpu_torch.models.gbdt import BinMapper, TrainConfig, train  # noqa: E402
from mmlspark_tpu_torch.ops import histogram as H  # noqa: E402

_HIST_PASSES = ("scan_rows_kernel", "hist_kernel", "to_float_kernel")


def profile_fit(x, y, cfg: TrainConfig) -> dict:
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    mapper = BinMapper.fit(x, max_bin=cfg.max_bin, seed=cfg.seed)
    mapper.transform(x)
    binning_s = time.perf_counter() - t0

    train(x, y, cfg, device="cuda")  # warm: allocator, kernel library load
    torch.cuda.synchronize()
    H.reset_launch_counts()
    t0 = time.perf_counter()
    booster = train(x, y, cfg, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(H.launches)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(x, y, cfg, device="cuda")
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = sorted(
        ((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()),
        key=lambda t: -t[1],
    )
    # one histogram call is a memset and three kernels: scan, hist, convert
    parts = {
        k: (us / 1e3, c) for k, us, c in by_name
        if us > 0 and (k.startswith("Memset") or any(p in k for p in _HIST_PASSES))
    }
    trees = len(booster.trees)
    return {
        "policy": cfg.growth_policy, "rows": len(y), "trees": trees,
        "binning_s": binning_s, "train_s": train_s,
        "hist_launches": launches,
        "traced_train_s": traced_s,
        "device_kernel_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / traced_s,
        "kernel_launches_per_tree": len(kernels) / trees,
        "histogram_device_s": sum(ms for ms, _ in parts.values()) / 1e3,
        "histogram_parts_ms": [
            {"name": k[:80], "device_ms": ms, "count": c} for k, (ms, c) in parts.items()
        ],
        "top_kernels_ms": [
            {"name": k[:80], "device_ms": us / 1e3, "count": c}
            for k, us, c in by_name[:8] if us > 0
        ],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gbdt_torch_profile: needs a CUDA device")
    rng = np.random.default_rng(args.seed)
    x = rng.normal(size=(args.rows, 64)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float64)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(torch.cuda.get_device_name(0), torch.__version__, smi[:1], flush=True)
    for policy in ("lossguide", "depthwise"):
        cfg = TrainConfig(num_iterations=args.rounds, num_leaves=63,
                          min_data_in_leaf=20, seed=0, growth_policy=policy)
        print(json.dumps(profile_fit(x, y, cfg)), flush=True)


if __name__ == "__main__":
    main()
