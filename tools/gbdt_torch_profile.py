"""Where a GBDT fit of the PyTorch port spends its time on the card.

    python3 tools/gbdt_torch_profile.py [--rows 200000] [--rounds 20]

Uses the data of ``chip_smoke.py``'s main path (x ~ N(0,1), 64 features,
seed 3; y = x0 + x1*x2 > 0; 63 leaves, ``min_data_in_leaf=20``). For each
growth policy, and for each of ``fused_rounds=0`` (one round captured as a
CUDA graph and replayed) and ``fused_rounds=1`` (the same round run
eagerly, every kernel launched from Python), it
prints one JSON line with:

- ``binning_s``: wall time of ``BinMapper.fit`` + ``bin_tensor`` on the
  card alone (the host-to-device copy of the float matrix included);
- ``train_s``: wall time of ``train(..., device="cuda")`` (binning
  included), measured without the profiler, after a warm-up fit;
- under ``torch.profiler`` (a third, traced fit): the summed device time
  of all kernels, the device-busy share of the traced fit's wall time,
  the device kernels per tree, the host's launch calls per tree (kernel
  launches and graph launches: what the host pays for), the top kernels by
  device time, and the histogram builders' device time with all their
  passes (memset, scan, hist, convert; ``histogram_parts_ms`` lists each
  with its count).

The first line names the card, PyTorch, and the card's power limit.

    python3 tools/gbdt_torch_profile.py --gate [--package-root DIR]

times bench.py's sklearn cell instead (the round's gate: x ~ N(0,1) of
125,000 x 32 from ``default_rng(7)``, y = sin(2 x0) + x1 x2 > 0, 100,000
training rows, 50 rounds, 63 leaves, seed 7; lossguide, depthwise and
lossguide at ``max_bin=63``): ``train`` seconds, best of 3 after a
warm-up, and the binning of the same rows alone, with the port imported
from ``DIR`` (default: this checkout), so one call can time two commits
in turns, e.g. a parent unpacked by ``git archive``.

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


def _package_root() -> str:
    if "--package-root" in sys.argv:
        return os.path.abspath(sys.argv[sys.argv.index("--package-root") + 1])
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


sys.path.insert(0, _package_root())

from mmlspark_tpu_torch.models.gbdt import BinMapper, TrainConfig, train  # noqa: E402
from mmlspark_tpu_torch.ops import histogram as H  # noqa: E402

_HIST_PASSES = ("scan_rows_kernel", "hist_kernel", "to_float_kernel")
_HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")


def binning_seconds(x: np.ndarray, cfg: TrainConfig) -> float:
    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xd = torch.from_numpy(x).to("cuda")
        mapper = BinMapper.fit(xd, max_bin=cfg.max_bin, seed=cfg.seed, device="cuda")
        mapper.bin_tensor(xd, "cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()  # warm: the CUDA context and PyTorch's kernels
    return run()


def profile_fit(x, y, cfg: TrainConfig, fused_rounds: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    train(x, y, cfg, device="cuda", fused_rounds=fused_rounds)  # warm
    torch.cuda.synchronize()
    H.reset_launch_counts()
    t0 = time.perf_counter()
    booster = train(x, y, cfg, device="cuda", fused_rounds=fused_rounds)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(H.launches)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(x, y, cfg, device="cuda", fused_rounds=fused_rounds)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host_launches = [e for e in events if e.name in _HOST_LAUNCHES]
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
        "policy": cfg.growth_policy, "fused_rounds": fused_rounds, "rows": len(y),
        "trees": trees, "train_s": train_s, "trees_per_s": trees / train_s,
        "hist_wrapper_launches": launches,
        "traced_train_s": traced_s,
        "device_kernel_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / traced_s,
        "device_kernels_per_tree": len(kernels) / trees,
        "host_launch_calls_per_tree": len(host_launches) / trees,
        "graph_launches": sum(e.name == "cudaGraphLaunch" for e in host_launches),
        "histogram_device_s": sum(ms for ms, _ in parts.values()) / 1e3,
        "histogram_parts_ms": [
            {"name": k[:80], "device_ms": ms, "count": c} for k, (ms, c) in parts.items()
        ],
        "top_kernels_ms": [
            {"name": k[:80], "device_ms": us / 1e3, "count": c}
            for k, us, c in by_name[:8] if us > 0
        ],
    }


def gate(root: str) -> None:
    """The gate cell's ``train`` seconds and binning seconds, on the port
    at ``root`` (its own defaults: a commit without device binning bins
    on the host)."""
    import inspect

    rng = np.random.default_rng(7)
    x = rng.normal(size=(125_000, 32)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2] > 0).astype(np.float64)
    x, y = x[:100_000], y[:100_000]
    on_device = "device" in inspect.signature(BinMapper.fit).parameters

    def binning() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if on_device:
            xd = torch.from_numpy(x).to("cuda")
            BinMapper.fit(xd, max_bin=255, seed=7, device="cuda").bin_tensor(xd, "cuda")
        else:
            torch.from_numpy(BinMapper.fit(x, max_bin=255, seed=7).transform(x)).to("cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    binning()
    out = {"package_root": root, "binning_s": min(binning() for _ in range(3))}
    for name, extra in (("lossguide", {}), ("depthwise", {"growth_policy": "depthwise"}),
                        ("lossguide_b63", {"max_bin": 63})):
        cfg = TrainConfig(objective="binary", num_iterations=50, num_leaves=63,
                          min_data_in_leaf=20, seed=7, **extra)
        train(x, y, cfg, device="cuda")
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            booster = train(x, y, cfg, device="cuda")
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        out[name] = {"train_s": best, "trees": len(booster.trees)}
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--gate", action="store_true")
    ap.add_argument("--package-root", default=None)
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
    if args.gate:
        gate(_package_root())
        return
    for policy in ("lossguide", "depthwise"):
        cfg = TrainConfig(num_iterations=args.rounds, num_leaves=63,
                          min_data_in_leaf=20, seed=0, growth_policy=policy)
        binning_s = binning_seconds(x, cfg)
        for fused_rounds in (0, 1):
            rec = profile_fit(x, y, cfg, fused_rounds)
            print(json.dumps({"binning_s": binning_s, **rec}), flush=True)


if __name__ == "__main__":
    main()
