"""Where the PyTorch port's image featurizer spends its time on the card.

    python3 tools/featurizer_torch_profile.py [--rows 2048] [--batch 256]

The cell of ``chip_smoke.py``'s featurizer phase (bench.py's accelerator
featurizer cell): uint8 224x224x3 rows from ``default_rng(0)``,
``ImageFeaturizer(model_name="ResNet50", cut_output_layers=1)``, seeded
weights. It prints one JSON line per traced window, each under
``torch.profiler``:

- ``transform``: one warm ``transform`` of all rows, then a traced one:
  wall time, summed device time of all kernels, the device-busy share of
  the wall, device ms by kind (convolutions, batch norm, elementwise,
  copies host->device / device->host, the rest), and the top device
  kernels by name with their kind;
- ``resident``: the same for 10 calls of the featurizer net on one
  pre-staged batch (no host copies).

The first line names the card, PyTorch, and the card's power limit. The
zoo is written under ``build/featurizer_profile_zoo`` and removed after.

Needs a CUDA device; exits nonzero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mmlspark_tpu_torch import DataFrame  # noqa: E402
from mmlspark_tpu_torch.models import ImageFeaturizer  # noqa: E402


def _kind(name: str) -> str:
    n = name.lower()
    if "memcpy htod" in n or "memcpy h2d" in n:
        return "copy_h2d"
    if "memcpy dtoh" in n or "memcpy d2h" in n:
        return "copy_d2h"
    if any(k in n for k in ("conv", "sm90_xmma", "implicit_gemm", "cudnn", "gemm", "cutlass")):
        return "conv_gemm"
    if "batch_norm" in n or "bn_fw" in n or "batchnorm" in n:
        return "batch_norm"
    if "elementwise" in n or "vectorized" in n or "reduce" in n:
        return "elementwise_reduce"
    return "other"


def traced(fn, wall_rows: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in events)
    kinds: dict = {}
    names: dict = {}
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        k = _kind(e.name)
        kinds[k] = kinds.get(k, 0.0) + ms
        ms_sum, count, _ = names.get(e.name, (0.0, 0, k))
        names[e.name] = (ms_sum + ms, count + 1, k)
    by_name = sorted(names.items(), key=lambda t: -t[1][0])
    return {
        "rows": wall_rows, "traced_wall_s": wall, "device_kernel_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall, "kernels": len(events),
        "device_ms_by_kind": kinds,
        "top_kernels_ms": [
            {"name": name[:100], "kind": k, "device_ms": ms, "count": c}
            for name, (ms, c, k) in by_name[:14]
        ],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("featurizer_torch_profile: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(torch.cuda.get_device_name(0), torch.__version__, smi[:1], flush=True)
    repo = os.path.join(ROOT, "build", "featurizer_profile_zoo")
    shutil.rmtree(repo, ignore_errors=True)
    imgs = np.random.default_rng(0).integers(0, 255, size=(args.rows, 224, 224, 3),
                                             dtype=np.uint8)
    df = DataFrame.from_dict({"image": imgs})
    feat = ImageFeaturizer(input_col="image", output_col="features", batch_size=args.batch,
                           model_name="ResNet50", cut_output_layers=1, image_size=224,
                           repo_dir=repo)
    feat.transform(df)  # warm: zoo, cuDNN heuristics, allocator
    rec = traced(lambda: feat.transform(df), args.rows)
    print(json.dumps({"window": "transform", **rec}), flush=True)
    net = feat._build()._runner(torch.device("cuda"))
    staged = torch.from_numpy(imgs[: args.batch]).cuda()

    def resident():
        with torch.inference_mode():
            for _ in range(10):
                net(staged)

    resident()
    rec = traced(resident, 10 * args.batch)
    print(json.dumps({"window": "resident", **rec}), flush=True)
    shutil.rmtree(repo, ignore_errors=True)


if __name__ == "__main__":
    main()
