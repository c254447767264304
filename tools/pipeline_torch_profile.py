"""Where the port's compiled pipelines spend their time on the card.

    python3 tools/pipeline_torch_profile.py

Two cells of ``chip_smoke.py``'s phase ``pipeline``, each fitted on the
card and then scored staged (``model.transform``) and compiled
(``model.compile().transform``, after one warm call that captures its
CUDA graphs):

- ``P1``: bench.py's pipeline cell, 16,384 rows in 4 partitions through
  Featurize -> UDFTransformer(tanh(0.5 x)) -> LogisticRegression;
- ``P2``: 50,000 held-out rows of the trees/s cell's data (64 columns)
  through Featurize -> LightGBMClassifier (20 trees of 63 leaves), fitted
  on the 200,000 training rows.

For each (cell, path) one JSON line from a ``torch.profiler`` trace (CPU
and CUDA): wall time, summed device kernel time, the device-busy share of
the wall, device kernels and their ms by kind, the host's launch calls
(kernel launches, graph launches, copies) and the host seconds spent
packing chunks into the static buffers (compiled path). A trace times the
kernels of a replayed CUDA graph unreliably (their sum can exceed the
wall), so the compiled path's line also carries each graph's device ms per
replay, timed with CUDA events over 50 replays (no copies), and that
time's share of an untraced transform's wall. The first line names the
card, PyTorch and the card's power limit.

Needs a CUDA device; exits nonzero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from featurizer_torch_profile import _kind  # noqa: E402

from mmlspark_tpu_torch import DataFrame, Pipeline  # noqa: E402
from mmlspark_tpu_torch.compiler import fuser  # noqa: E402
from mmlspark_tpu_torch.featurize import Featurize  # noqa: E402
from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier  # noqa: E402
from mmlspark_tpu_torch.models.linear import LogisticRegression  # noqa: E402
from mmlspark_tpu_torch.stages import UDFTransformer  # noqa: E402

_HOST_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cudaMemcpyAsync")


def traced(fn, rows: int) -> dict:
    """One traced call of ``fn``, with the host time inside ``fuser._fill``."""
    from torch.profiler import ProfilerActivity, profile

    fill = {"s": 0.0}
    real_fill = fuser._fill

    def timed_fill(*a):
        t0 = time.perf_counter()
        real_fill(*a)
        fill["s"] += time.perf_counter() - t0

    fuser._fill = timed_fill
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        fuser._fill = real_fill
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    kinds: dict = {}
    for e in dev:
        k = _kind(e.name)
        kinds[k] = kinds.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
    host = {k: 0 for k in _HOST_CALLS}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in host:
            host[e.name] += 1
    return {"rows": rows, "traced_wall_s": wall, "device_kernel_s": device_s,
            "device_busy_share": device_s / wall, "device_kernels": len(dev),
            "device_ms_by_kind": kinds, "host_calls": host, "host_pack_s": fill["s"]}


def replays(comp, fn, df) -> dict:
    """Device ms of one replay of each captured graph (CUDA events over 50
    replays), the replays one transform makes, and their device time's
    share of an untraced transform's wall (median of 5)."""
    per, count = {}, 0
    for seg in comp.fused_segments:
        for key, g in seg._graphs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                g.graph.replay()
            end.record()
            end.synchronize()
            per[f"{seg.name[:40]} bucket {key[0]}"] = start.elapsed_time(end) / 50
    walls = []
    for _ in range(5):
        before = fuser._M_REPLAYS.labels(segment=comp.fused_segments[0].name).value
        t0 = time.perf_counter()
        fn(df)
        walls.append(time.perf_counter() - t0)
        count = int(fuser._M_REPLAYS.labels(segment=comp.fused_segments[0].name).value - before)
    wall = sorted(walls)[2]
    replay_s = sum(per.values()) / len(per) * count / 1e3
    return {"replay_device_ms": per, "replays_per_transform": count, "untraced_wall_s": wall,
            "replay_share_of_wall": replay_s / wall}


def p1_cell():
    rng = np.random.default_rng(7)
    n = 16_384
    cols = {f"x{i}": rng.standard_normal(n) for i in range(16)}
    cols["vec"] = rng.standard_normal((n, 16)).astype(np.float32)
    cols["label"] = rng.integers(0, 4, n)
    df = DataFrame.from_dict(cols, num_partitions=4)
    model = Pipeline([
        Featurize(input_cols=[f"x{i}" for i in range(16)] + ["vec"], output_col="features"),
        UDFTransformer(input_col="features", output_col="features_s", jit_compatible=True,
                       vector_udf=lambda x: torch.tanh(x * 0.5)),
        LogisticRegression(features_col="features_s", label_col="label", max_iter=30),
    ]).fit(df)
    return model, df, n


def p2_cell():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(250_000, 64)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float64)
    names = [f"f{j}" for j in range(64)]
    train_df = DataFrame.from_dict({**{c: x[:200_000, j] for j, c in enumerate(names)},
                                    "label": y[:200_000]})
    model = Pipeline([
        Featurize(input_cols=names, output_col="features"),
        LightGBMClassifier(num_iterations=20, num_leaves=63, min_data_in_leaf=20, seed=0),
    ]).fit(train_df)
    test = DataFrame.from_dict({c: x[200_000:, j] for j, c in enumerate(names)})
    return model, test, 50_000


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("pipeline_torch_profile: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(torch.cuda.get_device_name(0), torch.__version__, smi[:1], flush=True)
    for cell, make in (("P1", p1_cell), ("P2", p2_cell)):
        model, df, rows = make()
        comp = model.compile()
        for path, fn in (("staged", model.transform), ("compiled", comp.transform)):
            fn(df)  # warm: placement, library handles, the graphs' capture
            rec = traced(lambda: fn(df), rows)
            if path == "compiled":
                rec.update(replays(comp, fn, df))
            print(json.dumps({"cell": cell, "path": path, **rec}), flush=True)


if __name__ == "__main__":
    main()
