"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mmlspark_tpu_torch/ops/csrc/``, holds
every kernel against its plain PyTorch version (and an f64 CPU result) at
the shapes the main path gives it, and against its PyTorch emulation (the
kernels' own fixed-point arithmetic) bit for bit, times each (``ms``: 20
eager calls back to back, as the main path makes them; ``device_ms``: a
CUDA graph of the same 20 calls, replayed), then drives the main path
(``LightGBMClassifier.fit`` -> ``transform`` on a DataFrame, 200,000 x 64,
63 leaves, 20 rounds) for both growth policies and for ``max_bin=63``, and
checks that every kernel of the path was launched and that the models are
right (held-out AUC >= 0.90; card and CPU fits of the same data agree).
Then the other boosting types and objectives at the same width, each
fit checked for its kernel launches and its quality: GOSS, dart and rf
classifiers, bagging (both growth policies), an early-stopped fit on
250,000 rows with 50,000 validation rows and 10% flipped labels, quantile
and Poisson regressors against their boost_from_average constant, a
LightGBMRanker on 10,000 queries x 20 documents against random scores,
and same-seed GOSS and bagged fits repeated byte for byte.

Each phase prints its own line. The line before the last is the card's
name and power limit, the one before it the kernels' JSON record, and the
last line is ``{"ok": true, "device": {...}}``. Any failure is a nonzero
exit with the traceback: no phase is caught, and nothing falls back to the
CPU. Without a CUDA device the script exits nonzero before any result.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available; this check runs on the card only")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mmlspark_tpu_torch import DataFrame  # noqa: E402
from mmlspark_tpu_torch.core.metrics import binary_auc  # noqa: E402
from mmlspark_tpu_torch.models.gbdt import (  # noqa: E402
    LightGBMClassifier,
    LightGBMRanker,
    LightGBMRegressor,
    TrainConfig,
    objectives,
    train,
)
from mmlspark_tpu_torch.ops import cuda_build  # noqa: E402
from mmlspark_tpu_torch.ops import histogram as H  # noqa: E402

TRAIN = importlib.import_module("mmlspark_tpu_torch.models.gbdt.train")  # host_reads
DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
N, D, N_TEST, N_CPU, SEED = 200_000, 64, 50_000, 20_000, 3
TOL = 1e-5                     # g, h within TOL * sum |stats[:, j]|; counts exact
SOURCE = "mmlspark_tpu_torch/ops/csrc/histogram.cu"
TPU = "mmlspark_tpu/ops/histogram.py"


def phase(name: str, **kv) -> None:
    print(json.dumps({"phase": name, **kv}), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    phase("card", nvidia_smi=out, torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return out


def _sass_atomics(path) -> "dict | None":
    """Atomic opcodes in the library's SASS (None without cuobjdump)."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        return None
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          timeout=120).stdout
    ops: dict = {}
    for tok in sass.split():
        if tok.startswith(("ATOMS", "ATOMG", "ATOM.", "RED.")):
            ops[tok] = ops.get(tok, 0) + 1
    return ops


def build() -> None:
    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    secs = time.perf_counter() - t0
    ptxas = [
        ln.strip() for log in cuda_build.build_logs.values()
        for ln in log.splitlines() if "registers" in ln or "Compiling entry" in ln
    ]
    phase("build", seconds=secs, libraries=[str(p) for p in paths.values()], ptxas=ptxas,
          sass_atomics={s: _sass_atomics(p) for s, p in paths.items()})


# -- kernels against their plain versions -------------------------------------


def _data(n, d, B, seed, oob=True):
    g = torch.Generator(device="cpu").manual_seed(seed)
    lo, hi = (-3, B + 3) if oob else (0, B)
    bins = torch.randint(lo, hi, (n, d), generator=g, dtype=torch.int32)
    stats = torch.stack(
        [torch.randn(n, generator=g), torch.rand(n, generator=g) * 0.25 + 0.01,
         torch.ones(n)], 1,
    ).float()
    return bins, stats


def _f64_plane(bins, stats, B, base=None, S=1):
    """(S, d*B, 3) f64 reference by numpy bincount; base = slot per row."""
    b = bins.numpy().astype(np.int64)
    s = stats.numpy().astype(np.float64)
    n, d = b.shape
    sl = np.zeros(n, np.int64) if base is None else base.numpy().astype(np.int64)
    out = np.zeros((S, d, B, 3))
    ok_row = (sl >= 0) & (sl < S)
    for f in range(d):
        ok = ok_row & (b[:, f] >= 0) & (b[:, f] < B)
        idx = sl[ok] * B + b[ok, f]
        for j in range(3):
            out[:, f, :, j] = np.bincount(idx, s[ok, j], minlength=S * B).reshape(S, B)
    return out.reshape(S, d * B, 3)


def _compare(name, got, plain, ref64, stats, emulated, integer_counts=True):
    """Counts exact (with integer row weights; else like g and h); g, h
    within TOL * sum |stats_j|, against the plain version on the card and
    the f64 CPU result; every bit equal to the emulation of the kernel's
    arithmetic. Returns max |got - plain|."""
    if not torch.equal(got.view(torch.int32), emulated.view(torch.int32)):
        raise AssertionError(f"{name}: differs from its emulation")
    got_c, plain_c = got.double().cpu().numpy(), plain.double().cpu().numpy()
    for want, what in ((plain_c, "plain"), (ref64, "f64")):
        want = want.reshape(got_c.shape)
        if integer_counts and not np.array_equal(got_c[..., 2], want[..., 2]):
            raise AssertionError(f"{name}: counts differ from the {what} result")
        for j in (0, 1) if integer_counts else (0, 1, 2):
            atol = TOL * float(stats[:, j].abs().sum())
            err = float(np.abs(got_c[..., j] - want[..., j]).max())
            if err > atol:
                raise AssertionError(f"{name}: stat {j} off the {what} result by {err} > {atol}")
    return float(np.abs(got_c - plain_c).max())


def _twice(name, fn):
    a, a2 = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a.view(torch.int32), a2.view(torch.int32)):
        raise AssertionError(f"{name}: two runs differ bitwise")
    return a


def check_plane(B: int, keep: "float | None") -> float:
    """Unmasked: int32 bins with codes below 0 and at or above B. Masked
    (keep = the share of rows kept): uint8 bins (the training layout) with
    codes at or above B."""
    bins, stats = _data(N, D, B, seed=B + int(1000 * (keep or 0)))
    mask = None
    if keep is not None:
        mask = (torch.rand(N, generator=torch.Generator().manual_seed(B)) < keep).float()
        bins = bins.clamp(0, 255).to(torch.uint8)
    bd, sd = bins.to(DEV), stats.to(DEV)
    md = mask.to(DEV) if mask is not None else None
    name = f"plane_hist B={B} keep={keep}"
    a = _twice(name, lambda: H.plane_hist(bd, sd, md, B))
    pre = stats if mask is None else stats * mask[:, None]
    err = _compare(name, a, H.plane_histogram_plain(bd, sd, md, B), _f64_plane(bins, pre, B),
                   pre, H.plane_histogram_emulated(bd, sd, md, B))
    torch.cuda.synchronize()
    phase("check", kernel="plane_hist", B=B, keep=keep, bins=str(bins.dtype), n=N, d=D,
          max_abs_err=err, bitwise_repeat=True, bitwise_emulated=True)
    return err


def check_one_bin(B: int = 256) -> float:
    """Feature 3 has all its rows in one bin (every atomic of it on one
    cell); g large and of both signs; fractional row weights in the count
    column, as the grower's row_weight puts them there."""
    g = torch.Generator().manual_seed(77)
    bins = torch.randint(0, B, (N, D), generator=g, dtype=torch.int32)
    bins[:, 3] = 5
    w = torch.rand(N, generator=g) * 2
    stats = torch.stack([torch.randn(N, generator=g) * 1e6 * w,
                         torch.rand(N, generator=g) * w, w], 1).float()
    bd, sd = bins.to(torch.uint8).to(DEV), stats.to(DEV)
    name = "plane_hist one-bin feature"
    a = _twice(name, lambda: H.plane_hist(bd, sd, None, B))
    err = _compare(name, a, H.plane_histogram_plain(bd, sd, None, B), _f64_plane(bins, stats, B),
                   stats, H.plane_histogram_emulated(bd, sd, None, B), integer_counts=False)
    phase("check", kernel="plane_hist", use="one-bin feature, |g| ~ 1e6, fractional weights",
          B=B, n=N, d=D, max_abs_err=err, bitwise_repeat=True, bitwise_emulated=True)
    return err


def check_wide_range(B: int = 256) -> float:
    """One row with |g| = 1e6 among rows of |g| ~ 1e-3 (the fixed-point
    scale follows the largest value): every cell within f32's own summation
    error of the f64 sum, rows * 2^-24 * sum |v|. Returns the largest
    error over bound."""
    g = torch.Generator().manual_seed(91)
    bins = torch.randint(0, B, (N, D), generator=g, dtype=torch.int32)
    stats = torch.stack([torch.randn(N, generator=g) * 1e-3,
                         (torch.rand(N, generator=g) * 0.24 + 0.01) * 1e-3, torch.ones(N)], 1)
    stats[N // 3, :2] = torch.tensor([-1e6, 2.5e5])
    bd, sd = bins.to(torch.uint8).to(DEV), stats.to(DEV)
    name = "plane_hist wide range"
    a = _twice(name, lambda: H.plane_hist(bd, sd, None, B))
    _compare(name, a, H.plane_histogram_plain(bd, sd, None, B), _f64_plane(bins, stats, B),
             stats, H.plane_histogram_emulated(bd, sd, None, B))
    got = a.double().cpu().numpy()
    exact = _f64_plane(bins, stats, B)[0]
    sum_abs = _f64_plane(bins, stats.abs(), B)[0]
    ratio = 0.0
    for j in (0, 1):
        bound = exact[:, 2] * 2.0 ** -24 * sum_abs[:, j]
        ratio = max(ratio, float((np.abs(got[:, j] - exact[:, j]) / np.maximum(bound, 1e-300)).max()))
    if ratio > 1.0:
        raise AssertionError(f"{name}: a cell is off its f64 sum by {ratio}x f32's summation bound")
    phase("check", kernel="plane_hist", use="one |g| = 1e6 row among |g| ~ 1e-3", B=B, n=N,
          d=D, err_over_f32_bound=ratio, bitwise_repeat=True, bitwise_emulated=True)
    return ratio


def check_leaf_sums(L: int = 63) -> float:
    """leaf_stat_sums on the card: plane_hist with d = 1 and B = L."""
    leaf = torch.randint(0, L, (N,), generator=torch.Generator().manual_seed(L),
                         dtype=torch.int32)
    _, stats = _data(N, 1, L, seed=L)
    ld, sd = leaf.to(DEV), stats.to(DEV)
    a = _twice("leaf_stat_sums", lambda: H.leaf_stat_sums(ld, sd, L))
    err = _compare("leaf_stat_sums", a, H.plane_histogram_plain(ld[:, None], sd, None, L),
                   _f64_plane(leaf[:, None], stats, L), stats,
                   H.plane_histogram_emulated(ld[:, None], sd, None, L))
    torch.cuda.synchronize()
    phase("check", kernel="plane_hist", use="leaf_stat_sums", B=L, n=N, d=1,
          max_abs_err=err, bitwise_repeat=True, bitwise_emulated=True)
    return err


def check_multi(S: int) -> float:
    B = 256
    bins, stats = _data(N, D, B, seed=1000 + S)
    slot = torch.randint(-1, S + 2, (N,), generator=torch.Generator().manual_seed(S),
                         dtype=torch.int32)
    bd, sd, sl = bins.to(DEV), stats.to(DEV), slot.to(DEV)
    name = f"multi_plane_hist S={S}"
    a = _twice(name, lambda: H.multi_plane_hist(bd, sd, sl, S, B))
    kept = stats * ((slot >= 0) & (slot < S)).float()[:, None]
    err = _compare(name, a, H.multi_plane_histogram_plain(bd, sd, sl, S, B),
                   _f64_plane(bins, stats, B, slot, S), kept,
                   H.multi_plane_histogram_emulated(bd, sd, sl, S, B))
    torch.cuda.synchronize()
    phase("check", kernel="multi_plane_hist", B=B, S=S, n=N, d=D, max_abs_err=err,
          bitwise_repeat=True, bitwise_emulated=True)
    return err


# -- times at the main-path shapes --------------------------------------------


def time_ms(fn, iters: int = 20) -> "tuple[float, float]":
    """(ms per call: `iters` eager calls back to back between two CUDA
    events, host launch cost included, as the main path runs them; device
    ms per call: a CUDA graph of `iters` calls, replayed, which hides the
    host's launch cost)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / (5 * iters)
    del graph
    return eager, device


def _timed(kernel, plain, library, nbytes: int, ops: int) -> dict:
    rec = {"bytes": nbytes, "ops": ops}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        rec[f"{key}ms"], rec[f"{key}device_ms"] = time_ms(fn)
    rec.update(_bound(nbytes, ops))
    return rec


def _flat(bins, B, base=None):
    n, d = bins.shape
    b = bins.long()
    cell = torch.arange(d, device=bins.device) * B + b
    if base is not None:
        cell = cell + base[:, None] * (d * B)
    return (cell[:, :, None] * 3 + torch.arange(3, device=bins.device)).reshape(-1)


def time_plane(B: int, keep: "float | None" = None) -> dict:
    """The plane at n x d with uint8 bins: every row (the root build), or a
    mask keeping the share `keep` of the rows (a lossguide child). The bound
    counts the kept rows' bins and stats and the whole mask."""
    bins, stats = _data(N, D, B, seed=7, oob=False)
    bd, sd = bins.to(torch.uint8).to(DEV), stats.to(DEV)
    md, rows, mask_bytes = None, N, 0
    if keep is not None:
        mask = (torch.rand(N, generator=torch.Generator().manual_seed(B + 1)) < keep).float()
        md, rows, mask_bytes = mask.to(DEV), int(mask.sum()), N * 4
    pre = sd if md is None else sd * md[:, None]
    idx = _flat(bd, B)
    src = pre[:, None, :].expand(N, D, 3).reshape(-1).contiguous()
    out = torch.zeros(D * B * 3, device=DEV)
    rec = _timed(lambda: H.plane_hist(bd, sd, md, B),
                 lambda: H.plane_histogram_plain(bd, sd, md, B),
                 lambda: out.zero_().index_add_(0, idx, src),
                 rows * (D + 12) + mask_bytes + D * B * 12, rows * D * 3)
    rec["rows_kept"] = rows
    return rec


def time_multi(S: int, keep: float = 1.0) -> dict:
    """A depthwise level build at 256 bins: each row's slot in [0, S), or,
    with keep < 1, the rest dropped (slot S), as the grower histograms only
    the right children. The bound counts the kept rows and the whole slot
    array."""
    B = 256
    bins, stats = _data(N, D, B, seed=11, oob=False)
    bd, sd = bins.to(torch.uint8).to(DEV), stats.to(DEV)
    g = torch.Generator().manual_seed(S)
    slot = torch.randint(0, S, (N,), generator=g, dtype=torch.int32)
    slot = torch.where(torch.rand(N, generator=g) < keep, slot, S)
    sl = slot.to(DEV)
    rows = int((slot < S).sum())
    idx = _flat(bd, B, torch.where(sl < S, sl, 0).long())
    src = torch.where((sl < S)[:, None], sd, 0.0)[:, None, :].expand(N, D, 3).reshape(-1).contiguous()
    out = torch.zeros(S * D * B * 3, device=DEV)
    rec = _timed(lambda: H.multi_plane_hist(bd, sd, sl, S, B),
                 lambda: H.multi_plane_histogram_plain(bd, sd, sl, S, B),
                 lambda: out.zero_().index_add_(0, idx, src),
                 rows * (D + 12) + N * 4 + S * D * B * 12, rows * D * 3)
    rec["rows_kept"] = rows
    return rec


def _bound(nbytes: int, ops: int) -> dict:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


# -- the slice at full width ---------------------------------------------------


def dataset(n: int, seed: int = SEED):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float64)
    return x, y


def drive(name: str, est, train_df, kernel: str, score, **info) -> "tuple[dict, object]":
    """Fit ``est`` on the card with the launch counts set to 0 just before
    and read just after the fit and its scoring (``score(model)`` -> dict
    of quality numbers); print the phase line; fail if the fit never
    launched ``kernel``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    H.reset_launch_counts()
    t0 = time.perf_counter()
    model = est.fit(train_df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    quality = score(model)
    torch.cuda.synchronize()
    launches = dict(H.launches)
    trees = len(model.booster.trees)
    rec = dict(info, trees=trees, fit_s=fit_s, trees_per_s=trees / fit_s, **quality,
               peak_mem_bytes=torch.cuda.max_memory_allocated(), launches=launches)
    phase(name, **rec)
    if launches[kernel] == 0:
        raise AssertionError(f"{name} {info}: the fit never launched {kernel}")
    return rec, model


def fit_main_path(x, y, x_test, y_test, name="main_path", **params) -> dict:
    est = LightGBMClassifier(num_iterations=20, num_leaves=63, min_data_in_leaf=20,
                             seed=0, device=DEV.type, **params)
    train_df = DataFrame.from_dict({"features": x, "label": y})
    test_df = DataFrame.from_dict({"features": x_test, "label": y_test})

    def score(model) -> dict:
        proba = model.transform(test_df)["probability"]
        if proba.shape != (len(y_test), 2) or not np.all(np.isfinite(proba)):
            raise AssertionError("transform returned malformed probabilities")
        return {"auc": binary_auc(y_test, proba[:, 1])}

    kernel = "multi_plane_hist" if params.get("growth_policy") == "depthwise" else "plane_hist"
    rec, _ = drive(name, est, train_df, kernel, score, **params)
    if rec["auc"] < 0.90:
        raise AssertionError(f"held-out AUC {rec['auc']} < 0.90 for {params}")
    return rec


def card_vs_cpu(x_test, y_test) -> dict:
    x, y = dataset(N_CPU, seed=SEED + 1)
    cfg = TrainConfig(num_iterations=20, num_leaves=63, min_data_in_leaf=20, seed=0)
    p = float(np.clip(y.mean(), 1e-6, 1 - 1e-6))
    base = float(np.log(p / (1 - p)))
    t0 = time.perf_counter()
    gpu = train(x, y, cfg, base_score=base, device=DEV)
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = train(x, y, cfg, base_score=base, device="cpu")
    cpu_s = time.perf_counter() - t0
    same = total = 0
    for a, b in zip(gpu.trees, cpu.trees):
        eq = ((a.leaf == b.leaf) & (a.feature == b.feature)
              & (a.threshold == b.threshold) & (a.active == b.active))
        same += int(eq.sum())
        total += len(eq)
    auc_gpu = binary_auc(y_test, gpu.predict_raw(x_test, device=DEV))
    auc_cpu = binary_auc(y_test, cpu.predict_raw(x_test, device="cpu"))
    rec = {"rows": len(y), "identical_split_share": same / total,
           "auc_card": auc_gpu, "auc_cpu": auc_cpu, "fit_s_card": gpu_s, "fit_s_cpu": cpu_s}
    phase("card_vs_cpu", **rec)
    if abs(auc_gpu - auc_cpu) > 0.002:
        raise AssertionError(f"card AUC {auc_gpu} and CPU AUC {auc_cpu} differ by more than 0.002")
    return rec


# -- the other boosting types and objectives at full width -------------------


def early_stopped() -> dict:
    """250,000 rows, the last 50,000 marked by ``validation_indicator_col``,
    10% of the labels flipped so the model overfits: the fit must stop
    before ``num_iterations`` at the arg-best of its per-round metric."""
    n, n_valid, rounds = 250_000, 50_000, 300
    x, clean = dataset(n, seed=SEED + 2)
    flip = np.random.default_rng(SEED + 2).random(n) < 0.10
    y = np.where(flip, 1.0 - clean, clean)
    valid = np.arange(n) >= n - n_valid
    est = LightGBMClassifier(num_iterations=rounds, learning_rate=0.5, num_leaves=63,
                             min_data_in_leaf=20, early_stopping_round=10, seed=0,
                             validation_indicator_col="is_valid", device=DEV.type)
    df = DataFrame.from_dict({"features": x, "label": y, "is_valid": valid})

    def score(model) -> dict:
        b = model.booster
        proba = model.transform(DataFrame.from_dict({"features": x[valid]}))["probability"]
        # a lossguide tree of 63 leaves launches plane_hist 64 times (root,
        # 62 children, leaf sums); rounds past the stop, up to the end of
        # their 16-round metric chunk, are grown and then dropped
        return {"rounds_run": len(b.trees), "best_iteration": b.best_iteration,
                "rounds_grown": H.launches["plane_hist"] // 64,
                "host_reads": TRAIN.host_reads["count"],
                "binary_logloss": b.evals["binary_logloss"],
                "auc_unflipped_labels": binary_auc(clean[valid], proba[:, 1])}

    rec, _ = drive("early_stopped", est, df, "plane_hist", score, rows=n,
                   validation_rows=n_valid, flipped=0.10, num_iterations=rounds,
                   early_stopping_round=10, learning_rate=0.5)
    hist = rec["binary_logloss"]
    if not rec["rounds_run"] < rounds:
        raise AssertionError(f"early stopping never stopped ({rec['rounds_run']} rounds)")
    if rec["best_iteration"] != 1 + int(np.argmin(hist)) or len(hist) != rec["rounds_run"]:
        raise AssertionError("best_iteration is not the arg-best of the per-round metric")
    return rec


def regression_target(n: int, seed: int):
    """A nonnegative count target: y ~ Poisson(exp(0.5 x0 + 0.3 x1 x2 - 0.2 x3))."""
    x = np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)
    mu = np.exp(0.5 * x[:, 0] + 0.3 * x[:, 1] * x[:, 2] - 0.2 * x[:, 3])
    return x, np.random.default_rng(seed).poisson(mu).astype(np.float64)


def regressor(objective: str, alpha: float = 0.9) -> dict:
    """The held-out loss of the model against that of its own
    boost_from_average constant: pinball (quantile) or Poisson."""
    x_all, y_all = regression_target(N + N_TEST, SEED + 3)
    x, y, x_test, y_test = x_all[:N], y_all[:N], x_all[N:], y_all[N:]
    est = LightGBMRegressor(objective=objective, alpha=alpha, num_iterations=20,
                            num_leaves=63, min_data_in_leaf=20, seed=0, device=DEV.type)

    def loss(pred) -> float:
        if objective == "quantile":
            r = y_test - pred
            return float(np.maximum(alpha * r, (alpha - 1.0) * r).mean())
        return float((pred - y_test * np.log(pred)).mean())   # Poisson, up to a constant

    def score(model) -> dict:
        pred = model.transform(DataFrame.from_dict({"features": x_test}))["prediction"]
        if pred.shape != y_test.shape or not np.all(np.isfinite(pred)):
            raise AssertionError("transform returned malformed predictions")
        base = float(model.booster.base_score)
        const = np.full_like(y_test, np.exp(base) if objective == "poisson" else base)
        return {"held_out_loss": loss(pred), "constant_loss": loss(const)}

    rec, _ = drive("regressor", est, DataFrame.from_dict({"features": x, "label": y}),
                   "plane_hist", score, objective=objective)
    if not rec["held_out_loss"] < rec["constant_loss"]:
        raise AssertionError(f"{objective}: the model does not beat its constant")
    return rec


def ranking_data(queries: int, seed: int, docs: int = 20):
    """Graded relevance 0-4 from a noise-free function of the features."""
    x = np.random.default_rng(seed).normal(size=(queries * docs, D)).astype(np.float32)
    f = x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.3 * x[:, 3]
    rel = np.digitize(f, [0.0, 0.8, 1.5, 2.2]).astype(np.float64)
    return x, rel, np.repeat(np.arange(queries), docs)


def ndcg_at_5(scores: np.ndarray, rel: np.ndarray, groups: np.ndarray) -> float:
    pi, va = objectives.lambdarank_pad_groups(groups)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
            for a in (scores.astype(np.float32), rel.astype(np.float32), pi, va)]
    return float(objectives.grouped_ndcg_device(*args, k=5))


def ranker() -> dict:
    """LightGBMRanker on 10,000 queries x 20 documents (the device-gradient
    path: G * M * M = 4e6 pair entries); held-out NDCG@5 on 2,500 queries
    against random scores."""
    x, rel, q = ranking_data(10_000, SEED + 5)
    x_t, rel_t, q_t = ranking_data(2_500, SEED + 6)
    est = LightGBMRanker(group_col="query", num_iterations=20, num_leaves=63,
                         min_data_in_leaf=20, seed=0, device=DEV.type)
    df = DataFrame.from_dict({"features": x, "label": rel, "query": q})

    def score(model) -> dict:
        pred = model.transform(DataFrame.from_dict({"features": x_t}))["prediction"]
        rand = np.random.default_rng(SEED).normal(size=len(pred))
        return {"ndcg5": ndcg_at_5(pred, rel_t, q_t), "ndcg5_random": ndcg_at_5(rand, rel_t, q_t)}

    rec, _ = drive("ranker", est, df, "plane_hist", score, queries=10_000, docs=20)
    if not rec["ndcg5"] > rec["ndcg5_random"]:
        raise AssertionError("the ranker does not beat random scores")
    return rec


def determinism() -> dict:
    """Same-seed GOSS and bagged fits of 20,000 rows, twice each on the
    card: byte-identical model strings."""
    x, y = dataset(N_CPU, seed=SEED + 7)
    out = {}
    for mode, kw in (("goss", dict(boosting_type="goss")),
                     ("bagging", dict(bagging_fraction=0.8, bagging_freq=1))):
        cfg = TrainConfig(num_iterations=20, num_leaves=63, min_data_in_leaf=20, seed=5, **kw)
        a, b = (train(x, y, cfg, device=DEV).to_model_string() for _ in range(2))
        out[mode] = {"identical": a == b, "model_bytes": len(a)}
    phase("determinism", rows=N_CPU, **out)
    if not all(v["identical"] for v in out.values()):
        raise AssertionError(f"same-seed fits differ: {out}")
    return out


def main() -> None:
    smi = card()
    build()

    errs = {
        "plane64": max(check_plane(64, None), check_plane(64, 0.5)),
        "plane256": max(check_plane(256, None), check_plane(256, 0.5), check_plane(256, 0.03),
                        check_leaf_sums()),
        "multi": max(check_multi(S) for S in (1, 16, 32, 64, 100)),
    }
    check_one_bin()  # |g| ~ 1e6: its absolute error is on another scale
    check_wide_range()

    t_plane256, t_plane64 = time_plane(256), time_plane(64)
    t_multi16 = time_multi(16)
    times = {
        "plane_hist_b256": t_plane256, "plane_hist_b64": t_plane64,
        "plane_hist_b256_keep50": time_plane(256, 0.5),
        "plane_hist_b256_keep3": time_plane(256, 0.03),
        "plane_hist_b64_keep3": time_plane(64, 0.03),
        "multi_plane_hist_s16": t_multi16, "multi_plane_hist_s32": time_multi(32),
        **{f"multi_plane_hist_s{S}_keep50": time_multi(S, 0.5) for S in (1, 4, 16)},
    }
    keep3 = times["plane_hist_b256_keep3"]
    times["keep3_over_full_b256"] = keep3["ms"] / t_plane256["ms"]
    times["keep3_over_full_b256_device"] = keep3["device_ms"] / t_plane256["device_ms"]
    phase("times", **times)

    x_all, y_all = dataset(N + N_TEST)
    x, y, x_test, y_test = x_all[:N], y_all[:N], x_all[N:], y_all[N:]
    runs = {
        "lossguide": fit_main_path(x, y, x_test, y_test, growth_policy="lossguide", max_bin=255),
        "depthwise": fit_main_path(x, y, x_test, y_test, growth_policy="depthwise", max_bin=255),
        "lossguide_b64": fit_main_path(x, y, x_test, y_test, growth_policy="lossguide", max_bin=63),
    }
    card_vs_cpu(x_test, y_test)

    for mode in ("goss", "dart", "rf"):
        fit_main_path(x, y, x_test, y_test, name="boosting", boosting_type=mode,
                      growth_policy="lossguide")
    for policy in ("lossguide", "depthwise"):
        fit_main_path(x, y, x_test, y_test, name="bagging", bagging_fraction=0.8,
                      bagging_freq=1, growth_policy=policy)
    early_stopped()
    regressor("quantile")
    regressor("poisson")
    ranker()
    determinism()

    def entry(name, replaces, launches, err, t):
        return {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": t["ms"],
                "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    kernels = [
        entry("plane_hist (B=256)", f"{TPU}:424 _hist_split_kernel (B2, pallas_call :517)",
              runs["lossguide"]["launches"]["plane_hist"], errs["plane256"], t_plane256),
        entry("plane_hist (B=64)", f"{TPU}:389 _hist_kernel (B1, pallas_call :533)",
              runs["lossguide_b64"]["launches"]["plane_hist"], errs["plane64"], t_plane64),
        entry("multi_plane_hist (S=16)", f"{TPU}:548 _multi_kernel (B3, pallas_call :642)",
              runs["depthwise"]["launches"]["multi_plane_hist"], errs["multi"], t_multi16),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
