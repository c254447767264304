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
and same-seed GOSS and bagged fits repeated byte for byte. Then the
categorical slice at the same width (columns 56-63 integer categories):
categorical lossguide and depthwise fits against the same fits without
categorical columns, their JSON and LightGBM-text round trips scored
bitwise equal on the card, a categorical card-vs-CPU fit, continued
training (``model_string``, ``num_batches``), a checkpointed GOSS and a
bagged fit stopped at round 12 and resumed byte for byte, exact and
approximate SHAP on 2,000 rows, and the card's Threefry draws against the
CPU's bit for bit. Last, image featurization (no kernel of its own: its
convolutions, resize and normalisation are PyTorch ops): a ResNet-50 at
224 on the card in f32 (TF32 off) and bf16 against the port's CPU f32;
the packaged ResNet8_Digits and ResNet18_Patches through ImageFeaturizer
on the card against the CPU (digits accuracy > 0.95); and bench.py's
featurizer cell (2,048 images, ResNet50, batch 256) with its images/s,
device-resident images/s, host-to-device MB/s, peak memory and share of
the card's bf16 peak.

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
import shutil
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
    Booster,
    LightGBMClassifier,
    LightGBMDelegate,
    LightGBMRanker,
    LightGBMRegressor,
    TrainConfig,
    objectives,
    sampling,
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
ROOT = os.path.dirname(os.path.abspath(__file__))
CAT_COLS = tuple(range(56, 64))
CAT_LEVELS = (4, 8, 16, 32, 64, 128, 200, 253)


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
    kernel = "multi_plane_hist" if params.get("growth_policy") == "depthwise" else "plane_hist"
    rec, _ = drive(name, est, train_df, kernel, classifier_score(x_test, y_test), **params)
    if rec["auc"] < 0.90:
        raise AssertionError(f"held-out AUC {rec['auc']} < 0.90 for {params}")
    return rec


def classifier_score(x_test, y_test):
    """``score`` for ``drive``: held-out AUC and logloss of a classifier."""
    test_df = DataFrame.from_dict({"features": x_test})

    def score(model) -> dict:
        proba = model.transform(test_df)["probability"]
        if proba.shape != (len(y_test), 2) or not np.all(np.isfinite(proba)):
            raise AssertionError("transform returned malformed probabilities")
        p = np.clip(proba[:, 1].astype(np.float64), 1e-15, 1 - 1e-15)
        return {"auc": binary_auc(y_test, proba[:, 1]),
                "logloss": float(-np.mean(y_test * np.log(p) + (1 - y_test) * np.log(1 - p)))}

    return score


def card_vs_cpu(x_test, y_test, categorical: bool = False) -> dict:
    """The same 20,000-row fit on the card and on the CPU (plain versions):
    held-out AUCs within 0.002."""
    if categorical:
        x, y = categorical_dataset(N_CPU, seed=SEED + 9)
    else:
        x, y = dataset(N_CPU, seed=SEED + 1)
    cfg = TrainConfig(num_iterations=20, num_leaves=63, min_data_in_leaf=20, seed=0,
                      categorical_features=CAT_COLS if categorical else ())
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
    rec = {"rows": len(y), "categorical": categorical, "identical_split_share": same / total,
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


# -- the categorical slice at full width -------------------------------------


def categorical_dataset(n: int, seed: int = SEED + 8):
    """``dataset``'s features with columns 56-63 replaced by integer
    categories of 4, 8, 16, 32, 64, 128, 200 and 253 levels, and
    y = (x0 + x1 x2 + e[c63] > 0) with e ~ N(0, 1) per level of column 63:
    a per-level effect no threshold on the level's number can express."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    for col, levels in zip(CAT_COLS, CAT_LEVELS):
        x[:, col] = rng.integers(0, levels, n)
    e = rng.normal(size=CAT_LEVELS[-1])
    y = (x[:, 0] + x[:, 1] * x[:, 2] + e[x[:, 63].astype(np.int64)] > 0).astype(np.float64)
    return x, y


def categorical(policy: str, x, y, x_test, y_test) -> "tuple[dict, object]":
    """A categorical fit and the same fit with no categorical column: the
    first must reach AUC >= 0.90, hold categorical splits, beat the second's
    held-out logloss, and score bitwise equal on the card after its JSON
    and LightGBM-text round trips. Both fit without boost_from_average:
    LightGBM's text has no base score and folds it into the first trees'
    leaf values, an f32 addition that rounds, so only a model with no base
    score can come back from the text bit for bit."""
    kernel = "multi_plane_hist" if policy == "depthwise" else "plane_hist"
    df = DataFrame.from_dict({"features": x, "label": y})
    score = classifier_score(x_test, y_test)
    params = dict(num_iterations=20, num_leaves=63, min_data_in_leaf=20, seed=0,
                  growth_policy=policy, boost_from_average=False, device=DEV.type)
    numeric, _ = drive("categorical_baseline", LightGBMClassifier(**params), df, kernel, score,
                       growth_policy=policy, categorical_slot_indexes=[])

    def cat_score(model) -> dict:
        b = model.booster
        rec = score(model)
        rec["categorical_splits"] = int(sum(int(t.is_cat.sum()) for t in b.trees
                                            if t.is_cat is not None))
        rec["splits"] = int(sum(int(t.active.sum()) for t in b.trees))
        return rec

    rec, model = drive("categorical", LightGBMClassifier(
        categorical_slot_indexes=list(CAT_COLS), **params), df, kernel, cat_score,
        growth_policy=policy, categorical_slot_indexes=list(CAT_COLS))
    b = model.booster
    odd = x_test[:12].copy()
    odd[:, 63] = [np.nan, 300, -1, 1e30, -1e30, np.inf, -np.inf, 252.6, 253, 254, 0.4, 2.5]
    rows = np.concatenate([x_test, odd])
    want = b.predict_raw(rows, device=DEV)
    round_trips = {}
    for fmt, back in (("json", Booster.from_model_string(b.to_model_string())),
                      ("lightgbm_text", Booster.from_lightgbm_string(b.to_lightgbm_string()))):
        got = back.predict_raw(rows, device=DEV)
        round_trips[fmt] = bool(np.array_equal(got.view(np.int32), want.view(np.int32)))
    out = dict(rec, numeric_auc=numeric["auc"], numeric_logloss=numeric["logloss"],
               round_trips_bitwise=round_trips)
    phase("categorical_checks", growth_policy=policy, auc=rec["auc"], logloss=rec["logloss"],
          numeric_logloss=numeric["logloss"], categorical_splits=rec["categorical_splits"],
          round_trips_bitwise=round_trips)
    if rec["auc"] < 0.90:
        raise AssertionError(f"categorical {policy}: held-out AUC {rec['auc']} < 0.90")
    if rec["categorical_splits"] < 1:
        raise AssertionError(f"categorical {policy}: no categorical split")
    if not rec["logloss"] < numeric["logloss"]:
        raise AssertionError(f"categorical {policy}: logloss {rec['logloss']} not below "
                             f"the numerical fit's {numeric['logloss']}")
    if not all(round_trips.values()):
        raise AssertionError(f"categorical {policy}: a round trip scores differently: "
                             f"{round_trips}")
    return out, model


def continued(x, y, x_test, y_test) -> dict:
    """10 rounds, then 10 more from its ``model_string``: 20 trees, the
    first 10 unchanged, held-out logloss lower; and ``num_batches=2`` of
    10 rounds each: 20 trees, AUC >= 0.90."""
    df = DataFrame.from_dict({"features": x, "label": y})
    score = classifier_score(x_test, y_test)
    params = dict(num_iterations=10, num_leaves=63, min_data_in_leaf=20, seed=0,
                  device=DEV.type)
    first, m1 = drive("continued", LightGBMClassifier(**params), df, "plane_hist", score,
                      stage="first 10 rounds")
    more, m2 = drive("continued", LightGBMClassifier(
        model_string=m1.get("model_string"), boost_from_average=False, **params), df,
        "plane_hist", score, stage="10 more rounds from model_string")
    batches, m3 = drive("continued", LightGBMClassifier(num_batches=2, **params), df,
                        "plane_hist", score, stage="num_batches=2")
    kept = [t.to_dict() for t in m2.booster.trees[:10]] == [t.to_dict() for t in m1.booster.trees]
    if len(m2.booster.trees) != 20 or not kept:
        raise AssertionError("continued training did not append 10 trees to the first 10")
    if not more["logloss"] < first["logloss"]:
        raise AssertionError("10 more rounds did not lower the held-out logloss")
    if len(m3.booster.trees) != 20 or batches["auc"] < 0.90:
        raise AssertionError(f"num_batches=2: {len(m3.booster.trees)} trees, AUC {batches['auc']}")
    return {"first": first, "more": more, "batches": batches}


class Preempted(Exception):
    """Raised by ``StopAt`` before a round, as a preemption would stop a fit."""


class StopAt(LightGBMDelegate):
    def __init__(self, round_: int):
        self.round = round_

    def before_train_iteration(self, iteration: int) -> None:
        if iteration == self.round:
            raise Preempted(iteration)


def checkpointed(x, y, x_test, y_test) -> dict:
    """A GOSS and a bagged fit checkpoint every 5 rounds; a second run of
    each is stopped before round 12 by a raising delegate and resumed from
    its last checkpoint (round 10): the model string must equal the
    uninterrupted fit's byte for byte."""
    df = DataFrame.from_dict({"features": x, "label": y})
    score = classifier_score(x_test, y_test)
    root = os.path.join(ROOT, "build", "chip_smoke_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    for mode, kw in (("goss", dict(boosting_type="goss")),
                     ("bagging", dict(bagging_fraction=0.8, bagging_freq=1))):
        params = dict(num_iterations=20, num_leaves=63, min_data_in_leaf=20, seed=0,
                      checkpoint_every=5, device=DEV.type, **kw)
        full_dir, cut_dir = os.path.join(root, mode, "full"), os.path.join(root, mode, "cut")
        full, m_full = drive("checkpoint", LightGBMClassifier(checkpoint_dir=full_dir, **params),
                             df, "plane_hist", score, mode=mode, run="uninterrupted")
        t0 = time.perf_counter()
        try:
            LightGBMClassifier(checkpoint_dir=cut_dir, delegate=StopAt(12), **params).fit(df)
        except Preempted:
            cut_s = time.perf_counter() - t0
        else:
            raise AssertionError("the delegate did not stop the fit")
        resumed, m_res = drive("checkpoint", LightGBMClassifier(
            checkpoint_dir=cut_dir, resume_from=cut_dir, **params), df, "plane_hist", score,
            mode=mode, run="resumed from round 10", stopped_run_s=cut_s)
        identical = m_res.get("model_string") == m_full.get("model_string")
        out[mode] = {"identical": identical, "fit_s": full["fit_s"], "resume_fit_s": resumed["fit_s"]}
        if not identical:
            raise AssertionError(f"{mode}: the resumed fit differs from the uninterrupted one")
    shutil.rmtree(root, ignore_errors=True)
    phase("checkpoint_checks", **out)
    return out


def shap(model, x_test) -> dict:
    """Exact TreeSHAP and the approximate (Saabas) walk on 2,000 held-out
    rows of the categorical model: rows sum to ``predict_raw`` within 1e-4."""
    b = model.booster
    rows = x_test[:2000]
    raw = b.predict_raw(rows, device=DEV).astype(np.float64)
    rec = {"rows": len(rows), "trees": len(b.trees)}
    for name, approximate in (("exact", False), ("approximate", True)):
        t0 = time.perf_counter()
        c = b.feature_contribs(rows, approximate=approximate)
        rec[f"{name}_s"] = time.perf_counter() - t0
        rec[f"{name}_max_sum_err"] = float(np.abs(c.sum(axis=1) - raw).max())
        if c.shape != (len(rows), D + 1) or rec[f"{name}_max_sum_err"] > 1e-4:
            raise AssertionError(f"{name} SHAP rows do not sum to the raw score: {rec}")
    phase("shap", **rec)
    return rec


def draws() -> dict:
    """The card's Threefry draws at n = 200,000 equal the CPU's bit for bit;
    one draw's time on the card."""
    cpu = torch.device("cpu")
    cases = ((0, 0, sampling.BAGGING_STREAM), (3, 17, sampling.GOSS_STREAM),
             (-12345, 999, sampling.BAGGING_STREAM))
    for seed, it, stream in cases:
        gpu = sampling.uniform(seed, it, stream, N, DEV)
        ref = sampling.uniform(seed, it, stream, N, cpu)
        if not torch.equal(gpu.cpu().view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"card and CPU Threefry draws differ for {(seed, it, stream)}")
    ms, device_ms = time_ms(lambda: sampling.uniform(0, 1, 1, N, DEV))
    rec = {"n": N, "cases": len(cases), "bitwise_equal": True, "ms": ms, "device_ms": device_ms}
    phase("draws", **rec)
    return rec


# -- image featurization (ResNet through ImageFeaturizer) ------------------------

BF16_PEAK_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
FEAT_F32_REL = 1e-3            # card f32 (TF32 off) vs CPU f32: max |d| <= 1e-3 * max |cpu|
FEAT_BF16_L2 = 3e-2            # card bf16 vs CPU f32 (or bf16): relative L2 per output
FEAT_ROWS, FEAT_BATCH, FEAT_SIZE = 2048, 256, 224   # bench.py's accelerator featurizer cell


def _perturbed(module, seed: int) -> dict:
    """A seeded flax-layout init of ``module`` with every leaf moved by a
    numpy draw: a fresh init zeroes each block's last batch norm, so its
    residual branch would output 0 and hide the convs behind it."""
    from mmlspark_tpu_torch.models import resnet as R

    rng = np.random.default_rng(seed)

    def move(tree, key=None):
        if isinstance(tree, dict):
            return {k: move(x, k) for k, x in tree.items()}
        a = tree + rng.normal(size=tree.shape).astype(np.float32) * 0.1 * (np.abs(tree).mean() + 0.1)
        return np.abs(a) + 0.5 if key == "var" else a

    return move(R.init_flax_variables(module, seed))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def resnet50_card_vs_cpu() -> dict:
    """ResNet-50 at 224, full width, batch 8, perturbed seeded weights: every
    named output of the card in f32 (TF32 off for convolutions and matrix
    products) against the port's CPU f32, and of the card in bf16 against
    the same CPU f32."""
    from mmlspark_tpu_torch.models import resnet as R

    variables = _perturbed(R.resnet50(dtype=torch.float32), seed=5)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(8, 224, 224, 3)).astype(np.float32))
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        cpu = R.load_flax_variables(R.resnet50(dtype=torch.float32), variables).eval()(x)
        rec = {"tf32": False, "batch": 8, "f32_max_rel": {}, "bf16_rel_l2": {}}
        for dtype, key in ((torch.float32, "f32_max_rel"), (torch.bfloat16, "bf16_rel_l2")):
            m = R.load_flax_variables(R.resnet50(dtype=dtype), variables).to(DEV).eval()
            out = m(x.to(DEV))
            for k, want in cpu.items():
                got = out[k].float().cpu().numpy()
                want = want.numpy()
                if got.shape != want.shape or not np.isfinite(got).all():
                    raise AssertionError(f"resnet50 {k}: {got.shape} or non-finite on the card")
                if key == "f32_max_rel":
                    rec[key][k] = float(np.abs(got - want).max() / np.abs(want).max())
                else:
                    rec[key][k] = _rel_l2(got, want)
            del m, out
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    bad = {k: v for k, v in rec["f32_max_rel"].items() if v > FEAT_F32_REL}
    bad.update({k: v for k, v in rec["bf16_rel_l2"].items() if v > FEAT_BF16_L2})
    phase("featurizer", part="resnet50 card vs cpu", f32_tol=FEAT_F32_REL,
          bf16_tol=FEAT_BF16_L2, **rec)
    if bad:
        raise AssertionError(f"ResNet-50 card outputs off the CPU's: {bad}")
    return rec


def _digits():
    raw = np.genfromtxt(os.path.join(ROOT, "tests", "resources", "data", "digits.csv"),
                        delimiter=",", skip_header=1)
    x8, y = raw[:, :64].reshape(-1, 8, 8), raw[:, 64].astype(np.int64)
    img = np.kron(x8 / 16.0, np.ones((4, 4)))
    return (np.repeat(img[..., None], 3, axis=-1).astype(np.float32) * 255).astype(np.uint8), y


def trained_checkpoints(repo: str) -> dict:
    """The packaged ResNet8_Digits and ResNet18_Patches through
    ImageFeaturizer on the card and on the CPU: features agree; digits
    logits classify rows 1500+ at > 0.95 (the JAX package's bar)."""
    from mmlspark_tpu_torch.models import ImageFeaturizer

    imgs, y = _digits()
    patches = np.random.default_rng(7).integers(0, 255, size=(64, 32, 32, 3), dtype=np.uint8)
    rec = {}
    for name, data, cut in (("ResNet8_Digits", imgs, 1), ("ResNet8_Digits", imgs[1500:], 0),
                            ("ResNet18_Patches", patches, 1)):
        out = {}
        for dev in ("cuda", "cpu"):
            f = ImageFeaturizer(input_col="image", output_col="f", model_name=name,
                                cut_output_layers=cut, repo_dir=repo, device=dev)
            out[dev] = f.transform(DataFrame.from_dict({"image": data}))["f"]
        key = f"{name}_{'logits' if cut == 0 else 'pool'}"
        rec[key] = {"rows": len(data), "width": out["cuda"].shape[1],
                    "card_vs_cpu_rel_l2": _rel_l2(out["cuda"], out["cpu"])}
        if cut == 0:
            rec[key]["accuracy_rows_1500_on"] = float((out["cuda"].argmax(-1) == y[1500:]).mean())
    phase("featurizer", part="trained checkpoints", tol=FEAT_BF16_L2, **rec)
    for key, r in rec.items():
        if r["card_vs_cpu_rel_l2"] > FEAT_BF16_L2:
            raise AssertionError(f"{key}: card features off the CPU's: {r}")
    if rec["ResNet8_Digits_logits"]["accuracy_rows_1500_on"] <= 0.95:
        raise AssertionError(f"ResNet8_Digits accuracy {rec['ResNet8_Digits_logits']}")
    return rec


def _conv_flops(net, x) -> int:
    """Multiply-adds x 2 of every conv and dense layer one call of ``net`` on
    ``x`` runs, from the layers' own shapes (forward hooks)."""
    from mmlspark_tpu_torch.models import resnet as R

    total = [0]

    def conv_hook(mod, inp, out):
        total[0] += 2 * out.numel() * mod.weight.shape[1] * mod.k * mod.k

    hooks = [m.register_forward_hook(conv_hook) for m in net.modules() if isinstance(m, R.Conv)]
    with torch.inference_mode():
        out = net(x)
    for h in hooks:
        h.remove()
    if net.node == "logits":  # the head ran
        total[0] += 2 * x.shape[0] * net.backbone.head.weight.numel()
    return total[0]


def bench_cell(repo: str, smi: str) -> dict:
    """bench.py's featurizer cell (:115-178) on the card: 2,048 uint8
    224x224x3 rows, ResNet50, batch 256, cut_output_layers=1."""
    from mmlspark_tpu_torch.models import ImageFeaturizer

    t0 = time.perf_counter()
    imgs = np.random.default_rng(0).integers(0, 255, size=(FEAT_ROWS, FEAT_SIZE, FEAT_SIZE, 3),
                                             dtype=np.uint8)
    df = DataFrame.from_dict({"image": imgs})
    feat = ImageFeaturizer(input_col="image", output_col="features", batch_size=FEAT_BATCH,
                           model_name="ResNet50", cut_output_layers=1, image_size=FEAT_SIZE,
                           repo_dir=repo)
    feat.transform(DataFrame.from_dict({"image": imgs[:FEAT_BATCH]}))
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = feat.transform(df)["features"]
        runs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if out.shape != (FEAT_ROWS, 2048) or not np.isfinite(out).all():
        raise AssertionError(f"bench cell features malformed: {out.shape}")

    net = feat._build()._runner(DEV)
    staged = torch.from_numpy(imgs[:FEAT_BATCH]).to(DEV)
    flops = _conv_flops(net, staged)
    reps = 40
    with torch.inference_mode():
        net(staged)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            net(staged)
        torch.cuda.synchronize()
        resident_s = time.perf_counter() - t0
    copy = torch.from_numpy(imgs[: 2 * FEAT_BATCH])
    pinned = copy.pin_memory()
    uplink = {}
    for kind, src in (("pinned", pinned), ("pageable", copy)):
        src.to(DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        src.to(DEV, non_blocking=kind == "pinned")
        torch.cuda.synchronize()
        uplink[f"h2d_mb_s_{kind}"] = copy.numel() / 1e6 / (time.perf_counter() - t0)
    tflops = flops * reps / resident_s / 1e12
    rec = {
        "rows": FEAT_ROWS, "batch": FEAT_BATCH, "model": "ResNet50", "output": "pool",
        "setup_s": setup_s, "transform_s": runs,
        "images_per_s": FEAT_ROWS / min(runs),
        "device_resident_images_per_s": reps * FEAT_BATCH / resident_s,
        **uplink, "h2d_copy_mb": copy.numel() / 1e6,
        "peak_device_mb": peak / 2**20,
        "flops_per_image": flops / FEAT_BATCH, "bf16_tflop_s": tflops,
        "share_of_bf16_peak": tflops * 1e12 / BF16_PEAK_FLOPS,
        "card": smi,
    }
    phase("featurizer", part="bench cell", **rec)
    return rec


def featurizer(smi: str) -> dict:
    """The image featurization path: card vs CPU at full width, the trained
    checkpoints, the bench cell. The zoo lives under build/ and is removed
    after."""
    repo = os.path.join(ROOT, "build", "chip_smoke_zoo")
    shutil.rmtree(repo, ignore_errors=True)
    t0 = time.perf_counter()
    rec = {"card_vs_cpu": resnet50_card_vs_cpu(), "checkpoints": trained_checkpoints(repo),
           "bench": bench_cell(repo, smi)}
    shutil.rmtree(repo, ignore_errors=True)
    phase("featurizer", part="total", seconds=time.perf_counter() - t0)
    return rec


def main() -> None:
    t_start = time.perf_counter()
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

    xc_all, yc_all = categorical_dataset(N + N_TEST)
    xc, yc, xc_test, yc_test = xc_all[:N], yc_all[:N], xc_all[N:], yc_all[N:]
    _, cat_model = categorical("lossguide", xc, yc, xc_test, yc_test)
    categorical("depthwise", xc, yc, xc_test, yc_test)
    card_vs_cpu(xc_test, yc_test, categorical=True)
    continued(x, y, x_test, y_test)
    checkpointed(x, y, x_test, y_test)
    shap(cat_model, xc_test)
    draws()
    featurizer(smi)

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
    phase("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
