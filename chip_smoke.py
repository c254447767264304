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
The three main-path fits run under torch.profiler: the wrappers count
the launches they make (the eager rounds'), the trace counts the
histogram kernel on the device, a CUDA graph's replays included. Every
fit that runs as fused chunks (the default: one round captured as a CUDA
graph and replayed) is fitted again with the same round run eagerly
(``fused_rounds=1``), and the two model strings must be byte-identical. Before the main path,
phase ``binning`` holds device binning against the CPU's bit for bit
(f32/f64, NaN/+-inf columns, max_bin 2/63/255, CSR) and fits a CSR bag of
words; after it, phase ``gate`` runs bench.py's sklearn cell through the
port (100,000 x 32, 50 rounds; ``train`` seconds and held-out AUC, with
and without the graph; the sklearn side needs scikit-learn, which the
card machine lacks), phase ``fused`` bench.py's trees/s cell (200,000 x
64, 20 rounds, both policies, with and without the graph, launches per
tree), and phase ``partitioned`` the data-partitioned grower beside the
masked one.
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
approximate SHAP on 250 rows, and the card's Threefry draws against the
CPU's bit for bit. Last, image featurization (no kernel of its own: its
convolutions, resize and normalisation are PyTorch ops): a ResNet-50 at
224 on the card in f32 (TF32 off) and bf16 against the port's CPU f32;
the packaged ResNet8_Digits and ResNet18_Patches through ImageFeaturizer
on the card against the CPU (digits accuracy > 0.95); and bench.py's
featurizer cell (2,048 images, ResNet50, batch 256; flax's seeded init,
drawn on the card and held within 4 ulp of the CPU's) with its images/s,
device-resident images/s, host-to-device MB/s, peak memory and share of
the card's bf16 peak. Then phase ``pipeline`` (the pipeline compiler:
P1-P3), and last phase ``vw``, text learning: VowpalWabbit's SGD kernels
(``vw_pass``, one launch a pass, with its grad and apply phases alone as
``vw_grad`` and ``vw_apply``; ``vw_margin``) against the plain version on
the CPU bit for bit (squared, quantile and hinge losses at the main path's
shapes, batch 64 to 4,096, K 1 to 64 and runs a warp applies; logistic and
poisson, and the plain version's atomics on the card, within a tolerance;
chunked calls equal one call), bench.py's vw cell as written (V1: 100,000
rows, rows/s and resident rows/s at batch 1,024 and 64, the latter also
from the passes' device time), the same texts
split into tokens with learnable labels (V2: a UnicodeNormalize ->
ValueIndexer -> VowpalWabbitFeaturizer -> VowpalWabbitClassifier ->
IndexToValue pipeline on the card and on the CPU, held-out AUC; a
squared-loss regressor whose card weights equal the CPU's bit for bit; a
contextual bandit against the uniform policy; the native murmur3 library
must load), each kernel's time (eager and in a CUDA graph, the library
calls alike) beside its byte bound and chain floor, ``vw_margin`` also at
newsgroup-length rows (20,000 x 481) and a million rows x 41, bitwise the
CPU there too, and where a fit's time goes (launches a pass, the pass's
device ms). Then phase ``serving``: one ``WorkerServer`` +
``ModelDispatcher`` over a ``ModelStore`` on the card holding ``echo``, the
trees/s cell's lossguide booster (``gbdt:``), V2's classifier (``vw:``,
scored by ``vw_margin``), P1 compiled (``pipeline:``, its buckets' graphs
captured in warm-up) and ``zoo:ResNet50``: each load's resident bytes
against the rise of card memory, 300 sequential loopback POSTs a model
(50 warm-up) whose replies must all be 200 and bitwise the model called
in-process on the card (VW's also the CPU plain version's), p50 and p99,
where a ResNet-50 request's time goes, P1 hot-swapped to a second version
under load (zero 5xx, zero drops, every reply one version's answer), each
unload's memory back, and a budget of one ResNet-50 refusing a second.
Last, phase ``distributed``: the histograms'
distributed form (the fixed-scale kernel entries plus int64 all-reduces)
at world 1 under NCCL in this process and at world 2 as two spawned gloo
processes on this card, bitwise one ``plane_hist`` / ``multi_plane_hist``
call on all 200,000 rows, with each rank's kernel, all-reduce and build
times; the trees/s cell at world 2 (10 rounds; data_parallel lossguide and
depthwise, voting_parallel with K = 4) within 0.005 AUC of one-device
fits of the same depth, both ranks' models byte-identical, voting's bytes a split under a
third of data_parallel's; an integer-column fit whose world-2 model
string must equal the one-device one; then, on the same integer columns,
every fit that needs all the ranks' rows beyond the histograms
(``DIST_FITS``: GOSS, dart, early stopping, quantile and mape, lambdarank
with and without early stopping, continued training, CSR input,
``fused_rounds=4``), each traced, byte-identical on both ranks and equal
to the same fit on one device byte for byte, best iteration included
(CSR, whose one-device mapper fits the stored values alone: equal, or
within 0.005 AUC with the reason recorded), each launching
``plane_hist_fixed``; VW's V2 at world 2 within 1e-3 AUC of one device.
Last, phase ``elastic``: the elastic gang through its entry points, a
registry (``fleet.run_registry``) in this process and ``python -m
mmlspark_tpu_torch.serving.fleet train --device cuda`` members on this card,
on the trees/s cell's rows (an ``npz:`` file), 63 leaves, 8 rounds,
checkpoints every 2: world-2 gangs (lossguide over the ring reducer and
over the mesh, depthwise over the ring), whose members' models must be
byte-identical and equal to the same fit on one device here (their int64
histogram cells are summed exactly over TCP), each member having launched
``plane_hist_fixed`` / ``multi_plane_hist_fixed`` (its status file's
counts), the ring's payload bytes under the mesh's; then the host-loss
drill: member b stalls entering round 4 and is SIGKILLed, a detects the
loss, reshards to world 1 from a snapshot of the round-4 checkpoint and
finishes, and its booster must equal a fresh world-1 run from that
snapshot and the one-device fit. The phase goes on with the gang's
no-shared-disk modes: a world-2 voting gang (``--tree-parallelism voting
--top-k 4``: members byte-equal, payload a member under half the full
lossguide ring gang's, held-out AUC within 0.02 of it, vote rounds and
``plane_hist_fixed`` launches a member); ``stream-synth:200000x64:3:65536``
at worlds 2 and 1 and ``stream-csv:`` of the same rows written to a CSV,
each booster byte-equal to ``train`` on one device on the world-1
BinnedDataset and the CSV's bins equal to the synth ones (ingest seconds,
ingest bytes and peak host RSS a member); the artifact drill (per-host
``--ckpt-dir`` and ``--artifact-dir``, b SIGKILLed at round 4, a fresh
world-1 member resuming from ``--resume-from artifact:<name>@<digest>@<url>``
with at least one artifact fetch, both boosters byte-equal and equal to
the one-device fit; fetch bytes and MB/s on loopback); and
``artifact:gbdt:`` / ``artifact:vw:`` specs in a ModelStore on the card,
each scoring bitwise as its direct spec. Last, phase ``fleet``: a
registry, two ``fleet worker --device cuda`` processes sharing this one card
under the supervisor of ``fleet supervise`` (each serving the trees/s
booster as ``gbdt:``, V2's classifier as ``vw:`` and ``echo``), and ``fleet
gateway`` processes in front: 8 keep-alive clients send 1,000 requests a
run routed by ``x-mmlspark-model``, every reply 200 and bitwise the
in-process call, p50/p99 a model direct to a worker and through the
gateway; ``vw_margin`` counted in one more worker run in this process on the
same traffic (the kernels line's ``fleet_launches``); a worker SIGKILLed
mid-load (no request lost, respawned with a new boot stamp and routed to
again, the seconds from the kill); ``rolling_restart`` under load (every
reply 200); a gateway with ``--hedge-ms`` (replies bitwise); one request's
trace across the gateway->worker hop; ``fleet top``'s columns; the SLO
gauges on both roles. Last, phases ``online``, ``tune`` and ``chaos`` on the
same registry and supervised workers, with one more worker in this process
and ``fleet online``'s loop in this process. Phase
``online``: V2's 80,000 training rows POSTed to ``/ingest`` in ordered chunks
of 1,024 (logistic, lr 0.5, batch 64, 2^18 weights; ``vw_pass`` counted here)
while 4 keep-alive clients score ``vw-online`` (``vw_margin`` counted in this
process's worker); the last snapshot bitwise one card ``train_sparse_sgd``
over the rows in ingest order (and within 1e-5 * max|w| of the CPU plain
version's), every reply after it bitwise the in-process scoring, 0 non-2xx,
publications and freshness p50/p99; then an artifact-mode loop
(``--replicas 1``), bitwise. Phase ``tune``: ``fleet tune`` over 4 ``fleet
trial --device cuda`` processes on the trees/s cell's rows (63 leaves, rungs
at 2, 4, 8 rounds, eta 2): promotion sets equal ``asha.promote`` of the
reports, the winner refitted fresh here has the committed digest and is
served as ``champion`` bitwise by every worker, the trials' histogram
launches from their status files. Phase ``chaos``: ``fleet chaos`` twice
with one seed on that fleet under load (latency with jitter on worker 0's
proxied link, worker 0 SIGSTOPped and SIGCONTed): every invariant green,
``online_conservation`` and ``experiment_conservation`` included, every
reply 200, the same schedule digest both times. For time, depth is cut in
``card_vs_cpu`` (5 rounds), the world-2 fits (10; ``DIST_FITS`` 5, its
early-stopping fits 10), the gangs (8) and the fleet's load runs (1,000
requests), and phase ``elastic`` runs its gangs side by side in two waves.

Each phase prints its own line. The line before the last is the card's
name and power limit, the one before it the kernels' JSON record, and the
last line is ``{"ok": true, "device": {...}}``. Any failure is a nonzero
exit with the traceback: no phase is caught, and nothing falls back to the
CPU. Without a CUDA device the script exits nonzero before any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import hashlib
import importlib
import json
import os
import re
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


T_START = time.perf_counter()


def phase(name: str, **kv) -> None:
    """A phase's JSON line on stdout, and on stderr where the run has got to."""
    t = time.perf_counter() - T_START
    print(json.dumps({"phase": name, "t": t, **kv}), flush=True)
    part = f" {kv['part']}" if isinstance(kv.get("part"), str) else ""
    print(f"chip_smoke: {name}{part} done at {t:.1f} s", file=sys.stderr, flush=True)


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
    column, as the grower's row_weight puts them there. The plain version
    sums in f64 here: in f32 its own rounding on that cell of 200,000 rows
    (about 1 in h and in the weights, in the order the card's atomics take)
    is of the size of TOL * sum |stats_j|, so it, not the kernel, would
    decide the check."""
    g = torch.Generator().manual_seed(77)
    bins = torch.randint(0, B, (N, D), generator=g, dtype=torch.int32)
    bins[:, 3] = 5
    w = torch.rand(N, generator=g) * 2
    stats = torch.stack([torch.randn(N, generator=g) * 1e6 * w,
                         torch.rand(N, generator=g) * w, w], 1).float()
    bd, sd = bins.to(torch.uint8).to(DEV), stats.to(DEV)
    name = "plane_hist one-bin feature"
    a = _twice(name, lambda: H.plane_hist(bd, sd, None, B))
    err = _compare(name, a, H.plane_histogram_plain(bd, sd.double(), None, B),
                   _f64_plane(bins, stats, B), stats, H.plane_histogram_emulated(bd, sd, None, B),
                   integer_counts=False)
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


def _timed(kernel, plain, library, nbytes: int, ops: int, iters: int = 20) -> dict:
    """ms and device_ms of the kernel, its plain version and one library
    call (None where no PyTorch call computes the same function)."""
    rec = {"bytes": nbytes, "ops": ops}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        rec[f"{key}ms"], rec[f"{key}device_ms"] = (None, None) if fn is None else time_ms(fn, iters)
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


_HIST_KERNEL = re.compile(r"hist_kernel<[^,>]+, (true|false)>")


def traced_launches(prof) -> dict:
    """The device's ``hist_kernel`` events in a torch.profiler trace, by
    wrapper: the kernel's ``kMulti`` template argument tells
    ``multi_plane_hist`` (true) from ``plane_hist`` (false); the fixed-scale
    entries (``*_fixed``) launch the same kernel. A CUDA graph's replays
    show here one event per captured launch. The trace's raw events are
    read where this torch has them (building ``prof.events()`` costs
    seconds a fit)."""
    out = {"plane_hist": 0, "multi_plane_hist": 0}
    cuda = torch.autograd.DeviceType.CUDA
    try:
        events = [(e.name(), e.device_type()) for e in prof.profiler.kineto_results.events()]
    except AttributeError:
        events = [(e.name, e.device_type) for e in prof.events()]
    for name, dev in events:
        if dev == cuda:
            m = _HIST_KERNEL.search(name)
            if m:
                out["multi_plane_hist" if m.group(1) == "true" else "plane_hist"] += 1
    return out


def drive(name: str, est, train_df, kernel: str, score, eager_check: bool = True,
          trace: bool = False, **info) -> "tuple[dict, object]":
    """Fit ``est`` on the card with the launch counts set to 0 just before
    and read just after the fit and its scoring (``score(model)`` -> dict
    of quality numbers); print the phase line; fail if the fit never
    launched ``kernel``. The wrappers count the launches they make
    themselves (the eager rounds'); with ``trace`` the fit also runs under
    torch.profiler and ``traced_launches`` counts the kernel on the device,
    a CUDA graph's replays included (``fit_s`` then carries the tracing's
    cost). A fit that ran as fused chunks (one round captured as a CUDA
    graph and replayed) is fitted again without the graph
    (``fused_rounds=1``) unless ``eager_check`` is off: the model strings
    must be byte-identical, and both fits' trees/s are printed."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    H.reset_launch_counts()
    with (profile(activities=[ProfilerActivity.CUDA]) if trace
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        model = est.fit(train_df)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        graph = dict(TRAIN.fused)
        quality = score(model)
        torch.cuda.synchronize()
    launches = dict(H.launches)
    trees = len(model.booster.trees)
    rec = dict(info, trees=trees, fit_s=fit_s, trees_per_s=trees / fit_s, **quality,
               peak_mem_bytes=torch.cuda.max_memory_allocated(), launches=launches,
               graph=graph)
    if trace:
        rec["traced"] = True
        rec["traced_launches"] = traced_launches(prof)
    if graph["chunks"] and eager_check:
        fused = est.get("fused_rounds")
        est.set(fused_rounds=1)
        t0 = time.perf_counter()
        eager = est.fit(train_df)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        est.set(fused_rounds=fused)
        rec.update(eager_fit_s=eager_s, eager_trees_per_s=trees / eager_s,
                   graph_equals_eager=eager.get("model_string") == model.get("model_string"))
    phase(name, **rec)
    if launches[kernel] == 0:
        raise AssertionError(f"{name} {info}: the fit never launched {kernel}")
    if trace and rec["traced_launches"][kernel] < launches[kernel]:
        raise AssertionError(f"{name} {info}: the trace saw fewer {kernel} launches than "
                             "the wrappers counted")
    if not rec.get("graph_equals_eager", True):
        raise AssertionError(f"{name} {info}: the graph-replayed fit differs from the eager one")
    return rec, model


def fit_main_path(x, y, x_test, y_test, name="main_path", **params) -> dict:
    est = LightGBMClassifier(num_iterations=20, num_leaves=63, min_data_in_leaf=20,
                             seed=0, device=DEV.type, **params)
    train_df = DataFrame.from_dict({"features": x, "label": y})
    kernel = "multi_plane_hist" if params.get("growth_policy") == "depthwise" else "plane_hist"
    rec, model = drive(name, est, train_df, kernel, classifier_score(x_test, y_test),
                       trace=name == "main_path", **params)
    if rec["auc"] < 0.90:
        raise AssertionError(f"held-out AUC {rec['auc']} < 0.90 for {params}")
    return {**rec, "model_string": model.get("model_string")}


def gate_data():
    """bench.py ``_seg_sklearn``'s accelerator cell: x ~ N(0,1) of 125,000
    x 32 from ``default_rng(7)``, y = sin(2 x0) + x1 x2 > 0; the first
    100,000 rows train, the last 25,000 are held out."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(125_000, 32)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2] > 0).astype(np.float64)
    return x[:100_000], y[:100_000], x[100_000:], y[100_000:]


def timed_train(x, y, cfg, reps: int = 3, warm: bool = True, **kw) -> "tuple[float, object]":
    """Best-of-``reps`` wall seconds of ``train`` on the card (each ending
    in a synchronise), after one warm-up fit unless ``warm`` is off, and
    the last fit's booster."""
    if warm:
        train(x, y, cfg, device=DEV.type, **kw)
    best, booster = float("inf"), None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster = train(x, y, cfg, device=DEV.type, **kw)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, booster


_HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")


PROFILED_ROUNDS = 5   # traced fits are cut to 5 rounds: tracing costs ~3 s a round


def launches_per_tree(x, y, cfg, **kw) -> dict:
    """One traced ``train`` of ``PROFILED_ROUNDS`` rounds: the device's
    kernels (and memsets and copies) per tree, and the host's launch calls
    per tree (kernel and graph launches; a fused fit pays for its eager
    warm-up round and its capture once, then one graph launch a round, so
    over 20 or 50 rounds its share per tree is lower than here:
    tools/gbdt_torch_profile.py traces whole fits)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(cfg, num_iterations=PROFILED_ROUNDS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        booster = train(x, y, cfg, device=DEV.type, **kw)
        torch.cuda.synchronize()
    events = prof.events()
    trees = len(booster.trees)
    device_ops = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in events)
    host = [e.name for e in events if e.name in _HOST_LAUNCHES]
    return {"rounds": trees, "device_ops_per_tree": device_ops / trees,
            "host_launch_calls_per_tree": len(host) / trees,
            "graph_launches": host.count("cudaGraphLaunch")}


def graph_and_eager(name: str, x, y, cfg, reps: int, eager_reps: int, profile: bool,
                    **kw) -> dict:
    """``train`` with the graph (``fused_rounds=0``) and with the same
    round run eagerly (``fused_rounds=1``): best wall seconds, trees/s,
    byte-identical model strings; with ``profile`` launches per tree."""
    g_s, g_b = timed_train(x, y, cfg, reps=reps, **kw)
    replays = dict(TRAIN.fused)
    e_s, e_b = timed_train(x, y, cfg, reps=eager_reps, warm=False, fused_rounds=1, **kw)
    trees = len(g_b.trees)
    rec = {"train_s": g_s, "trees_per_s": trees / g_s, "eager_train_s": e_s,
           "eager_trees_per_s": trees / e_s, "trees": trees, "graph": replays,
           "graph_equals_eager": g_b.to_model_string() == e_b.to_model_string()}
    if profile:
        rec["launches"] = launches_per_tree(x, y, cfg, **kw)
        rec["eager_launches"] = launches_per_tree(x, y, cfg, fused_rounds=1, **kw)
    if not rec["graph_equals_eager"]:
        raise AssertionError(f"{name}: the graph-replayed fit differs from the eager one")
    return rec, g_b


def gate(reps: int = 3) -> dict:
    """The port's side of the round's gate (bench.py ``_seg_sklearn``): 50
    rounds, 63 leaves, ``min_data_in_leaf=20``, seed 7; lossguide,
    depthwise and lossguide at ``max_bin=63``; ``train`` seconds (best of
    ``reps`` after a warm-up) and held-out AUC, with the graph and through
    the round run eagerly (best of 1 after a warm-up), launches per tree of
    the lossguide fit. The sklearn side is not measured here: the card
    machine has no scikit-learn."""
    x, y, x_te, y_te = gate_data()
    out = {}
    for name, extra in (("lossguide", {}), ("depthwise", {"growth_policy": "depthwise"}),
                        ("lossguide_b63", {"max_bin": 63})):
        cfg = TrainConfig(objective="binary", num_iterations=50, num_leaves=63,
                          min_data_in_leaf=20, seed=7, **extra)
        rec, booster = graph_and_eager(f"gate {name}", x, y, cfg, reps=reps, eager_reps=1,
                                       profile=name == "lossguide")
        raw = booster.predict_raw(x_te, device=DEV.type).astype(np.float64)
        rec["auc"] = binary_auc(y_te, 1.0 / (1.0 + np.exp(-raw)))
        out[name] = rec
        if rec["auc"] < 0.90:
            raise AssertionError(f"gate {name}: held-out AUC {rec['auc']} < 0.90")
    phase("gate", reps=reps, sklearn="not measured: no scikit-learn on the card machine",
          **out)
    return out


def fused(x, y) -> dict:
    """bench.py ``_seg_gbdt``'s trees/s cell (200,000 x 64, 20 rounds, 63
    leaves), both growth policies, with the graph (best of 2) and through
    the round run eagerly (best of 2), launches per tree of each."""
    out = {}
    for policy in ("lossguide", "depthwise"):
        cfg = TrainConfig(num_iterations=20, num_leaves=63, min_data_in_leaf=20, seed=0,
                          growth_policy=policy)
        out[policy], _ = graph_and_eager(f"fused {policy}", x, y, cfg, reps=2, eager_reps=2,
                                         profile=True)
    phase("fused", rows=len(y), rounds=20, **out)
    return out


def threshold_ties(bins, weight, a, b) -> list:
    """The splits at which two grown trees with the same split leaves and
    features chose different thresholds, each with the weighted rows of
    its leaf in the bins between the two thresholds: 0 means both
    thresholds part the weighted rows alike, so the two gains tie in exact
    arithmetic. Replays ``a``'s records on the training rows (numerical
    splits)."""
    bins, w = bins.cpu().numpy(), weight.cpu().numpy() > 0
    rl, rf, ra = (t.cpu().numpy() for t in (a.rec_leaf, a.rec_feature, a.rec_active))
    ab, bb = a.rec_bin.cpu().numpy(), b.rec_bin.cpu().numpy()
    leaf = np.zeros(len(bins), np.int64)
    out = []
    for k in np.flatnonzero(ra):
        col, in_leaf = bins[:, rf[k]], leaf == rl[k]
        if ab[k] != bb[k]:
            lo, hi = sorted((int(ab[k]), int(bb[k])))
            out.append({"split": int(k), "feature": int(rf[k]), "bins": [lo, hi],
                        "weighted_rows_between": int(
                            (in_leaf & w & (col > lo) & (col <= hi)).sum())})
        leaf[in_leaf & (col > ab[k])] = k + 1
    return out


def subtraction_residue(bins, g, h, w, at: int = 100, pairs: "int | None" = None) -> dict:
    """The cause of those ties, on two levels of splits: the root on
    column f at bin ``at`` (right child B), its left child A on column
    f+1 at ``at`` (children A1 <= and A2 >). Derived by subtraction, A1 =
    (parent - B) - A2 carries the f32 rounding of each plane it came from,
    so in the bins of column f+1 above ``at``, where A1 holds no weighted
    row (its own plane is exactly 0 there), its G and H need not be 0. The
    masked grower always derives the left child and the partitioned one
    the larger, so their residues sit in different planes, and a tie
    across such bins breaks either way."""
    stats = torch.stack([g * w, h * w, w], -1)
    parent = H.plane_hist(bins, stats, None, 256)
    d = bins.shape[1]
    out = {"pairs": 0, "cells_without_weight": 0, "nonzero_residues": 0,
           "max_abs_residue": 0.0, "direct_plane_nonzero": 0}
    for f in range(d if pairs is None else pairs):
        left = bins[:, f] <= at
        a2 = left & (bins[:, (f + 1) % d] > at)
        b = H.plane_hist(bins, stats, (~left).float(), 256)
        p_a2 = H.plane_hist(bins, stats, a2.float(), 256)
        a1 = H.plane_hist(bins, stats, (left & ~a2).float(), 256)
        empty = (a1[:, 2] == 0) & (p_a2[:, 2] > 0)
        res = ((parent - b) - p_a2)[empty][:, :2]
        out["pairs"] += 1
        out["cells_without_weight"] += int(res.numel())
        out["nonzero_residues"] += int((res != 0).sum())
        out["direct_plane_nonzero"] += int((a1[empty][:, :2] != 0).sum())
        if res.numel():
            out["max_abs_residue"] = max(out["max_abs_residue"], float(res.abs().max()))
    return out


def partitioned(x, y, x_test, y_test, masked: dict, seeds=(0, 1, 2)) -> dict:
    """The data-partitioned grower (``MMLSPARK_TPU_GBDT_PARTITION=1``) on
    the trees/s cell, with the graph and eager, beside the masked grower's
    (phase ``fused``); its model against the masked one's (split leaves,
    features and thresholds per tree, held-out predictions); one tree of
    each grower on the same gradients, for each of ``seeds`` (200,000 x 64,
    10% of the rows at weight 0). The records are not all equal on the
    card: a threshold may differ where the gains tie in exact arithmetic.
    So the check is: split leaves, features, leaf counts and the weighted
    rows' leaves equal; every differing threshold a tie (no weighted row
    of the leaf between the two, see ``threshold_ties``); leaf values
    within 1e-5 and gains within rtol 1e-3. ``subtraction_residue`` shows
    where the ties break."""
    from mmlspark_tpu_torch.models.gbdt import treegrow

    cfg = TrainConfig(num_iterations=20, num_leaves=63, min_data_in_leaf=20, seed=0)
    os.environ["MMLSPARK_TPU_GBDT_PARTITION"] = "1"
    try:
        rec, b_part = graph_and_eager("partitioned", x, y, cfg, reps=2, eager_reps=1,
                                      profile=False)
    finally:
        del os.environ["MMLSPARK_TPU_GBDT_PARTITION"]
    b_mask = train(x, y, cfg, device=DEV.type)
    raw_p = b_part.predict_raw(x_test, device=DEV.type)
    raw_m = b_mask.predict_raw(x_test, device=DEV.type)
    same = [bool(np.array_equal(a.feature, b.feature) and np.array_equal(a.leaf, b.leaf))
            for a, b in zip(b_part.trees, b_mask.trees)]
    thr = [int((a.threshold != b.threshold).sum()) for a, b in zip(b_part.trees, b_mask.trees)]
    rec.update(auc=binary_auc(y_test, raw_p), masked_auc=binary_auc(y_test, raw_m),
               trees_with_identical_splits=sum(same),
               thresholds_differing=sum(thr), trees_with_identical_thresholds=thr.count(0),
               test_pred_max_abs_diff=float(np.abs(raw_p - raw_m).max()),
               masked_trees_per_s=masked["lossguide"]["trees_per_s"],
               masked_eager_trees_per_s=masked["lossguide"]["eager_trees_per_s"])
    sp = treegrow.SplitParams.make(DEV, lambda_l2=1.0, lambda_l1=0.0, min_sum_hessian=1e-3,
                                   min_gain=0.0, learning_rate=0.1)
    kw = dict(num_leaves=63, sp=sp, feature_mask=torch.ones(D, device=DEV),
              min_data_in_leaf=20, num_bins=256)
    growers, ok = {}, True
    for seed in seeds:
        rng = np.random.default_rng(SEED + seed)
        xb = torch.from_numpy(rng.integers(0, 200, size=(N, D)).astype(np.uint8)).to(DEV)
        g = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(DEV)
        h = torch.from_numpy((np.abs(rng.normal(size=N)) + 0.1).astype(np.float32)).to(DEV)
        w = torch.from_numpy((rng.random(N) > 0.1).astype(np.float32)).to(DEV)
        a = treegrow.grow_tree(xb, g, h, w, **kw)
        b = treegrow.grow_tree_partitioned(xb, g, h, w, **kw)
        weighted = w > 0
        ties = threshold_ties(xb, w, a, b)
        moved = a.row_leaf != b.row_leaf
        r = {
            "splits": int(a.rec_active.sum()),
            "rec_leaf_feature_active_equal": bool(
                torch.equal(a.rec_leaf, b.rec_leaf) and torch.equal(a.rec_feature, b.rec_feature)
                and torch.equal(a.rec_active, b.rec_active)),
            "thresholds_differing": len(ties),
            "thresholds_differing_not_tied": sum(t["weighted_rows_between"] > 0 for t in ties),
            "differing": ties[:8],
            "weighted_row_leaf_equal": bool(torch.equal(a.row_leaf[weighted],
                                                        b.row_leaf[weighted])),
            "rows_in_other_leaves": int(moved.sum()),
            "leaf_counts_equal": bool(torch.equal(a.leaf_counts, b.leaf_counts)),
            "leaf_values_max_abs": float((a.leaf_values - b.leaf_values).abs().max()),
            "gain_max_rel": float(((a.rec_gain - b.rec_gain).abs()
                                   / a.rec_gain.abs().clamp_min(1e-4)).max()),
        }
        if seed == seeds[0]:
            r["subtraction_residue"] = subtraction_residue(xb, g, h, w)
        growers[f"seed {seed}"] = r
        ok = ok and (r["rec_leaf_feature_active_equal"] and r["weighted_row_leaf_equal"]
                     and r["thresholds_differing_not_tied"] == 0 and r["leaf_counts_equal"]
                     and r["leaf_values_max_abs"] <= 1e-5 and r["gain_max_rel"] <= 1e-3)
    rec["grower_vs_masked"] = growers
    phase("partitioned", **rec)
    if not ok:
        raise AssertionError(f"the partitioned grower differs from the masked one: {growers}")
    if rec["auc"] < 0.90 or abs(rec["auc"] - rec["masked_auc"]) > 0.002:
        raise AssertionError(f"partitioned AUC {rec['auc']} vs masked {rec['masked_auc']}")
    return rec


def _binning_cases():
    rng = np.random.default_rng(SEED + 20)
    special = rng.normal(size=(20_000, 8))
    special[::7, 0] = np.nan
    special[::11, 1] = np.inf
    special[::13, 1] = -np.inf
    special[:, 2] = np.round(special[:, 2] * 3)
    special[:, 3] = 1.5
    special[:, 4] = np.nan
    special[:, 5] = np.where(rng.random(20_000) < 0.5, 0.0, rng.lognormal(size=20_000))
    special[:, 6] = np.where(rng.random(20_000) < 0.3, -0.0, special[:, 6])
    x_main, _ = dataset(N)
    x_gate = gate_data()[0]
    return [("main 200000x64 f32", x_main, 255), ("main 200000x64 f32", x_main, 63),
            ("main 200000x64 f64", x_main.astype(np.float64), 255),
            ("gate 100000x32 f32", x_gate, 63), ("gate 100000x32 f32", x_gate, 255),
            *((f"special f32 max_bin {mb}", special.astype(np.float32), mb) for mb in (2, 63, 255)),
            *((f"special f64 max_bin {mb}", special, mb) for mb in (2, 255))]


def _csr_text(n: int, dim: int, seed: int):
    """Hashed bag-of-words rows (tests/test_gbdt.py's hashing): 5-19 words
    of a 300-word vocabulary, hashed into ``dim`` columns; positive when a
    row holds one of the words 0-4."""
    import scipy.sparse as sp

    r = np.random.default_rng(seed)
    counts = r.integers(5, 20, size=n)
    words = r.integers(0, 300, size=int(counts.sum()))
    rows = np.repeat(np.arange(n), counts)
    y = (np.bincount(rows, weights=(words < 5), minlength=n) > 0).astype(np.float64)
    x = sp.csr_matrix((np.ones(len(words)), (rows, (words * 2654435761) % dim)),
                      shape=(n, dim), dtype=np.float64)
    x.sum_duplicates()
    return x, y


def binning(csr_rows: int = 50_000, csr_dim: int = 4096) -> dict:
    """Device binning (``BinMapper.fit`` + ``bin_tensor`` on the card)
    against the port's CPU binning, bitwise (bounds as f64 bit patterns,
    bins as values), on the main path's and the gate's data, f32 and f64,
    columns with NaN, +-inf, few values, one value, no value and +-0, and
    max_bin 2, 63, 255; then CSR (a hashed bag of words, 50,000 x 4,096):
    bins bitwise, a card fit's AUC on 10,000 held-out rows (>= 0.90: the
    label is the presence of one of 5 words, which 15-leaf trees carve
    out) and its graph == eager. Times:
    ``binning_s`` on the card (the host copy included) and on the CPU."""
    from mmlspark_tpu_torch.models.gbdt import BinMapper
    from mmlspark_tpu_torch.models.gbdt.binning import densify_missing

    def same(a, b) -> bool:
        return all(u.shape == v.shape and np.array_equal(u.view(np.uint64), v.view(np.uint64))
                   for u, v in zip(a.uppers, b.uppers)) and len(a.uppers) == len(b.uppers)

    def timed(fn) -> "tuple[float, object]":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def on_card(x, mb):
        xd = torch.from_numpy(x).to(DEV)
        m = BinMapper.fit(xd, max_bin=mb, seed=0, device=DEV)
        return m, m.bin_tensor(xd, DEV)

    cases = {}
    for name, x, mb in _binning_cases():
        card_s, (card, bins) = timed(lambda: on_card(x, mb))
        if name.startswith("main") and mb == 255:
            card_s, (card, bins) = timed(lambda: on_card(x, mb))   # the second, warm
        cpu_s, (cpu, cbins) = timed(lambda: (lambda m: (m, m.bin_tensor(x, "cpu")))(
            BinMapper.fit(x, max_bin=mb, seed=0, device="cpu")))
        ok = same(card, cpu) and torch.equal(bins.cpu(), cbins)
        cases[f"{name} max_bin {mb}"] = {"bitwise_equal": ok, "binning_s": card_s,
                                         "cpu_binning_s": cpu_s}
        if not ok:
            raise AssertionError(f"binning {name} max_bin {mb}: card and CPU differ")
    x, y = _csr_text(csr_rows + csr_rows // 5, csr_dim, SEED)
    xs_train, xs_test = x[:csr_rows], x[csr_rows:]
    y_train, y_test = y[:csr_rows], y[csr_rows:]
    card_s, card = timed(lambda: BinMapper.fit(xs_train, max_bin=255, device=DEV))
    cpu = BinMapper.fit(xs_train, max_bin=255, device="cpu")
    ok = same(card, cpu) and torch.equal(card.bin_tensor(xs_train, DEV).cpu(),
                                         cpu.bin_tensor(xs_train, "cpu"))
    cfg = TrainConfig(num_iterations=20, num_leaves=15, min_data_in_leaf=5, seed=0)
    rec, b = graph_and_eager("csr", xs_train, y_train, cfg, reps=1, eager_reps=1, profile=False)
    p = b.predict(densify_missing(xs_test), device=DEV)
    csr = dict(rec, rows=csr_rows, columns=csr_dim, nnz=int(xs_train.nnz), bitwise_equal=ok,
               binning_s=card_s, auc=binary_auc(y_test, p))
    phase("binning", csr=csr, **cases)
    if not ok or csr["auc"] < 0.90:
        raise AssertionError(f"CSR on the card: {csr}")
    return cases


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


CARD_VS_CPU_ROUNDS = 5              # depth cut from 20 for the script's time (the CPU fit)


def card_vs_cpu(x_test, y_test, categorical: bool = False) -> dict:
    """The same 20,000-row, CARD_VS_CPU_ROUNDS-round fit on the card and on the
    CPU (plain versions): held-out AUCs within 0.002."""
    if categorical:
        x, y = categorical_dataset(N_CPU, seed=SEED + 9)
    else:
        x, y = dataset(N_CPU, seed=SEED + 1)
    cfg = TrainConfig(num_iterations=CARD_VS_CPU_ROUNDS, num_leaves=63, min_data_in_leaf=20,
                      seed=0, categorical_features=CAT_COLS if categorical else ())
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
    rec = {"rows": len(y), "rounds": CARD_VS_CPU_ROUNDS, "categorical": categorical, "identical_split_share": same / total,
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
        # rounds past the stop, up to the end of their 16-round chunk, are
        # grown and then dropped: one eager warm-up round plus the replays
        # of the captured one
        return {"rounds_run": len(b.trees), "best_iteration": b.best_iteration,
                "rounds_grown": 1 + TRAIN.fused["replays"],
                "fused_chunks": TRAIN.fused["chunks"],
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
            eager_check=False, mode=mode, run="resumed from round 10", stopped_run_s=cut_s)
        identical = m_res.get("model_string") == m_full.get("model_string")
        out[mode] = {"identical": identical, "fit_s": full["fit_s"], "resume_fit_s": resumed["fit_s"]}
        if not identical:
            raise AssertionError(f"{mode}: the resumed fit differs from the uninterrupted one")
    shutil.rmtree(root, ignore_errors=True)
    phase("checkpoint_checks", **out)
    return out


SHAP_ROWS = 250    # host TreeSHAP (~40 ms a row); cut from 2,000, then 1,000, to keep the
                   # whole script well inside its time limit


def shap(model, x_test) -> dict:
    """Exact TreeSHAP and the approximate (Saabas) walk on SHAP_ROWS held-out
    rows of the categorical model: rows sum to ``predict_raw`` within 1e-4."""
    b = model.booster
    rows = x_test[:SHAP_ROWS]
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


def seeded_init() -> dict:
    """flax's seeded init of a ResNet-50 (what the zoo materialises for a
    model without a checkpoint) drawn on the card against the CPU's: every
    value within 4 ulp (the CPU's is within 4 ulp of flax's,
    tests/test_torch_port_zoo.py)."""
    from mmlspark_tpu_torch.models import resnet as R

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        else:
            yield "/".join(path), np.asarray(tree)

    t0 = time.perf_counter()
    card = dict(leaves(R.init_flax_variables(R.resnet50(), seed=0, device=DEV)))
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = dict(leaves(R.init_flax_variables(R.resnet50(), seed=0, device="cpu")))
    cpu_s = time.perf_counter() - t0
    worst, same, total = 0, 0, 0
    for k, a in cpu.items():
        b = card[k]
        worst = max(worst, int(np.abs(a.view(np.int32).astype(np.int64)
                                      - b.view(np.int32).astype(np.int64)).max()))
        same += int((a == b).sum())
        total += a.size
    rec = {"max_ulp": worst, "bitwise_share": same / total, "values": total,
           "card_s": card_s, "cpu_s": cpu_s}
    phase("featurizer", part="seeded init card vs cpu", ulp_tol=4, **rec)
    if worst > 4:
        raise AssertionError(f"the card's seeded init is {worst} ulp off the CPU's")
    return rec


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


def featurizer(smi: str, repo: str) -> dict:
    """The image featurization path: card vs CPU at full width, the trained
    checkpoints, the bench cell, with the zoo at ``repo``."""
    t0 = time.perf_counter()
    rec = {"seeded_init": seeded_init(), "card_vs_cpu": resnet50_card_vs_cpu(),
           "checkpoints": trained_checkpoints(repo),
           "bench": bench_cell(repo, smi)}
    phase("featurizer", part="total", seconds=time.perf_counter() - t0)
    return rec


# -- the pipeline compiler (fused segments as CUDA graphs) ----------------------

PIPE_ROWS, PIPE_PARTS, PIPE_REPS = 16_384, 4, 7   # bench.py's pipeline cell (:1026-1095)
P1B_SIZES = (0, 1, 2, 3, 5, 9, 17, 33, 65, 130, 400)
P1B_CHUNKS = (100, 37, 200, 3, 160)
PIPE_REF_ROWS, PIPE_REF_REL = 512, 1e-5   # card fused vs CPU staged: logits within 1e-5 max|.|


def tanh_half(x: torch.Tensor) -> torch.Tensor:
    """The cell's UDF: tanh(0.5 x), a function of tensors."""
    return torch.tanh(x * 0.5)


def _metric(name: str) -> float:
    """The sum over its labels of one counter of the port's registry."""
    from mmlspark_tpu_torch import obs

    return sum(float(v) for v in re.findall(name + r"\{[^}]*\} (\S+)", obs.render()))


def _fallbacks() -> int:
    return int(_metric("mmlspark_compiler_fallback_total"))


def _exact(a, b) -> bool:
    return a.columns == b.columns and all(
        a[c].dtype == b[c].dtype and np.array_equal(a[c], b[c], equal_nan=True)
        for c in a.columns)


def _p50(fn, df, col: str, reps: int = PIPE_REPS) -> "tuple[float, object]":
    """Median wall seconds of ``fn(df)`` over ``reps`` runs (each reading
    ``col``, which is on the host) and the last output."""
    lat, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(df)
        out[col]
        lat.append(time.perf_counter() - t0)
    return sorted(lat)[len(lat) // 2], out


def _frame(cols: dict, lo: int, hi: int):
    return DataFrame.from_dict({c: v[lo:hi] for c, v in cols.items()})


def _graph_counts(comp) -> list:
    return [len(s._graphs) for s in comp.fused_segments]


def _on_cpu(model):
    """The same fitted stages, run on the CPU (the small-input reference)."""
    from mmlspark_tpu_torch import PipelineModel

    return PipelineModel(stages=[s.copy({"device": "cpu"}) if "device" in type(s).params()
                                 else s for s in model.get("stages")])


def _head_cost() -> dict:
    """The row-independent logistic head (pairwise-order sum of the
    feature products, row-wise softmax) against ``x @ W + b`` with
    ``torch.softmax``/``argmax``, at the cell's 32 features x 4 classes:
    milliseconds per call from CUDA events over 200 calls."""
    from mmlspark_tpu_torch.models.linear import logistic_head

    def plain(x, W, b):
        logits = x @ W + b
        return logits, torch.softmax(logits, 1), torch.argmax(logits, 1)

    g = torch.Generator(device=DEV).manual_seed(0)
    W = torch.randn((32, 4), device=DEV, generator=g)
    b = torch.randn((4,), device=DEV, generator=g)
    out = {}
    for n in (1024, 4096):
        x = torch.randn((n, 32), device=DEV, generator=g)
        for name, fn in (("fixed_order", logistic_head), ("matmul", plain)):
            with torch.inference_mode():
                fn(x, W, b)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(200):
                    fn(x, W, b)
                end.record()
                end.synchronize()
            out[f"{name}_ms_n{n}"] = start.elapsed_time(end) / 200
    return out


def pipeline_p1() -> dict:
    """P1, bench.py's pipeline cell at its accelerator size: 16,384 rows
    from ``default_rng(7)`` (x0..x15 f64 N(0,1), vec (16,) f32, label in
    0..3) in 4 partitions through Featurize -> UDFTransformer(tanh(0.5 x))
    -> LogisticRegression(max_iter=30) on the card; staged against
    ``compile()`` (max_bucket 1024: each 4,096-row partition runs as 4
    graph replays). Fails unless compiled == staged bit for bit, no
    segment fell back, every bucket holds a captured graph, and the card's
    output agrees with the CPU's staged transform on 512 rows."""
    from mmlspark_tpu_torch import Pipeline, obs
    from mmlspark_tpu_torch.featurize import Featurize
    from mmlspark_tpu_torch.models.linear import LogisticRegression
    from mmlspark_tpu_torch.stages import UDFTransformer

    if torch.backends.cudnn.benchmark:
        raise AssertionError("cudnn.benchmark is on: staged and fused could pick different "
                             "algorithms")
    obs.reset()
    rng = np.random.default_rng(7)
    cols = {f"x{i}": rng.standard_normal(PIPE_ROWS) for i in range(16)}
    cols["vec"] = rng.standard_normal((PIPE_ROWS, 16)).astype(np.float32)
    cols["label"] = rng.integers(0, 4, PIPE_ROWS)
    df = DataFrame.from_dict(cols, num_partitions=PIPE_PARTS)
    t0 = time.perf_counter()
    model = Pipeline([
        Featurize(input_cols=[f"x{i}" for i in range(16)] + ["vec"], output_col="features"),
        UDFTransformer(input_col="features", output_col="features_s", vector_udf=tanh_half,
                       jit_compatible=True),
        LogisticRegression(features_col="features_s", label_col="label", max_iter=30),
    ]).fit(df)
    fit_s = time.perf_counter() - t0
    model.transform(df)  # staged warm-up
    staged_s, staged = _p50(model.transform, df, "prediction")
    comp = model.compile()
    t0 = time.perf_counter()
    fused = comp.transform(df)
    fused["prediction"]
    compile_s = time.perf_counter() - t0
    fused_s, fused = _p50(comp.transform, df, "prediction")
    seg = comp.fused_segments[0]
    ref = _on_cpu(model).transform(_frame(cols, 0, PIPE_REF_ROWS))
    lg, want = fused["raw_prediction"][:PIPE_REF_ROWS], ref["raw_prediction"]
    tol = PIPE_REF_REL * float(np.abs(want).max())
    top2 = np.sort(want, axis=1)[:, -2:]
    pred_off = (fused["prediction"][:PIPE_REF_ROWS] != ref["prediction"]) & (
        top2[:, 1] - top2[:, 0] > 2 * tol)
    rec = {
        "part": "P1", "rows": PIPE_ROWS, "partitions": PIPE_PARTS, "max_bucket": 1024,
        "fit_s": fit_s,
        "staged_p50_ms": staged_s * 1e3, "fused_p50_ms": fused_s * 1e3,
        "staged_rows_per_s": PIPE_ROWS / staged_s, "fused_rows_per_s": PIPE_ROWS / fused_s,
        "fused_over_staged": staged_s / fused_s, "compile_s": compile_s,
        "pipeline_stages_fused": comp.num_fused_stages,
        "pipeline_segments": len(comp.segments), "graphs_per_segment": _graph_counts(comp),
        "graph_replays": int(_metric("mmlspark_compiler_graph_replays_total")),
        "fallbacks": _fallbacks(), "exact_equal": _exact(staged, fused),
        "cpu_ref_rows": PIPE_REF_ROWS,
        "cpu_ref_max_logit_diff": float(np.abs(lg - want).max()), "cpu_ref_tol": tol,
        "cpu_ref_prediction_off": int(pred_off.sum()),
        "head": _head_cost(),
    }
    phase("pipeline", **rec)
    if not rec["exact_equal"]:
        raise AssertionError("P1: compiled transform differs from the staged one")
    if rec["fallbacks"] or rec["pipeline_stages_fused"] != 3 or rec["pipeline_segments"] != 1:
        raise AssertionError(f"P1: expected one fused segment of 3 stages, no fallback: {rec}")
    if seg.device != DEV and DEV.type == "cuda" or len(seg._graphs) > 11 or (
            DEV.type == "cuda" and any(g is None for g in seg._graphs.values())):
        raise AssertionError(f"P1: graphs {seg._graphs}")
    if rec["cpu_ref_max_logit_diff"] > tol or rec["cpu_ref_prediction_off"]:
        raise AssertionError(f"P1: the card's output is off the CPU's: {rec}")
    if not np.isfinite(fused["probability"]).all() or fused["prediction"].max() > 3:
        raise AssertionError("P1: malformed output")
    return {"cols": cols, "model": model, **rec}


def pipeline_p1b(cols: dict, model) -> dict:
    """P1b: the cell's model compiled with max_bucket=64, scored at batch
    sizes 0, 1, 2, 3, 5, 9, 17, 33, 65, 130 and 400 and in chunks of 100,
    37, 200, 3 and 160 rows against the whole 500-row frame: every output
    bit for bit the staged one, at most log2(64)+1 = 7 graphs."""
    comp = model.compile(max_bucket=64)
    sizes = {}
    for n in P1B_SIZES:
        sizes[n] = _exact(model.transform(_frame(cols, 0, n)), comp.transform(_frame(cols, 0, n)))
    whole = model.transform(_frame(cols, 0, sum(P1B_CHUNKS)))
    outs, off = [], 0
    for size in P1B_CHUNKS:
        outs.append(comp.transform(_frame(cols, off, off + size)))
        off += size
    chunked = all(np.array_equal(np.concatenate([o[c] for o in outs]), whole[c])
                  and outs[0][c].dtype == whole[c].dtype for c in whole.columns)
    rec = {"part": "P1b", "max_bucket": 64, "sizes_exact": sizes, "chunks": P1B_CHUNKS,
           "chunked_exact": chunked, "graphs_per_segment": _graph_counts(comp),
           "graph_bound": 7, "fallbacks": _fallbacks()}
    rec["exact_equal"] = all(sizes.values()) and chunked
    phase("pipeline", **rec)
    if not rec["exact_equal"] or max(rec["graphs_per_segment"]) > 7:
        raise AssertionError(f"P1b failed: {rec}")
    return rec


def _predict_raw_f64(self, x, num_iteration=None, device=None):
    """``Booster.predict_raw`` with the tree sum taken in f64 and rounded
    once (the port's earlier order, not the JAX package's): timed against
    numpy's pairwise f32 order."""
    n, k = x.shape[0], self.num_class
    base = np.asarray(self.base_score, np.float32)
    per_tree = self._per_tree(x, num_iteration, device)
    T = per_tree.shape[1]
    denom = (T // k) if self.boosting_type == "rf" else 1
    raw = (per_tree.double().view(n, T // k, k).sum(1) / denom).float().cpu().numpy()
    return (raw[:, 0] if k == 1 else raw) + base


def pipeline_p2(x, y, x_test, y_test) -> dict:
    """P2: the trees/s cell's data (200,000 x 64, seed 3) as 64 columns
    through Featurize -> LightGBMClassifier(20 rounds, 63 leaves): the fit
    runs plane_hist (B2), counted by its wrapper (launch counts set to 0
    just before the fit, read just after) and on the device by a
    torch.profiler trace; the staged and compiled transforms of the 50,000
    held-out rows must be bitwise equal and the AUC the plain estimator's.
    Also times GBDT ``transform`` with numpy's pairwise tree sum against
    the f64 sum, alternating, and counts the raw scores the two orders
    round differently."""
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch import Pipeline, obs
    from mmlspark_tpu_torch.featurize import Featurize

    obs.reset()
    names = [f"f{j}" for j in range(D)]
    train_df = DataFrame.from_dict({**{c: x[:, j] for j, c in enumerate(names)}, "label": y})
    test_cols = {c: x_test[:, j] for j, c in enumerate(names)}
    test_df = DataFrame.from_dict(test_cols)
    kw = dict(num_iterations=20, num_leaves=63, min_data_in_leaf=20, seed=0, device=DEV.type)
    torch.cuda.synchronize()
    H.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = Pipeline([Featurize(input_cols=names, output_col="features"),
                          LightGBMClassifier(**kw)]).fit(train_df)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    launches, traced = dict(H.launches), traced_launches(prof)
    plain = LightGBMClassifier(**kw).fit(DataFrame.from_dict({"features": x, "label": y}))
    model.transform(test_df)
    staged_s, staged = _p50(model.transform, test_df, "prediction", reps=5)
    comp = model.compile()
    t0 = time.perf_counter()
    fused = comp.transform(test_df)
    compile_s = time.perf_counter() - t0
    fused_s, fused = _p50(comp.transform, test_df, "prediction", reps=5)
    auc = binary_auc(y_test, fused["probability"][:, 1])
    auc_plain = binary_auc(y_test, plain.transform(
        DataFrame.from_dict({"features": x_test}))["probability"][:, 1])

    booster, feats = plain.booster, DataFrame.from_dict({"features": x_test})
    order = {"pairwise": [], "f64": []}
    new_raw = booster.predict_raw(x_test)
    old_raw = _predict_raw_f64(booster, x_test)
    real = Booster.predict_raw
    try:
        for _ in range(5):
            for name, fn in (("pairwise", real), ("f64", _predict_raw_f64)):
                Booster.predict_raw = fn
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plain.transform(feats)["prediction"]
                order[name].append(time.perf_counter() - t0)
    finally:
        Booster.predict_raw = real
    rec = {
        "part": "P2", "rows": len(y), "test_rows": len(y_test), "columns": D, "trees": 20,
        "fit_s": fit_s, "launches": launches, "traced_launches": traced,
        "staged_p50_ms": staged_s * 1e3, "fused_p50_ms": fused_s * 1e3,
        "staged_rows_per_s": len(y_test) / staged_s, "fused_rows_per_s": len(y_test) / fused_s,
        "compile_s": compile_s, "pipeline_stages_fused": comp.num_fused_stages,
        "pipeline_segments": len(comp.segments), "graphs_per_segment": _graph_counts(comp),
        "fallbacks": _fallbacks(), "exact_equal": _exact(staged, fused),
        "auc": auc, "auc_plain_estimator": auc_plain,
        "gbdt_transform_ms": {k: sorted(v)[len(v) // 2] * 1e3 for k, v in order.items()},
        "raw_rows_differing_f64_vs_pairwise": int((new_raw != old_raw).sum()),
    }
    phase("pipeline", **rec)
    if launches["plane_hist"] == 0 or traced["plane_hist"] < launches["plane_hist"]:
        raise AssertionError(f"P2: the fit did not run plane_hist: {launches} {traced}")
    if not rec["exact_equal"] or rec["fallbacks"] or rec["pipeline_stages_fused"] != 2:
        raise AssertionError(f"P2 failed: {rec}")
    if auc != auc_plain or auc < 0.90:
        raise AssertionError(f"P2: AUC {auc} != the plain estimator's {auc_plain}")
    return rec


def pipeline_p3(repo: str) -> dict:
    """P3: the featurizer cell (2,048 uint8 224x224x3 images, ResNet50,
    batch 256, pool features) through ImageFeaturizer -> LogisticRegression
    (4 random classes, 30 GD steps). ``compile()`` plans the featurizer as
    a host stage and equals staged bit for bit; ``compile(exact=False)``
    fuses the backbone into the segment's CUDA graphs (two 1,024-image
    replays) and its features are within FEAT_BF16_L2 of staged."""
    from mmlspark_tpu_torch import Pipeline
    from mmlspark_tpu_torch.models import ImageFeaturizer
    from mmlspark_tpu_torch.models.linear import LogisticRegression

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, size=(FEAT_ROWS, FEAT_SIZE, FEAT_SIZE, 3), dtype=np.uint8)
    df = DataFrame.from_dict({"image": imgs, "label": rng.integers(0, 4, FEAT_ROWS)})
    model = Pipeline([
        ImageFeaturizer(input_col="image", output_col="features", batch_size=FEAT_BATCH,
                        model_name="ResNet50", cut_output_layers=1, image_size=FEAT_SIZE,
                        repo_dir=repo),
        LogisticRegression(features_col="features", label_col="label", max_iter=30),
    ]).fit(df)
    staged_s, staged = _p50(model.transform, df, "prediction", reps=3)
    exact = model.compile()
    exact.transform(df)
    exact_s, exact_out = _p50(exact.transform, df, "prediction", reps=3)
    loose = model.compile(exact=False)
    t0 = time.perf_counter()
    loose.transform(df)
    compile_s = time.perf_counter() - t0
    loose_s, loose_out = _p50(loose.transform, df, "prediction", reps=3)
    rec = {
        "part": "P3", "images": FEAT_ROWS, "model": "ResNet50", "batch": FEAT_BATCH,
        "staged_images_per_s": FEAT_ROWS / staged_s,
        "exact_images_per_s": FEAT_ROWS / exact_s,
        "fused_images_per_s": FEAT_ROWS / loose_s, "fused_compile_s": compile_s,
        "exact_segments": [type(s).__name__ for s in exact.segments],
        "fused_stages": loose.num_fused_stages, "graphs_per_segment": _graph_counts(loose),
        "exact_equal": _exact(staged, exact_out),
        "fused_features_rel_l2": _rel_l2(loose_out["features"], staged["features"]),
        "fused_prediction_agreement": float(
            (loose_out["prediction"] == staged["prediction"]).mean()),
        "tol": FEAT_BF16_L2, "fallbacks": _fallbacks(),
    }
    phase("pipeline", **rec)
    if not rec["exact_equal"] or rec["exact_segments"] != ["HostSegment", "FusedSegment"]:
        raise AssertionError(f"P3 exact mode failed: {rec}")
    if rec["fused_stages"] != 2 or rec["fused_features_rel_l2"] > FEAT_BF16_L2:
        raise AssertionError(f"P3 exact=False failed: {rec}")
    if rec["fallbacks"] or not np.isfinite(loose_out["features"]).all():
        raise AssertionError(f"P3: fallbacks or non-finite features: {rec}")
    return rec


def pipeline(x, y, x_test, y_test, repo: str) -> dict:
    """The pipeline compiler's phase: P1, P1b, P2, P3."""
    t0 = time.perf_counter()
    p1 = pipeline_p1()
    rec = {"P1": {k: v for k, v in p1.items() if k not in ("cols", "model")},
           "P1b": pipeline_p1b(p1["cols"], p1["model"]),
           "P2": pipeline_p2(x, y, x_test, y_test), "P3": pipeline_p3(repo)}
    phase("pipeline", part="total", seconds=time.perf_counter() - t0)
    return {**rec, "p1_serve": {"cols": p1["cols"], "model": p1["model"]}}


# -- VowpalWabbit: text -> hashed features -> the SGD kernels ---------------------

VW_ROWS, VW_VOCAB, VW_WORDS, VW_HOLDOUT, VW_BITS = 100_000, 2_000, 12, 20_000, 18
VW_PASSES = 8                       # bench.py's resident rate: an 8-pass fit
VW_EXP_TOL = 1e-5                   # logistic/poisson: |dw| <= tol * max|w|
VW_ATOMIC_TOL = 1e-5                # the plain version's atomic scatters on the card (order
                                    # changes from run to run): |dw| <= tol * max|w|
VW_AUC_FLOOR = 0.85                 # V2 held-out AUC; random labels or a wrong kernel give ~0.5
VW_AUC_TOL = 1e-3                   # card against the CPU, the same pipeline
VW_SOURCE = "mmlspark_tpu_torch/ops/csrc/sgd.cu"
VW_TPU = "mmlspark_tpu/vw/learner.py"
FADD_CYCLES = 4                     # a dependent f32 add's latency on the SM (assumed), for the
                                    # chain floor: the longest run's fadds, one after another
# the pass kernel's shapes beyond the main path's: (batch, K); g lives in device memory
# at 4,096 x 64 (and 4,096 x 17), in shared memory elsewhere
VW_PASS_SHAPES = ((1000, 17), (4096, 9), (4096, 64), (1024, 1), (64, 64))
# runs applied by a warp: (K, batch, rows, seed, which rows take one index)
VW_LONG_RUN_SHAPES = {"k1_every_row_one_index": (1, 256, 700, 21, "rows"),
                      "row_on_one_index": (32, 64, 300, 22, "row"),
                      "batch_1000": (17, 1000, 2500, 23, None),
                      "batch_4096": (9, 4096, 5000, 24, None)}
# vw_margin's shapes beyond V2's held-out rows (M1, 20,000 x 17): (rows, fewest and most
# tokens a row, seed); M2 newsgroup-length posts (K = 481), M3 a large scoring batch at
# the width the CPU tests call wide (K = 41)
VW_MARGIN_SHAPES = {"M2": (20_000, 32, 480, 12), "M3": (1_000_000, 1, 40, 13)}
VW_MARGIN_VOCAB = 50_000


def vw_texts(n: int = VW_ROWS):
    """bench.py's vw cell (:478-484): ``default_rng(5)``, 12 words a row
    from a 2,000-word vocabulary, random 0/1 labels. (Drawing from the
    vocabulary as an array takes the same draws as bench.py's list.)"""
    rng = np.random.default_rng(5)
    vocab = np.array([f"w{i}" for i in range(VW_VOCAB)], dtype=object)
    texts = np.array([" ".join(rng.choice(vocab, size=VW_WORDS)) for _ in range(n)],
                     dtype=object)
    return texts, rng.integers(0, 2, size=n).astype(np.float64)


def vw_planted(texts) -> np.ndarray:
    """V2's learnable target: a planted linear score over the vocabulary
    (``default_rng(6)``), summed over each row's words."""
    u = np.random.default_rng(6).normal(size=VW_VOCAB)
    return np.array([sum(u[int(t[1:])] for t in s.split()) for s in texts])


def _vw_rows(n, k, bits, seed, loss):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, min(1 << bits, 2_000), size=(n, k)).astype(np.int64)
    val = (rng.normal(size=(n, k)) * (rng.random((n, k)) < 0.8)).astype(np.float32)
    idx[:, -1], val[:, -1] = 7, 1.0
    y = rng.normal(size=n).astype(np.float32)
    if loss in ("logistic", "hinge"):
        y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    if loss == "poisson":
        y = rng.poisson(2.0, size=n).astype(np.float32)
        val *= np.float32(0.1)
    return idx, val, y, (rng.random(n) + 0.5).astype(np.float32)


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _vw_long_run_rows(case, bits, loss):
    """Rows whose runs a warp applies: K = 1 with every row on one index (one
    run the size of the minibatch), or one row of each minibatch holding a
    single index in all of its slots; else the Constant's run."""
    k, batch, n, seed, one = VW_LONG_RUN_SHAPES[case]
    idx, val, y, wt = _vw_rows(n, k, bits, seed, loss)
    if one == "rows":
        idx[:] = 7
        val[:] = np.where(val == 0, np.float32(0.5), val)
    elif one == "row":
        idx[5::batch] = 3
        val[5::batch] = np.where(val[5::batch] == 0, np.float32(-0.25), val[5::batch])
    return (idx, val, y, wt), batch


def vw_margin_rows(name: str):
    """Hashed text rows for vw_margin's shapes M2 and M3 (VW_MARGIN_SHAPES):
    each row's length uniform in [lo, hi] tokens, each token drawn from a
    VW_MARGIN_VOCAB-word vocabulary by Zipf's law (p ~ 1 / rank) and hashed
    into 2^VW_BITS weights (collisions kept), its value its count (1 to 3)
    over sqrt(length); padded with (0, 0.0) to the longest row rounded up to
    8 and the Constant slot appended, as ``pad_sparse_batch`` and the
    estimators do. Returns int32 idx and f32 val (n, K) and f32 weights
    (2^VW_BITS,), all from the shape's seed."""
    from mmlspark_tpu_torch.vw.estimators import _constant_slot

    n, lo, hi, seed = VW_MARGIN_SHAPES[name]
    rng = np.random.default_rng(seed)
    hashes = rng.integers(0, 1 << VW_BITS, size=VW_MARGIN_VOCAB).astype(np.int32)
    cdf = np.cumsum(1.0 / np.arange(1, VW_MARGIN_VOCAB + 1))
    lengths = rng.integers(lo, hi + 1, size=n)
    width = -(-int(lengths.max()) // 8) * 8
    filled = np.arange(width)[None, :] < lengths[:, None]
    tokens = np.searchsorted(cdf, rng.random(int(lengths.sum())) * cdf[-1])
    counts = rng.integers(1, 4, size=tokens.size)
    idx = np.zeros((n, width + 1), np.int32)
    val = np.zeros((n, width + 1), np.float32)
    idx[:, :width][filled] = hashes[tokens]
    val[:, :width][filled] = (counts / np.sqrt(np.repeat(lengths, lengths))).astype(np.float32)
    idx[:, width], val[:, width] = _constant_slot(VW_BITS), 1.0
    w = (rng.normal(size=1 << VW_BITS) * 0.1).astype(np.float32)
    return idx, val, w


def vw_kernel_checks() -> dict:
    """The kernels against the plain version run on the CPU: bitwise for
    squared, quantile and hinge (adaptive and not, l2 0 and 0.01, batch 64
    and 1,024, K = 9 and 17: the main path's widths; the pass kernel's other
    shapes, VW_PASS_SHAPES, and its long runs, VW_LONG_RUN_SHAPES), twice
    bitwise on the card, one ``vw_pass`` launch a pass and no per-minibatch
    launch; logistic and poisson within VW_EXP_TOL, and the plain version on
    the card (its atomic index_add_) within VW_ATOMIC_TOL; chunked calls
    equal one call."""
    from mmlspark_tpu_torch.ops import sgd
    from mmlspark_tpu_torch.vw import learner as VL

    bits, n = 14, 6_000
    cases = 0

    def bitwise(data, k, **kw):
        idx, val, y, wt = data
        sgd.reset_launch_counts()
        card = VL.train_sparse_sgd(idx, val, y, wt, bits, device=DEV, **kw)
        launched = dict(sgd.launches)
        again = VL.train_sparse_sgd(idx, val, y, wt, bits, device=DEV, **kw)
        cpu = VL.train_sparse_sgd(idx, val, y, wt, bits, device="cpu", **kw)
        if not (_bits_equal(card, cpu) and _bits_equal(card, again)):
            raise AssertionError(f"vw kernels differ from the CPU: {kw}, K={k}")
        if launched["vw_pass"] != kw["num_passes"] or launched["vw_grad"] or launched["vw_apply"]:
            raise AssertionError(f"a pass is not one vw_pass launch: {launched}, {kw}")

    for loss in ("squared", "quantile", "hinge"):
        for adaptive in (True, False):
            common = dict(loss=loss, adaptive=adaptive, num_passes=2,
                          lr=0.5 if adaptive else 0.05, quantile_tau=0.3)
            for l2 in (0.0, 0.01):
                for batch, k in ((64, 9), (64, 17), (1024, 9), (1024, 17)):
                    bitwise(_vw_rows(n, k, bits, batch + k, loss), k, l2=l2, batch=batch,
                            **common)
                    cases += 1
            for batch, k in VW_PASS_SHAPES:
                bitwise(_vw_rows(batch + batch // 2 + 3, k, bits, batch + k, loss), k, l2=0.01,
                        batch=batch, **common)
                cases += 1
            for case in VW_LONG_RUN_SHAPES:
                data, batch = _vw_long_run_rows(case, bits, loss)
                bitwise(data, data[0].shape[1], batch=batch, **common)
                cases += 1
    exp_rel = {}
    for loss in ("logistic", "poisson"):
        for adaptive in (True, False):
            idx, val, y, wt = _vw_rows(n, 17, bits, 3, loss)
            kw = dict(loss=loss, adaptive=adaptive, batch=1024, num_passes=2,
                      lr=0.5 if adaptive else 0.05)
            card = VL.train_sparse_sgd(idx, val, y, wt, bits, device=DEV, **kw)
            again = VL.train_sparse_sgd(idx, val, y, wt, bits, device=DEV, **kw)
            cpu = VL.train_sparse_sgd(idx, val, y, wt, bits, device="cpu", **kw)
            rel = float(np.abs(card - cpu).max() / np.abs(cpu).max())
            if rel > VW_EXP_TOL or not _bits_equal(card, again):
                raise AssertionError(f"vw {loss} adaptive={adaptive}: rel {rel}")
            exp_rel[f"{loss}_{'adaptive' if adaptive else 'power_t'}"] = rel
    # the plain version on the card: the same arithmetic, atomic scatters
    idx, val, y, wt = _vw_rows(n, 17, bits, 4, "squared")
    t = [torch.from_numpy(a).to(DEV) for a in (idx.astype(np.int32), val, y, wt)]
    pad = (-n) % 1024
    t = [torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))]) for a in t]
    w = torch.zeros(1 << bits, device=DEV)
    g2 = torch.zeros_like(w)
    sgd.sgd_pass_plain(*t, w, g2, None, loss="squared", batch=1024, tau=0.5, lr=0.5, l2=0.0,
                       eps=1e-6, adaptive=True)
    cpu = VL.train_sparse_sgd(idx, val, y, wt, bits, device="cpu", loss="squared", batch=1024)
    atomic_rel = float(np.abs(w.cpu().numpy() - cpu).max() / np.abs(cpu).max())
    if atomic_rel > VW_ATOMIC_TOL:
        raise AssertionError(f"the plain version on the card: rel {atomic_rel}")
    # chunked train_sparse_sgd_state == one call (the step counter carries)
    chunked = {}
    for adaptive in (True, False):
        kw = dict(loss="squared", adaptive=adaptive, batch=1024, device=DEV,
                  lr=0.5 if adaptive else 0.05)
        one = VL.train_sparse_sgd_state(idx[:5120], val[:5120], y[:5120], wt[:5120], bits, **kw)
        st = None
        for lo, hi in ((0, 2048), (2048, 3072), (3072, 5120)):
            st = VL.train_sparse_sgd_state(idx[lo:hi], val[lo:hi], y[lo:hi], wt[lo:hi], bits,
                                           st, **kw)
        ok = (float(st.t) == float(one.t) == 5.0 and torch.equal(st.w, one.w)
              and torch.equal(st.g2, one.g2))
        if not ok:
            raise AssertionError(f"chunked != one call (adaptive={adaptive})")
        chunked["adaptive" if adaptive else "power_t"] = True
    # vw_margin at the main path's widths
    for k in (9, 17):
        idx, val, _, _ = _vw_rows(20_000, k, bits, k, "squared")
        wv = np.random.default_rng(k).normal(size=1 << bits).astype(np.float32)
        if not _bits_equal(VL.predict_margin(idx, val, wv, device=DEV),
                           VL.predict_margin(idx, val, wv, device="cpu")):
            raise AssertionError(f"vw_margin differs from the CPU at K={k}")
    rec = {"bitwise_cases": cases, "pass_shapes": [list(x) for x in VW_PASS_SHAPES],
           "long_run_shapes": sorted(VW_LONG_RUN_SHAPES), "exp_loss_rel": exp_rel,
           "plain_on_card_atomic_rel": atomic_rel, "chunked_equal": chunked,
           "margin_bitwise_k": [9, 17]}
    phase("vw", part="kernel checks", tol=VW_EXP_TOL, atomic_tol=VW_ATOMIC_TOL, **rec)
    return rec


def _vw_fit_s(est, df) -> float:
    t0 = time.perf_counter()
    est.fit(df)
    return time.perf_counter() - t0


@contextlib.contextmanager
def _pass_events(sgd):
    """Wraps ``sgd.sgd_pass`` to record two CUDA events around each pass;
    yields the list of (start, end) pairs."""
    real, pairs = sgd.sgd_pass, []

    def timed(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        real(*args, **kw)
        end.record()
        pairs.append((start, end))

    sgd.sgd_pass = timed
    try:
        yield pairs
    finally:
        sgd.sgd_pass = real


def vw_v1(texts, y) -> dict:
    """V1, bench.py's vw cell as written (:473-510): ``input_cols=["text"]``
    hashes each sentence as one categorical feature (K = 9 with the
    Constant), random labels. rows/s of a 1-pass fit after a warm-up fit,
    and the resident rows/s from an 8-pass fit by bench.py's formula, at
    the card's automatic batch (1,024) and at 64; beside it the resident
    rows/s from the passes' own device time (CUDA events around each pass of
    the 8-pass fit), which host noise in the fits does not hide."""
    from mmlspark_tpu_torch.ops import sgd
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier, VowpalWabbitFeaturizer

    df = DataFrame.from_dict({"text": texts, "label": y})
    t0 = time.perf_counter()
    fdf = VowpalWabbitFeaturizer(input_cols=["text"], output_col="features").transform(df)
    rec = {"rows": len(y), "featurize_s": time.perf_counter() - t0}
    for batch in (0, 64):
        clf = VowpalWabbitClassifier(num_passes=1, batch_size=batch)
        clf_p = VowpalWabbitClassifier(num_passes=VW_PASSES, batch_size=batch)
        _vw_fit_s(clf, fdf)
        dt = _vw_fit_s(clf, fdf)
        _vw_fit_s(clf_p, fdf)
        with _pass_events(sgd) as pairs:
            dtp = _vw_fit_s(clf_p, fdf)
        torch.cuda.synchronize()
        pass_ms = [a.elapsed_time(b) for a, b in pairs]
        cell = {"fit_s": dt, "rows_per_sec": len(y) / dt, "fit_8pass_s": dtp,
                "pass_device_ms": pass_ms,
                "rows_per_sec_resident_device": len(y) / (sum(pass_ms) / len(pass_ms) / 1e3)}
        if dtp > dt * 1.05:
            cell["rows_per_sec_resident"] = len(y) / ((dtp - dt) / (VW_PASSES - 1))
        rec["batch_auto_1024" if batch == 0 else "batch_64"] = cell
    phase("vw", part="V1 bench.py cell", **rec)
    return rec


def _cb_frame(n: int, seed: int):
    """Contextual bandit log: 10 contexts, 4 actions logged uniformly
    (p = 1/4); one cheap action per context (cost 0, else 1, plus noise)."""
    from mmlspark_tpu_torch.vw import make_sparse

    rng = np.random.default_rng(seed)
    ctx = rng.integers(0, 10, n)
    chosen = rng.integers(1, 5, n)
    best = 1 + (np.arange(10) * 7) % 4
    acts = np.empty(n, dtype=object)
    shared = np.empty(n, dtype=object)
    for i in range(n):
        acts[i] = [make_sparse([100 + a, 1000 + 4 * ctx[i] + a], [1.0, 1.0]) for a in range(4)]
        shared[i] = make_sparse([10 + ctx[i]], [1.0])
    cost = (chosen != best[ctx]).astype(np.float64) + rng.normal(size=n) * 0.1
    return DataFrame.from_dict({"shared": shared, "features": acts, "chosen_action": chosen,
                                "probability": np.full(n, 0.25), "label": cost})


def vw_bandit() -> dict:
    """A VowpalWabbitContextualBandit fit on 20,000 logged rows; its greedy
    policy's IPS cost on 5,000 held-out rows must beat the uniform logging
    policy's."""
    from mmlspark_tpu_torch.vw import ContextualBanditMetrics, VowpalWabbitContextualBandit

    train_df, test_df = _cb_frame(20_000, 1), _cb_frame(5_000, 2)
    model = VowpalWabbitContextualBandit(num_bits=12, num_passes=2).fit(train_df)
    pred = model.transform(test_df)["prediction"]
    learned, uniform = ContextualBanditMetrics(), ContextualBanditMetrics()
    for a, p, c, act in zip(test_df["chosen_action"], test_df["probability"],
                            test_df["label"], pred):
        learned.add(1.0 if act == a else 0.0, p, c)
        uniform.add(0.25, p, c)
    rec = {"ips_learned": learned.get_ips_estimate(), "ips_uniform": uniform.get_ips_estimate(),
           "snips_learned": learned.get_snips_estimate()}
    if not rec["ips_learned"] < rec["ips_uniform"]:
        raise AssertionError(f"the bandit policy does not beat uniform: {rec}")
    return rec


def vw_v2(texts) -> dict:
    """V2, the same texts split into tokens (K = 17 with padding and the
    Constant) with learnable labels, 20,000 rows held out: UnicodeNormalize
    -> ValueIndexer (string labels) -> VowpalWabbitFeaturizer ->
    VowpalWabbitClassifier(num_passes=3) -> IndexToValue, fitted on the card
    and on the CPU (the same pipeline, batch 1,024 in both): held-out AUCs
    within VW_AUC_TOL and above VW_AUC_FLOOR. The squared-loss regressor on
    the planted score: card weights bitwise the CPU's. This fit and
    transform are the slice's main path: the kernels' launch counts are
    read around them."""
    from mmlspark_tpu_torch import Pipeline
    from mmlspark_tpu_torch.featurize import IndexToValue, ValueIndexer
    from mmlspark_tpu_torch.ops import native_loader, sgd
    from mmlspark_tpu_torch.stages import UnicodeNormalize
    from mmlspark_tpu_torch.vw import (VowpalWabbitClassifier, VowpalWabbitFeaturizer,
                                       VowpalWabbitRegressor)

    native = native_loader.try_load() is not None
    if not native:
        raise AssertionError("the native murmur3 library did not load")
    score = vw_planted(texts)
    noise = np.random.default_rng(7).normal(size=len(texts)) * 1.0
    labels = np.where(score + noise > 0, "pos", "neg").astype(object)
    n_fit = len(texts) - VW_HOLDOUT
    full = DataFrame.from_dict({"text": texts, "label_str": labels, "score": score})
    train_df = DataFrame.from_dict({"text": texts[:n_fit], "label_str": labels[:n_fit]})
    test_df = DataFrame.from_dict({"text": texts[n_fit:], "label_str": labels[n_fit:]})
    t0 = time.perf_counter()
    feat = VowpalWabbitFeaturizer(input_cols=[], string_split_input_cols=["norm"],
                                  num_bits=VW_BITS)
    fdf = feat.transform(UnicodeNormalize(input_col="text", output_col="norm").transform(full))
    featurize_s = time.perf_counter() - t0

    def pipe(device):
        return Pipeline(stages=[
            UnicodeNormalize(input_col="text", output_col="norm"),
            ValueIndexer(input_col="label_str", output_col="label"),
            VowpalWabbitFeaturizer(input_cols=[], string_split_input_cols=["norm"],
                                   num_bits=VW_BITS),
            VowpalWabbitClassifier(num_passes=3, batch_size=1024, device=device),
            IndexToValue(input_col="label", output_col="label_back"),
        ])

    sgd.reset_launch_counts()
    t0 = time.perf_counter()
    model = pipe("cuda").fit(train_df)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(test_df)
    prob = out["probability"]
    transform_s = time.perf_counter() - t0
    launches = dict(sgd.launches)
    # the main path's kernels: vw_pass (one a pass) and vw_margin; the stand-alone
    # entries never launch there (no per-minibatch launches)
    if (min(launches["vw_pass"], launches["vw_margin"]) == 0
            or launches["vw_grad"] or launches["vw_apply"]):
        raise AssertionError(f"the main path's launches are wrong: {launches}")
    y_test = (labels[n_fit:] == "pos").astype(np.float64)
    auc = binary_auc(y_test, prob)
    cpu_out = pipe("cpu").fit(train_df).transform(test_df)
    auc_cpu = binary_auc(y_test, cpu_out["probability"])
    if not (auc >= VW_AUC_FLOOR and abs(auc - auc_cpu) <= VW_AUC_TOL):
        raise AssertionError(f"V2 AUC card {auc} cpu {auc_cpu}")
    if not np.array_equal(out["label_back"], test_df["label_str"]):
        raise AssertionError("IndexToValue did not give the labels back")
    reg = {d: VowpalWabbitRegressor(label_col="score", num_passes=2, batch_size=1024,
                                    device=d).fit(fdf.select("features", "score"))
           for d in ("cuda", "cpu")}
    wc, wp = (np.asarray(reg[d].get("weights")) for d in ("cuda", "cpu"))
    if not _bits_equal(wc, wp):
        raise AssertionError("the regressor's card weights differ from the CPU's")
    rmse = float(np.sqrt(np.mean((reg["cuda"].transform(fdf)["prediction"] - score) ** 2)))
    rec = {"rows_fit": n_fit, "rows_test": VW_HOLDOUT, "native_murmur3": native,
           "featurize_rows_per_sec": len(texts) / featurize_s,
           "fit_s": fit_s, "fit_rows_per_sec": n_fit / fit_s,
           "transform_s": transform_s, "transform_rows_per_sec": VW_HOLDOUT / transform_s,
           "auc": auc, "auc_cpu": auc_cpu, "auc_floor": VW_AUC_FLOOR,
           "launches": launches, "regressor_weights_bitwise": True,
           "regressor_rmse": rmse, "score_std": float(score.std()),
           "bandit": vw_bandit()}
    phase("vw", part="V2 split text", **rec)
    return {**rec, "fdf": fdf, "classifier": model.get("stages")[3]}


def _sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def _vw_chain_floor_ms(plan, adaptive: bool, clock_hz: float) -> float:
    """The least time the bits allow: each minibatch's longest run, its
    fadds one after another (two chains when adaptive, g2's then w's), at
    FADD_CYCLES a fadd and the SM's top clock."""
    lengths = (plan.run_start[1:] - plan.run_start[:-1]).long()
    nb = plan.mb_runs.numel() - 1
    mb = torch.searchsorted(plan.mb_runs.long(), torch.arange(lengths.numel(),
                            device=lengths.device), right=True) - 1
    longest = torch.zeros(nb, dtype=torch.long, device=lengths.device).scatter_reduce_(
        0, mb, lengths, "amax")
    return float(longest.sum()) * (2 if adaptive else 1) * FADD_CYCLES / clock_hz * 1e3


def _vw_pass_bytes(n_pad: int, k: int, plan) -> int:
    """What a pass must move: each row's idx, val, y and weight read once,
    the plan read once (order, run_start, run_index), and each weight it
    touches read and written once with its AdaGrad sum (16 bytes)."""
    e, r = int(plan.run_start[-1]), int(plan.mb_runs[-1])
    return n_pad * (8 * k + 8) + e * 4 + r * 8 + 16 * int(plan.run_index.unique().numel())


def _vw_padded(train, batch: int):
    """A VowpalWabbitClassifier's rows of ``train`` as the learner uploads
    them: gathered, labels to +-1, padded to whole minibatches of ``batch``
    (weight 0). Returns (idx, val, y, wt, bits, n) as numpy."""
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier

    idx, val, y, _, bits = VowpalWabbitClassifier()._gather(train)
    y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    n, k = idx.shape
    pad = -(-n // batch) * batch - n
    return (np.concatenate([idx, np.zeros((pad, k), idx.dtype)]).astype(np.int32),
            np.concatenate([val, np.zeros((pad, k), np.float32)]),
            np.concatenate([y, np.zeros(pad, np.float32)]),
            np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)]), bits, n)


def vw_times(train) -> dict:
    """Each kernel at the main path's shapes (V2: a minibatch of 1,024 rows
    x 17 slots, through the stand-alone grad and apply phases of the pass
    kernel; a whole pass over V2's 100,000 rows at batch 1,024; scoring
    V2's 20,000 held-out rows, M1, and M2 and M3 of ``vw_margin_rows``): its
    max |card - CPU plain version| on the same inputs, and
    its time, eager and in a CUDA graph, against its plain version and one
    PyTorch call, timed the same two ways (``index_add_`` for the apply
    phase's scatter, ``embedding_bag`` for vw_margin's sparse dot; the grad
    phase and the pass have none). Bounds count the bytes this data moves:
    each input read once, each output written once, the weights only where
    gathered or updated; beside them the chain floor, the least time that
    keeps the bits (``_vw_chain_floor_ms``)."""
    from mmlspark_tpu_torch.ops import sgd

    clock = _sm_clock_hz()
    idx, val, yall, wtall, bits, n = _vw_padded(train, 1024)
    d = 1 << bits
    b, k = 1024, idx.shape[1]
    ib = torch.from_numpy(idx[:b]).to(DEV)
    vb = torch.from_numpy(val[:b]).to(DEV)
    y = torch.from_numpy(np.where(np.arange(b) % 2, 1.0, -1.0).astype(np.float32)).to(DEV)
    wt = torch.ones(b, device=DEV)
    w = torch.from_numpy(np.random.default_rng(0).normal(size=d).astype(np.float32) * 0.01).to(DEV)
    g2 = torch.ones(d, device=DEV)
    grad_kw = dict(loss="logistic", tau=0.5, l2=0.0)
    g = sgd.vw_grad_step(ib, vb, y, wt, w, **grad_kw)
    plan = sgd.sgd_plan(ib, vb, b, d)
    e, r = int(plan.run_start[-1]), int(plan.mb_runs[-1])
    flat, u = ib.long().reshape(-1), g.reshape(-1)
    ws, g2s = w.clone(), g2.clone()
    apply_kw = dict(lr=0.5, eps=1e-6, adaptive=True)
    n_m = VW_HOLDOUT
    im = torch.from_numpy(idx[n - n_m:n]).to(DEV)
    vm = torch.from_numpy(val[n - n_m:n]).to(DEV)
    # the whole pass, at V2's 100,000 rows in minibatches of 1,024
    it, vt, yt, wtt = (torch.from_numpy(a).to(DEV) for a in (idx, val, yall, wtall))
    pplan = sgd.sgd_plan(it, vt, b, d)
    pass_kw = dict(loss="logistic", batch=b, tau=0.5, lr=0.5, l2=0.0, eps=1e-6, adaptive=True)
    wp, g2p, wq, g2q = (torch.zeros(d, device=DEV) for _ in range(4))
    out = {
        "vw_grad": _timed(lambda: sgd.vw_grad_step(ib, vb, y, wt, w, **grad_kw),
                          lambda: sgd.grad_plain(ib, vb, y, wt, w, **grad_kw), None,
                          b * k * 16 + b * 8, b * k * 4),
        "vw_apply": _timed(lambda: sgd.vw_apply_step(ib, g, ws, g2s, None, plan, **apply_kw),
                           lambda: sgd.apply_plain(ib, g, ws, g2s, None, **apply_kw),
                           lambda: ws.index_add_(0, flat, u),
                           e * 8 + r * 24, e * 5),
        "vw_pass": _timed(lambda: sgd.vw_pass(it, vt, yt, wtt, wp, g2p, None, pplan, **pass_kw),
                          lambda: sgd.sgd_pass_plain(it, vt, yt, wtt, wq, g2q, None, **pass_kw),
                          None, _vw_pass_bytes(len(idx), k, pplan),
                          len(idx) * k * 6 + int(pplan.run_start[-1]) * 5, iters=3),
    }
    out["vw_apply"].update(entries=e, runs=r, longest_run=int(
        (plan.run_start[1:] - plan.run_start[:-1]).max()),
        chain_floor_ms=_vw_chain_floor_ms(plan, True, clock))
    out["vw_pass"].update(rows=len(idx), minibatches=len(idx) // b,
                          chain_floor_ms=_vw_chain_floor_ms(pplan, True, clock))
    # max |card - CPU plain| of each kernel on these inputs: vw_grad and the
    # pass within VW_EXP_TOL * max |g| or |w| (logistic calls expf), vw_apply
    # and vw_margin bitwise
    host = [a.cpu() for a in (ib, vb, y, wt, w, g2, g)]
    g_cpu = sgd.grad_plain(*host[:5], **grad_kw)
    wa, g2a, wc, g2c = w.clone(), g2.clone(), host[4].clone(), host[5].clone()
    sgd.vw_apply_step(ib, g, wa, g2a, None, plan, **apply_kw)
    sgd.apply_plain(host[0], host[6], wc, g2c, None, **apply_kw)
    wp.zero_(), g2p.zero_()
    sgd.vw_pass(it, vt, yt, wtt, wp, g2p, None, pplan, **pass_kw)
    wpc, g2pc = torch.zeros(d), torch.zeros(d)
    sgd.sgd_pass_plain(*(torch.from_numpy(a) for a in (idx, val, yall, wtall)), wpc, g2pc, None,
                       **pass_kw)
    errs = {
        "vw_grad": float((g.cpu() - g_cpu).abs().max()),
        "vw_apply": max(float((wa.cpu() - wc).abs().max()), float((g2a.cpu() - g2c).abs().max())),
        "vw_pass": float((wp.cpu() - wpc).abs().max()),
    }
    if (errs["vw_grad"] > VW_EXP_TOL * float(g_cpu.abs().max())
            or errs["vw_pass"] > VW_EXP_TOL * float(wpc.abs().max())
            or errs["vw_apply"]):
        raise AssertionError(f"vw kernels at the main path's shapes differ from the CPU: {errs}")
    for name, err in errs.items():
        out[name]["max_abs_err"] = err
    # vw_margin at V2's held-out rows (M1, the record's own numbers) and at M2, M3
    shapes = {"M1": vw_margin_shape(im, vm, w)}
    for name in VW_MARGIN_SHAPES:
        shapes[name] = vw_margin_shape(*(torch.from_numpy(a).to(DEV)
                                         for a in vw_margin_rows(name)))
        torch.cuda.empty_cache()
    out["vw_margin"] = {**shapes["M1"], "shapes": shapes}
    phase("vw", part="times", batch=b, k=k, sm_clock_hz=clock, fadd_cycles=FADD_CYCLES, **out)
    return out


def vw_margin_shape(idx, val, w) -> dict:
    """vw_margin on (n, K) rows on the card: one launch a call, its margins
    bitwise the plain version's on the CPU (max |card - CPU| must be 0), and
    its time eager and in a CUDA graph beside ``margin_plain`` and
    ``embedding_bag`` timed the same two ways, its byte bound (each input
    read once: the rows' indices and values, each weight they touch; the
    margins written: n K 8 + 4 distinct + n 4 bytes) and its share of that
    bound in the graph; beside it the earlier count, which takes a
    weight read from device memory for every slot (n K 12 + n 4 bytes; the
    gathers mostly hit the L2 cache, which holds all 2^18 weights)."""
    from mmlspark_tpu_torch.ops import sgd

    n, k = idx.shape
    sgd.reset_launch_counts()
    got = sgd.vw_margin(idx, val, w).cpu()
    launched = sgd.launches["vw_margin"]
    cpu = sgd.margin_plain(idx.cpu(), val.cpu(), w.cpu())
    if launched != 1 or not _bits_equal(got.numpy(), cpu.numpy()):
        raise AssertionError(f"vw_margin at {n} x {k}: {launched} launches, max |card - cpu| "
                             f"{float((got - cpu).abs().max())}")
    idx64, w1 = idx.long(), w[:, None]
    rec = _timed(lambda: sgd.vw_margin(idx, val, w), lambda: sgd.margin_plain(idx, val, w),
                 lambda: torch.nn.functional.embedding_bag(idx64, w1, per_sample_weights=val,
                                                           mode="sum"),
                 n * k * 8 + 4 * int(torch.unique(idx).numel()) + n * 4, n * k * 2)
    gather_bound = (n * k * 12 + n * 4) / HBM_BYTES_PER_S * 1e3
    rec.update(rows=n, k=k, max_abs_err=float((got - cpu).abs().max()), launches_a_call=launched,
               share_of_bound=rec["bound_ms"] / rec["device_ms"], gather_bound_ms=gather_bound,
               share_of_gather_bound=gather_bound / rec["device_ms"],
               padding_share=float((val == 0).float().mean()),
               layout=sgd.margin_layout(n, k, sgd._sm_count(DEV.index or 0))._asdict())
    return rec


def vw_breakdown(fdf, batch: int, passes: int, name: str) -> dict:
    """Where one VowpalWabbitClassifier fit's time goes, step by step as
    ``vw/learner.py`` runs it: the host gather (namespaces combined, rows
    padded, the Constant appended), the upload, the one-time sort of the
    runs (``sgd_plan``), and each pass (wall, and device ms from CUDA
    events) with its launches; the device's idle share of the fit; the bytes
    a pass moves and its chain floor."""
    from mmlspark_tpu_torch.ops import sgd
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier

    clf = VowpalWabbitClassifier(num_passes=passes, batch_size=batch)
    torch.cuda.synchronize()
    t_fit = time.perf_counter()
    t0 = time.perf_counter()
    idx, val, y, wt, bits = clf._gather(fdf)
    y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    n, k = idx.shape
    n_pad = -(-n // batch) * batch
    pad = n_pad - n
    idx = np.concatenate([idx, np.zeros((pad, k), idx.dtype)]).astype(np.int32)
    val = np.concatenate([val, np.zeros((pad, k), np.float32)])
    y = np.concatenate([y, np.zeros(pad, np.float32)])
    wt = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    gather_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    it, vt, yt, wtt = (torch.from_numpy(a).to(DEV) for a in (idx, val, y, wt))
    w = torch.zeros(1 << bits, device=DEV)
    g2 = torch.zeros_like(w)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = sgd.sgd_plan(it, vt, batch, 1 << bits)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    pass_wall, pass_dev = [], []
    sgd.reset_launch_counts()
    for _ in range(passes):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        sgd.sgd_pass(it, vt, yt, wtt, w, g2, None, plan, loss="logistic", batch=batch,
                     tau=0.5, lr=0.5, l2=0.0, eps=1e-6, adaptive=True)
        end.record()
        end.synchronize()
        pass_wall.append(time.perf_counter() - t0)
        pass_dev.append(start.elapsed_time(end))
    launched = dict(sgd.launches)
    w.cpu()
    fit_s = time.perf_counter() - t_fit
    nb = n_pad // batch
    e, r = int(plan.run_start[-1]), int(plan.mb_runs[-1])
    pass_bytes = _vw_pass_bytes(n_pad, k, plan)
    rec = {"batch": batch, "passes": passes, "rows": n, "k": k, "minibatches": nb,
           "entries": e, "runs": r, "long_runs": int(plan.long_runs.numel()),
           "gather_s": gather_s, "upload_s": upload_s,
           "sort_s": plan_s, "pass_wall_s": pass_wall, "pass_device_ms": pass_dev,
           "launches_per_pass": sum(launched.values()) / passes, "launches": launched,
           "fit_s": fit_s, "device_busy_share": sum(pass_dev) / 1e3 / fit_s,
           "pass_bytes": pass_bytes, "pass_bound_ms": pass_bytes / HBM_BYTES_PER_S * 1e3,
           "pass_chain_floor_ms": _vw_chain_floor_ms(plan, True, _sm_clock_hz())}
    phase("vw", part=f"breakdown {name}", **rec)
    return rec


def vw(smi: str) -> dict:
    t0 = time.perf_counter()
    checks = vw_kernel_checks()
    texts, y = vw_texts()
    v1 = vw_v1(texts, y)
    v2 = vw_v2(texts)
    fdf = v2.pop("fdf")
    serve = {"model": v2.pop("classifier"), "rows": fdf["features"][-VW_HOLDOUT:][:64],
             # phase online's feedback: V2's rows and planted labels, in order
             "online": {"features": fdf["features"],
                        "label": (fdf["label_str"] == "pos").astype(np.float64)}}
    train = fdf.select("features", "score").with_column(
        "label", lambda p: (p["score"] > 0).astype(np.float64))
    times = vw_times(train)
    breakdown = {f"V2_b{b}": vw_breakdown(train, b, 3, f"V2 b{b}") for b in (1024, 64)}
    phase("vw", part="total", seconds=time.perf_counter() - t0, nvidia_smi=smi)
    return {"checks": checks, "V1": v1, "V2": v2, "times": times, "breakdown": breakdown,
            "serve": serve}


# -- phase serving: one worker on the card (WorkerServer -> ModelDispatcher -> ModelStore) ----

SERVE_REQUESTS, SERVE_WARM = 300, 50   # bench.py _seg_serving: 300 sequential POSTs, 50 warm-up
SERVE_ROWS = 16                        # distinct request rows a model cycles through
SERVE_IMAGES = 4                       # distinct images for the zoo model
SERVE_ZOO, SERVE_IMAGE = "ResNet50", 224   # the zoo model at its input size
SERVE_BUCKETS = 64                     # the dispatcher's max_batch_size: warmup captures to it
# a version's device bytes (the store's resident_bytes) against the rise of
# memory_allocated plus graph-pool bytes at its load, and the level after its
# unload against the one before its load: the caching allocator rounds each
# block up to 512 bytes and may leave a large block unsplit (up to 1 MiB over)
SERVE_MEM_MARGIN = 4 << 20
SERVE_MEM_REL = 0.02


def _serve_mem() -> "tuple[int, int]":
    """(memory_allocated, bytes reserved for CUDA graph pools) on the card."""
    pools = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))
    return torch.cuda.memory_allocated(), int(pools)


def _mem_ok(got: int, want: int) -> bool:
    return abs(got - want) <= SERVE_MEM_MARGIN + SERVE_MEM_REL * abs(want)


def _settle() -> None:
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _post_loop(port: int, path: str, bodies: list) -> dict:
    """SERVE_REQUESTS sequential keep-alive POSTs cycling through
    ``bodies``, as bench.py's serving segment sends them: statuses,
    bodies, ms each."""
    import http.client

    n = SERVE_REQUESTS
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    out = {"status": [], "body": [], "ms": [], "row": []}
    for i in range(n):
        k = i % len(bodies)
        t0 = time.perf_counter()
        conn.request("POST", path, body=bodies[k], headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["status"].append(r.status)
        out["body"].append(data)
        out["row"].append(k)
    conn.close()
    return out


def _quantiles(ms: list) -> dict:
    a = np.sort(np.asarray(ms))
    return {"p50_ms": float(a[len(a) // 2]), "p99_ms": float(a[int(len(a) * 0.99)]),
            "n": int(a.size)}


def _serving_files(d: str, gbdt_string: str, vw_model, p1: dict) -> dict:
    """Each model written the way its loader reads it; returns the specs
    and the request rows."""
    from mmlspark_tpu_torch import PipelineModel

    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "trees.gbdt.json"), "w") as f:
        f.write(gbdt_string)
    meta = json.dumps({"num_bits": vw_model.get("num_bits"),
                       "loss": vw_model.get("loss_function") or "logistic",
                       "no_constant": vw_model.get("no_constant")}).encode()
    np.savez(os.path.join(d, "v2.npz"), weights=np.asarray(vw_model.get("weights"), np.float32),
             meta=np.frombuffer(meta, np.uint8))
    cols = p1["cols"]
    inputs = [f"x{i}" for i in range(16)] + ["vec"]
    warm = {c: np.asarray(cols[c][:SERVE_BUCKETS]).tolist() for c in inputs}
    stages = p1["model"].get("stages")
    lr = stages[-1]
    # version 2 of the pipeline: the same stages with the head's weights halved
    v2 = PipelineModel(stages=list(stages[:-1]) + [
        lr.copy({"weights": np.asarray(lr.get("weights")) * np.float32(0.5)})])
    for name, model in (("p1", p1["model"]), ("p1_v2", v2)):
        model.save(os.path.join(d, name))
        with open(os.path.join(d, name, "warmup.json"), "w") as f:
            json.dump(warm, f)
    return {"specs": {"echo": "echo", "gbdt": f"gbdt:{d}/trees.gbdt.json",
                      "vw": f"vw:{d}/v2.npz", "pipeline": f"pipeline:{d}/p1",
                      SERVE_ZOO: f"zoo:{SERVE_ZOO}"},
            "pipeline_v2": f"pipeline:{d}/p1_v2", "models": {"p1": p1["model"], "p1_v2": v2}}


def _serving_requests(x_test, vw_rows, cols, rng) -> dict:
    """The request bodies of each model (bytes) and the rows behind them."""
    gb = x_test[:SERVE_ROWS]
    vw = [{"i": np.asarray(r["i"]).tolist(), "v": np.asarray(r["v"], np.float32).tolist()}
          for r in vw_rows[:SERVE_ROWS]]
    pipe = [{**{f"x{i}": float(cols[f"x{i}"][k]) for i in range(16)},
             "vec": np.asarray(cols["vec"][k]).tolist()} for k in range(SERVE_ROWS)]
    imgs = rng.integers(0, 256, (SERVE_IMAGES, SERVE_IMAGE, SERVE_IMAGE, 3), dtype=np.uint8)
    return {
        "echo": [json.dumps({"k": k, "x": rng.standard_normal(4).tolist()}).encode()
                 for k in range(SERVE_ROWS)],
        "gbdt": [json.dumps({"features": r.tolist()}).encode() for r in gb],
        "vw": [json.dumps(r).encode() for r in vw],
        "pipeline": [json.dumps(r).encode() for r in pipe],
        SERVE_ZOO: [json.dumps({"image": im.tolist()}).encode() for im in imgs],
        "rows": {"gbdt": gb, "vw": vw, "pipeline": pipe, SERVE_ZOO: imgs},
    }


def _serving_expected(req: dict, gbdt_string: str, vw_model, models: dict, repo: str) -> dict:
    """Each model called in-process on the card on the same rows (and VW's
    margins on the CPU plain version too): what every reply must equal."""
    from mmlspark_tpu_torch.models import ImageFeaturizer

    rows = req["rows"]
    booster = Booster.from_model_string(gbdt_string)
    margins = booster.predict(rows["gbdt"], device=DEV)
    vdf = DataFrame.from_dict({"features": _obj(rows["vw"])})
    vw_card = vw_model.copy({"device": DEV.type}).transform(vdf)["raw_prediction"]
    vw_cpu = vw_model.copy({"device": "cpu"}).transform(vdf)["raw_prediction"]
    pipe = {}
    for name, model in models.items():
        comp = model.compile()
        pdf = DataFrame.from_dict({c: (np.asarray([r[c] for r in rows["pipeline"]],
                                                   np.float32 if c == "vec" else np.float64))
                                   for c in rows["pipeline"][0]})
        out = comp.transform(pdf)
        pipe[name] = {c: out[c] for c in ("features", "features_s", "raw_prediction",
                                          "probability", "prediction")}
        for seg in comp.fused_segments:
            seg.release()
    feat = ImageFeaturizer(input_col="image", output_col="f", model_name=SERVE_ZOO,
                           repo_dir=repo, device=DEV.type)
    # one image a call: the served path's batch (one image padded to batch_size)
    zoo = [feat.transform(DataFrame.from_dict({"image": im[None]}))["f"][0]
           for im in rows[SERVE_ZOO]]
    return {"gbdt": margins, "vw": vw_card, "vw_cpu": vw_cpu, "pipeline": pipe,
            SERVE_ZOO: zoo}


def _obj(items: list) -> np.ndarray:
    a = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        a[i] = {"i": np.asarray(x["i"], np.int64), "v": np.asarray(x["v"], np.float32)}
    return a


def _pipe_equal(reply: dict, want: dict, k: int) -> bool:
    return all(np.array_equal(np.asarray(reply[c], np.asarray(want[c]).dtype), want[c][k])
               for c in want)


def _check_replies(name: str, got: dict, req: dict, want: dict) -> list:
    """The rows whose reply differs from the in-process call (empty = all
    bitwise equal)."""
    bad = []
    for k, body in zip(got["row"], got["body"]):
        r = json.loads(body)
        if name == "echo":
            ok = r == {"echo": json.loads(req["echo"][k])}
        elif name == "gbdt":
            ok = r["margin"] == float(want["gbdt"][k])
        elif name == "vw":
            ok = r["margin"] == float(np.float32(want["vw"][k])) == float(
                np.float32(want["vw_cpu"][k]))
        elif name == "pipeline":
            ok = _pipe_equal(r, want["pipeline"]["p1"], k)
        else:
            ok = np.array_equal(np.asarray(r["features"], np.float32), want[SERVE_ZOO][k])
        if not ok:
            bad.append(k)
    return sorted(set(bad))


def _zoo_request_ms(store, body: bytes) -> dict:
    """Where a ResNet-50 request's time goes, in-process on the served
    version: host decode (``prepare``: JSON -> uint8 array) and the whole
    ``execute`` (the padded batch's copy in, forward and copy out, and the
    reply's JSON encode), medians of 10; device ms, the device operations'
    summed time, from the request's trace (``_request_profile``)."""
    from mmlspark_tpu_torch.serving import CachedRequest

    mv = store.acquire(SERVE_ZOO)
    try:
        h, bs = mv.loaded.handler, mv.loaded.meta["batch_size"]
        req = CachedRequest(id="r", epoch=0, method="POST", path="/", headers={}, body=body)
        dec, exe = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            staged = h.prepare([req])
            dec.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            h.execute(staged)
            exe.append((time.perf_counter() - t0) * 1e3)
    finally:
        store.release(mv)
    traced = _request_profile(store, SERVE_ZOO, body)
    return {"decode_ms": float(np.median(dec)), "device_ms": traced["device_ms"],
            "execute_ms": float(np.median(exe)), "batch_size": bs,
            "padded_rows": bs - 1, "body_bytes": len(body), "traced": traced}


def _request_profile(store, name: str, body: bytes) -> dict:
    """One request through the served version's handler in-process, traced:
    the host's launch calls (kernels and graphs), the device operations
    and their summed device ms, and the call's wall ms (the trace's cost
    included)."""
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.serving import CachedRequest

    mv = store.acquire(name)
    try:
        req = CachedRequest(id="r", epoch=0, method="POST", path="/", headers={}, body=body)
        mv.loaded.handler([req])  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mv.loaded.handler([req])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        store.release(mv)
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e.name for e in events if e.name in _HOST_LAUNCHES]
    return {"host_launch_calls": len(host), "graph_launches": host.count("cudaGraphLaunch"),
            "device_ops": len(dev),
            "device_ms": sum(getattr(e, "device_time", 0.0) for e in dev) / 1e3,
            "traced_wall_ms": wall * 1e3}


def _hot_swap(store, port: int, bodies: list, want: dict, spec_v2: str) -> dict:
    """A client loop POSTs to ``pipeline`` while version 2 loads and warms
    (its graphs captured beside version 1's replays) and the alias flips:
    zero 5xx, zero drops, every reply version 1's or version 2's answer for
    its row, the requests after the flip version 2's; p99 of the requests
    straddling the load and the flip."""
    import http.client
    import threading

    log, errs, stop = [], [], threading.Event()

    def client() -> None:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            i = 0
            while not stop.is_set():
                k = i % len(bodies)
                t0 = time.perf_counter()
                conn.request("POST", "/models/pipeline", body=bodies[k])
                r = conn.getresponse()
                log.append((k, r.status, r.read(), t0, time.perf_counter()))
                i += 1
            conn.close()
        except BaseException as e:  # re-raised below, in the phase's thread
            errs.append(e)

    th = threading.Thread(target=client, name="serving-swap-client")
    th.start()
    time.sleep(0.3)
    t_load = time.perf_counter()
    v2 = store.load("pipeline", spec_v2, wait=True)
    t_flip = time.perf_counter()
    store.swap("pipeline", v2)
    t_done = time.perf_counter()
    time.sleep(0.3)
    stop.set()
    th.join(120)
    if errs:
        raise errs[0]
    if th.is_alive():
        raise AssertionError("hot swap: the client loop did not finish")
    fails, versions = [], []
    for k, status, body, t0, _ in log:
        if status != 200:
            fails.append(f"status {status}")
            continue
        r = json.loads(body)
        v = next((v for v in ("p1", "p1_v2") if _pipe_equal(r, want[v], k)), None)
        versions.append(v)
        if v is None:
            fails.append(f"row {k}: neither version's answer")
        elif t0 > t_done and v != "p1_v2":
            fails.append(f"row {k}: version 1 answered after the flip")
    straddle = [t1 - t0 for _, _, _, t0, t1 in log if t_load <= t0 <= t_done]
    after = [t1 - t0 for _, _, _, t0, t1 in log if t0 > t_done][:25]
    rec = {"requests": len(log), "non_200": sum(s != 200 for _, s, _, _, _ in log),
           "v1_replies": versions.count("p1"), "v2_replies": versions.count("p1_v2"),
           "load_warm_s": t_flip - t_load, "swap_ms": (t_done - t_flip) * 1e3,
           "straddling": len(straddle),
           "straddle_p99_ms": _quantiles([1e3 * s for s in straddle + after])["p99_ms"]
           if straddle + after else None}
    if not versions.count("p1") or not versions.count("p1_v2"):
        fails.append("both versions must have answered")
    if not straddle:
        fails.append("no request straddled the load and the flip")
    return {**rec, "fails": fails[:5]}


def _budget(repo: str, r50: int) -> dict:
    """A budget that fits one ResNet-50 but not two: the second version is
    refused (HBMBudgetExceeded) before anything is placed; with room for
    two, a third version evicts the least recently used non-serving one."""
    from mmlspark_tpu_torch.serving.modelstore import HBMBudgetExceeded, ModelStore

    _settle()
    a0 = torch.cuda.memory_allocated()
    one = ModelStore(budget_bytes=int(1.5 * r50), device=DEV.type, zoo_dir=repo)
    one.load("a", f"zoo:{SERVE_ZOO}")
    a1 = torch.cuda.memory_allocated()
    refused = False
    try:
        one.load("a", f"zoo:{SERVE_ZOO}")
    except HBMBudgetExceeded:
        refused = True
    _settle()
    a_refused = torch.cuda.memory_allocated()
    one.unload("a")
    two = ModelStore(budget_bytes=int(2.5 * r50), device=DEV.type, zoo_dir=repo)
    for name in ("a", "a", "b"):
        two.load(name, f"zoo:{SERVE_ZOO}")
    states = {v["version"]: v["state"] for v in two.models()["a"]["versions"]}
    resident = two.resident_bytes()
    _settle()
    a_lru = torch.cuda.memory_allocated()
    two.unload("a")
    two.unload("b")
    _settle()
    a_end = torch.cuda.memory_allocated()
    rec = {"budget_1_5x_refused": refused, "one_rise": a1 - a0, "rise_after_refusal": a_refused - a0,
           "lru_states_a": states, "lru_resident_bytes": resident, "lru_rise": a_lru - a0,
           "end_rise": a_end - a0}
    fails = []
    if not refused or not _mem_ok(a_refused - a0, r50):
        fails.append(f"one-ResNet-50 budget: refused {refused}, rise {a_refused - a0}")
    if states != {1: "ready", 2: "evicted"} or not _mem_ok(a_lru - a0, 2 * r50) \
            or resident != 2 * r50:
        fails.append(f"LRU: {states}, resident {resident}, rise {a_lru - a0}")
    if not _mem_ok(a_end - a0, 0):
        fails.append(f"after unloading: {a_end - a0} bytes left")
    return {**rec, "fails": fails}


def serving(smi: str, repo: str, gbdt_string: str, vw_serve: dict, p1: dict,
            x_test) -> dict:
    """Phase ``serving``: one WorkerServer + ModelDispatcher over a
    ModelStore on the card holding ``echo``, ``gbdt:`` (the trees/s cell's
    lossguide booster), ``vw:`` (V2's classifier, num_bits 18), ``pipeline:``
    (P1, compiled, its buckets' graphs captured in warm-up) and
    ``zoo:ResNet50``, each written the way its loader reads it. Each load's
    resident bytes against the rise of card memory; 300 sequential loopback
    POSTs a model (50 warm-up), every reply 200 and bitwise the model called
    in-process on the card (VW's margins also the CPU plain version's), p50
    and p99; where a ResNet-50 request's time goes; P1 hot-swapped under
    load; each unload's memory back; a budget of one ResNet-50. The served
    requests run with the launch counts set to 0 just before and read just
    after: ``vw_margin`` must have launched."""
    from mmlspark_tpu_torch.ops import sgd
    from mmlspark_tpu_torch.serving import WorkerServer
    from mmlspark_tpu_torch.serving.modelstore import ModelDispatcher, ModelStore

    t0 = time.perf_counter()
    d = os.path.join(ROOT, "build", "chip_smoke_serving")
    shutil.rmtree(d, ignore_errors=True)
    files = _serving_files(d, gbdt_string, vw_serve["model"], p1)
    req = _serving_requests(x_test, vw_serve["rows"], p1["cols"], np.random.default_rng(SEED))
    want = _serving_expected(req, gbdt_string, vw_serve["model"], files["models"], repo)
    _settle()
    fails = []
    store = ModelStore(device=DEV.type, zoo_dir=repo)
    loads = {}
    for name, spec in files["specs"].items():
        a0, p0 = _serve_mem()
        r0 = store.resident_bytes()
        ts = time.perf_counter()
        store.load(name, spec)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - ts
        a1, p1b = _serve_mem()
        held = store.resident_bytes() - r0
        loads[name] = {"load_s": load_s, "resident_bytes": held, "allocated_rise": a1 - a0,
                       "graph_pool_rise": p1b - p0}
        if not _mem_ok(a1 - a0 + p1b - p0, held):
            fails.append(f"{name}: resident {held} bytes, card memory rose {a1 - a0} "
                         f"+ {p1b - p0} in graph pools")
    states = {n: [v["state"] for v in m["versions"]] for n, m in store.models().items()}
    if any(s != ["ready"] for s in states.values()):
        raise AssertionError(f"serving: not every model is ready: {states}")
    srv = WorkerServer(name="chip-smoke")
    info = srv.start()
    disp = ModelDispatcher(srv, store, max_batch_size=SERVE_BUCKETS).start()
    try:
        sgd.reset_launch_counts()
        H.reset_launch_counts()
        served = {name: _post_loop(info.port, f"/models/{name}", req[name])
                  for name in files["specs"]}
        launches = {**dict(sgd.launches), **dict(H.launches)}
        lat, mismatched = {}, {}
        for name, got in served.items():
            lat[name] = {**_quantiles(got["ms"][SERVE_WARM:]),
                         "non_200": sum(s != 200 for s in got["status"])}
            if lat[name]["non_200"]:
                fails.append(f"{name}: {lat[name]['non_200']} replies were not 200")
                continue
            mismatched[name] = _check_replies(name, got, req, want)
            if mismatched[name]:
                fails.append(f"{name}: rows {mismatched[name]} differ from the in-process call")
        if launches["vw_margin"] < SERVE_REQUESTS:
            fails.append(f"the vw: requests launched vw_margin {launches['vw_margin']} times")
        zoo_ms = _zoo_request_ms(store, req[SERVE_ZOO][0])
        traced = {name: _request_profile(store, name, req[name][0])
                  for name in ("gbdt", "vw", "pipeline")}
        phase("serving", part="requests", nvidia_smi=smi, latency=lat, loads=loads,
              launches=launches, resnet50_request=zoo_ms, traced_request=traced,
              dispatcher_errors=disp.errors)
        swap = _hot_swap(store, info.port, req["pipeline"], want["pipeline"],
                         files["pipeline_v2"])
        fails += [f"hot swap: {f}" for f in swap.pop("fails")]
        phase("serving", part="hot swap", nvidia_smi=smi, **swap)
    finally:
        disp.stop()
        srv.stop()
    unloads = {}
    for name in files["specs"]:
        _settle()
        a0, p0 = _serve_mem()
        held = store.resident_bytes()
        store.unload(name)
        _settle()
        a1, p1b = _serve_mem()
        held -= store.resident_bytes()
        unloads[name] = {"resident_bytes": held, "allocated_drop": a0 - a1,
                         "graph_pool_drop": p0 - p1b}
        if not _mem_ok(a0 - a1 + p0 - p1b, held):
            fails.append(f"{name}: unload freed {a0 - a1} + {p0 - p1b}, held {held}")
    budget = _budget(repo, loads[SERVE_ZOO]["resident_bytes"])
    fails += budget.pop("fails")
    shutil.rmtree(d, ignore_errors=True)
    rec = {"unloads": unloads, "budget": budget, "mem_margin_bytes": SERVE_MEM_MARGIN,
           "mem_margin_rel": SERVE_MEM_REL, "seconds": time.perf_counter() - t0}
    phase("serving", part="memory", nvidia_smi=smi, **rec)
    if fails:
        raise AssertionError("serving: " + "; ".join(fails))
    return {"latency": lat, "launches": launches, "swap": swap, "loads": loads,
            "resnet50_request": zoo_ms, "traced_request": traced, **rec}


# -- phase distributed: ranks over torch.distributed (B4, GBDT, VW) ---------------------

DIST_WORLD = 2                      # ranks of the world-2 runs: two processes on this card
DIST_AUC_TOL = 0.005                # world-2 GBDT AUC against the one-device fit
DIST_TOP_K = 4                      # voting's K: 2K candidates of 64 features, so a split
                                    # all-reduces (2 x 64 votes + 2 x 8 x 256 x 3 cells) under a
                                    # third of data_parallel's 64 x 256 x 3 cells (at the default
                                    # K = 20, 2 x 40 x 256 x 3 cells outweigh the whole plane)
INT_LEVELS = 40                     # integer-column dataset: values 0..39 in every column
B4_SOURCE_LINES = {"plane": "791-818 _plane_histogram_shard_map (B4: B1/B2 per shard + psum)",
                   "multi": "712-736 multi_plane_histogram's _rows_sharded branch (B4: B3 "
                            "per shard + psum)"}


def int_dataset(n: int, seed: int = SEED + 20):
    """Integer-valued columns (fewer distinct values than bins, so every
    row sample gives one bin mapper) and a learnable binary label."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, INT_LEVELS, (n, D)).astype(np.float32)
    y = ((x[:, 0] - 20) * 0.1 + (x[:, 1] > 25) - (x[:, 2] % 3 == 0) * 0.5
         + rng.normal(size=n) * 0.5 > 0)
    return x, y.astype(np.float64)


def b4_data(B: int):
    """The B4 inputs at full width: uint8 bins, stats, a 0/1 mask keeping
    half the rows, slots in [0, 16] (16 dropped)."""
    bins, stats = _data(N, D, B, seed=500 + B, oob=False)
    g = torch.Generator().manual_seed(600 + B)
    mask = (torch.rand(N, generator=g) < 0.5).float()
    slot = torch.randint(0, 17, (N,), generator=g, dtype=torch.int32)
    return bins.to(torch.uint8), stats, mask, slot


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().cpu().numpy().tobytes()


def _b4_builds(group, lo: int, hi: int) -> dict:
    """The distributed planes of rows [lo, hi) over ``group``: plane B=64,
    B=256 (whole and masked), cube S=16 at B=256."""
    out = {}
    for B in (64, 256):
        bins, stats, mask, slot = (t[lo:hi].to(DEV) for t in b4_data(B))
        out[f"plane{B}"] = _bits(H.plane_histogram(bins, stats, None, B, group=group))
        if B == 256:
            out["masked256"] = _bits(H.plane_histogram(bins, stats, mask, B, group=group))
            out["multi16"] = _bits(H.multi_plane_histogram(bins, stats, slot, 16, B, group=group))
    torch.cuda.synchronize()
    return out


def _b4_one_call() -> dict:
    """The same planes from one kernel call on all the rows, each held
    bitwise against the kernels' arithmetic in PyTorch (``*_emulated``)."""
    out, bad = {}, []
    for B in (64, 256):
        bins, stats, mask, slot = (t.to(DEV) for t in b4_data(B))
        cases = {f"plane{B}": (H.plane_hist(bins, stats, None, B),
                               H.plane_histogram_emulated(bins, stats, None, B))}
        if B == 256:
            cases["masked256"] = (H.plane_hist(bins, stats, mask, B),
                                  H.plane_histogram_emulated(bins, stats, mask, B))
            cases["multi16"] = (H.multi_plane_hist(bins, stats, slot, 16, B),
                                H.multi_plane_histogram_emulated(bins, stats, slot, 16, B))
        for name, (got, want) in cases.items():
            out[name] = _bits(got)
            if out[name] != _bits(want):
                bad.append(name)
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"one kernel call on all the rows: {bad} differ from the emulation")
    return out


def _b4_rank_checks(group, lo: int, hi: int) -> dict:
    """Each fixed-scale entry on this rank's rows [lo, hi) at the scale of
    the distributed build (the ranks' maxima and row count), as the fits
    launch it: planes at B = 64 and 256, whole, half the rows masked and 3%
    masked (a small right child), and the cube S = 16. Held against its
    plain version (``_fixed_sums``, the same int64 arithmetic in PyTorch):
    max |kernel - plain| over the int64 cells, which must be 0."""
    rows = H.global_rows(hi - lo, group, DEV)
    out = {}
    for B in (64, 256):
        bins, stats, mask, slot = (t[lo:hi].to(DEV) for t in b4_data(B))
        sparse = (torch.rand(N, generator=torch.Generator().manual_seed(700 + B))
                  < 0.03).float()[lo:hi].to(DEV)
        for tag, m in (("", None), ("_masked50", mask), ("_masked3", sparse)):
            v = stats if m is None else stats * m[:, None]
            scale = H.global_scale(v, rows, group)
            got = H.plane_hist_fixed(bins, stats, m, B, scale)
            want = H._fixed_sums(bins, v, scale[:3], scale[3:].bool(), B, None, D * B)
            out[f"plane{B}{tag}"] = int((got - want).abs().max())
        if B == 256:
            ok, base = H._slot_base(bins, slot, 16, B)
            scale = H.global_scale(torch.where(ok[:, None], stats, 0.0), rows, group)
            got = H.multi_plane_hist_fixed(bins, stats, slot, 16, B, scale)
            want = H._fixed_sums(bins, stats, scale[:3], scale[3:].bool(), B, base, 16 * D * B)
            out["multi16"] = int((got.reshape(-1, 3) - want).abs().max())
    torch.cuda.synchronize()
    return out


B4_CASES = (("plane_hist_fixed (B=256)", 256, None), ("plane_hist_fixed (B=64)", 64, None),
             ("multi_plane_hist_fixed (S=16)", 256, 16))


def _b4_inputs(B: int, lo: int, hi: int):
    bins, stats, _, slot = (t[lo:hi].to(DEV) for t in b4_data(B))
    return bins, stats, slot


def _b4_kernel_times(group) -> dict:
    """World 1, all the rows: each fixed-scale kernel (ms, and device_ms
    from a CUDA graph) at the scale of the distributed build, its plain
    PyTorch version (the same fixed-point arithmetic: an int64
    ``index_add_``), one library ``index_add_`` of the precomputed
    fixed-point values, max |kernel - plain| over the int64 cells, and the
    bound: the rows' bins and stats read and the cells written, at HBM
    rate."""
    out = {}
    for name, B, S in B4_CASES:
        bins, stats, slot = _b4_inputs(B, 0, N)
        rows = H.global_rows(N, group, DEV)
        if S is None:
            scale = H.global_scale(stats, rows, group)
            kernel = lambda: H.plane_hist_fixed(bins, stats, None, B, scale)  # noqa: E731
            base, cells, kept, idx = None, D * B, N, _flat(bins, B)
        else:
            ok = slot < S
            scale = H.global_scale(torch.where(ok[:, None], stats, 0.0), rows, group)
            kernel = lambda: H.multi_plane_hist_fixed(bins, stats, slot, S, B, scale)  # noqa: E731
            base, cells, kept = torch.where(ok, slot.long() * (D * B), -1), S * D * B, int(ok.sum())
            idx = _flat(bins, B, torch.where(ok, slot.long(), 0))  # dropped rows add 0 to slot 0
        k, fin = scale[:3], scale[3:].bool()
        plain = lambda: H._fixed_sums(bins, stats, k, fin, B, base, cells)  # noqa: E731
        q = H._to_fixed(stats, k, fin)
        if S is not None:
            q = torch.where(ok[:, None], q, 0)
        src = q[:, None, :].expand(N, D, 3).reshape(-1).contiguous()
        lib_out = torch.zeros(cells * 3, dtype=torch.int64, device=DEV)
        library = lambda: lib_out.zero_().index_add_(0, idx, src)  # noqa: E731
        err = float((kernel().reshape(-1, 3) - plain()).abs().max())
        if err != 0:
            raise AssertionError(f"{name}: the int64 cells differ from the plain version by {err}")
        rec = _timed(kernel, plain, library, kept * (D + 12) + (N * 4 if S else 0) + cells * 24,
                     kept * D * 3)
        rec.update(max_abs_err=err, rows=N, rows_kept=kept, cells=cells * 3,
                   allreduce_bytes=cells * 24)
        out[name] = rec
    return out


def _host_ms(fn, iters: int = 10) -> float:
    """ms per call on the host clock: ``iters`` calls after a warm-up,
    ending in a synchronise (a gloo collective is host-staged and
    synchronous; an NCCL one is timed the same way to compare)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _b4_reduce_times(group, lo: int, hi: int) -> dict:
    """A rank's all-reduce of the int64 cells and its whole distributed
    build (two small all-reduces, the kernel, the cells), all ranks
    together."""
    from mmlspark_tpu_torch.parallel import collectives

    out = {}
    for name, B, S in B4_CASES:
        bins, stats, slot = _b4_inputs(B, lo, hi)
        build = ((lambda: H.plane_histogram(bins, stats, None, B, group=group)) if S is None
                 else (lambda: H.multi_plane_histogram(bins, stats, slot, S, B, group=group)))
        acc = torch.zeros((S or 1) * D * B * 3, dtype=torch.int64, device=DEV)
        out[name] = {"allreduce_ms": _host_ms(lambda: collectives.allreduce_sum(acc, group)),
                     "build_ms": _host_ms(build)}
    return out


def _b4_kernel_times_local(lo: int, hi: int) -> dict:
    """This rank's fixed-scale kernels alone on its rows (the scale from
    its own rows: the time does not depend on it)."""
    out = {}
    for name, B, S in B4_CASES:
        bins, stats, slot = _b4_inputs(B, lo, hi)
        k, fin = H._fixed_scale(stats, N)
        scale = torch.cat([k, fin.long()])
        fn = ((lambda: H.plane_hist_fixed(bins, stats, None, B, scale)) if S is None
              else (lambda: H.multi_plane_hist_fixed(bins, stats, slot, S, B, scale)))
        ms, device_ms = time_ms(fn)
        out[name] = {"rank_ms": ms, "rank_device_ms": device_ms}
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def b4_world1() -> dict:
    """World 1 under NCCL, in this process: the distributed builds on all
    200,000 rows bitwise one kernel call on them, and the per-rank times."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{_free_port()}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"world 1 ran on {dist.get_backend()}, not NCCL")
        got, want = _b4_builds(dist.group.WORLD, 0, N), _b4_one_call()
        bad = sorted(k for k in want if got[k] != want[k])
        bad += sorted(k for k, e in _b4_rank_checks(dist.group.WORLD, 0, N).items() if e)
        if bad:
            raise AssertionError(f"world 1 (NCCL): {bad} differ from one kernel call or "
                                 "from the plain version")
        together = _b4_reduce_times(dist.group.WORLD, 0, N)
        times = {k: {**v, **together[k]} for k, v in _b4_kernel_times(dist.group.WORLD).items()}
    finally:
        dist.destroy_process_group()
    phase("distributed", part="B4 world 1 (NCCL)", rows=N, d=D, bitwise_one_call=True,
          **{k: {f: v[f] for f in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                                   "allreduce_ms", "build_ms", "max_abs_err")}
             for k, v in times.items()})
    return {"times": times, "one_call": want}


def _counted(fit, trace: bool = True) -> "tuple[object, dict]":
    """``fit()`` on this rank's rows, with the launch and collective counts
    at 0 just before, under torch.profiler if ``trace``: its result, and
    its seconds (with ``trace`` the profiler's cost during the fit
    included; ``trace_s``: stopping the profiler and counting its events,
    after), the wrappers' launches, the trace's ``hist_kernel`` events and
    the collectives' calls, elements and bytes by operation."""
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.parallel import collectives

    torch.cuda.synchronize()
    H.reset_launch_counts()
    collectives.reset_counts()
    with (profile(activities=[ProfilerActivity.CUDA]) if trace
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        out = fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    rec = {"fit_s": fit_s, "traced": trace, "launches": dict(H.launches),
           "collectives": {k: dict(v) for k, v in collectives.counts.items()}}
    if trace:
        rec["traced_launches"] = traced_launches(prof)
        rec["trace_s"] = time.perf_counter() - t0 - fit_s
    return out, rec


def _fit_rec(est, train_df, x_test, y_test, trace: bool = True) -> dict:
    """Fit on this rank's rows (``_counted``); the model string, trees/s,
    held-out AUC, the fixed-scale kernels' launches, wrappers' and traced,
    and the elements and bytes all-reduced per split."""
    model, rec = _counted(lambda: est.fit(train_df), trace)
    counts = {k: sum(v.values()) for k, v in rec["collectives"].items()}
    trees = model.booster.trees
    splits = int(sum(int(np.sum(t.active)) for t in trees))
    rec.update(trees=len(trees), trees_per_s=len(trees) / rec["fit_s"], splits=splits,
               allreduce_elements_per_split=counts.get("elements", 0) / max(splits, 1),
               allreduce_bytes_per_split=counts.get("bytes", 0) / max(splits, 1),
               model=model.get("model_string"))
    if x_test is not None:
        rec.update(classifier_score(x_test, y_test)(model))
    return rec


# the fits that need all the rows' state beyond the histograms (A4 step 1b): each runs
# at world 2 on the integer columns and once on one device on all the rows:
# name -> (label, TrainConfig fields, how train is called)
DIST_QUERY = 20                     # documents a query (lambdarank): 10,000 queries
# 5 rounds, not the trees/s cell's 20: depth cut for the script's time (twenty traced
# rounds of every fit would add ~270 s, each traced world-2 fit waits ~10 s more on the
# profiler; cut from 10 when phases online, tune and chaos came). The early-stopping
# fits keep 10: they stop after their 6th and 7th rounds, and must stop (``check_ranks``)
DIST_BASE = dict(num_iterations=5, num_leaves=63, min_data_in_leaf=20, seed=0, max_bin=63)
DIST_ES_ROUNDS = 10
# the trees/s cell's fits and the integer fit at world 2 (and their one-device
# references): 10 rounds, not the cell's 20, a depth cut for the script's time
DIST_MAIN_ROUNDS = 10
_DIST_ES = dict(learning_rate=0.6, early_stopping_round=2, metric="auc",
                num_iterations=DIST_ES_ROUNDS)
DIST_FITS = {
    "goss": ("binary", dict(boosting_type="goss"), {}),
    "dart": ("binary", dict(boosting_type="dart"), {}),
    "early_stopped": ("binary", _DIST_ES, {"valid": True}),
    "quantile": ("regression", dict(objective="quantile", alpha=0.9), {}),
    "mape": ("regression", dict(objective="mape"), {}),
    "lambdarank": ("rank", dict(objective="lambdarank"), {}),
    "lambdarank_es": ("rank", dict(objective="lambdarank", learning_rate=0.3,
                                   early_stopping_round=2, num_iterations=DIST_ES_ROUNDS),
                      {"valid": True}),
    "continued": ("binary", dict(seed=1), {"init": True}),
    "csr": ("binary", {}, {"csr": True}),
    "fused": ("binary", {}, {"fused_rounds": 4}),
}
# where one device bins differently by design, its model is not the ranks': AUC instead
DIST_BINS_DIFFER = {"csr": "one device fits CSR bins on the stored values alone, the ranks "
                           "on their all-gathered densified sample (absent entries NaN), "
                           "as the JAX package's multi-process branch does"}


def dist_fit_data(n: int = N, seed: int = SEED + 20) -> dict:
    """``int_dataset``'s rows with the labels and row sets of ``DIST_FITS``:
    a regression target (positive, for mape), relevance 0-4, queries of
    ``DIST_QUERY`` rows (whole inside a rank's block), a validation mask of
    every fifth query, and the columns' values below 4 made absent (CSR)."""
    x, y = int_dataset(n, seed)
    rng = np.random.default_rng(seed + 1)
    noise = rng.normal(size=n)
    gid = np.arange(n) // DIST_QUERY
    return {"x": x, "binary": y,
            "regression": (x[:, 0] * 0.5 + (x[:, 1] > 25) * 4.0 - (x[:, 2] % 3 == 0) * 2.0
                           + noise + 10.0),
            "rank": np.clip(np.round(x[:, 0] / 10 + (x[:, 1] > 25) + noise * 0.5), 0, 4),
            "gid": gid, "valid": gid % 5 == 4,
            "x_csr": np.where(x < 4, 0.0, x).astype(np.float32)}


def _dist_train(name: str, data: dict, lo: int, hi: int, init: "Booster | None"):
    """One fit of ``DIST_FITS`` on rows lo:hi through ``train`` on the card."""
    import scipy.sparse as sp

    label, cfg, how = DIST_FITS[name]
    kw: dict = {"device": "cuda"}
    if how.get("valid"):
        kw["valid_mask"] = data["valid"][lo:hi]
    if label == "rank":
        kw["group_ids"] = data["gid"][lo:hi] - data["gid"][lo]   # the rank's own query ids
    if how.get("init"):
        kw["init_booster"] = init
    if how.get("fused_rounds"):
        kw["fused_rounds"] = how["fused_rounds"]
    x = sp.csr_matrix(data["x_csr"][lo:hi]) if how.get("csr") else data["x"][lo:hi]
    return train(x, data[label][lo:hi], TrainConfig(**{**DIST_BASE, **cfg}), **kw)


def _dist_rounds(name: str, booster, init: "Booster") -> int:
    """The trees a fit of ``DIST_FITS`` grew and kept (a continued fit's model
    holds init's too): its rounds, all its classes being one."""
    return len(booster.trees) - (len(init.trees) if DIST_FITS[name][2].get("init") else 0)


def _dist_auc(name: str, booster, x_test, y_test) -> "float | None":
    """Held-out AUC of a binary fit of ``DIST_FITS`` (CSR: absent entries NaN)."""
    if DIST_FITS[name][0] != "binary":
        return None
    if DIST_FITS[name][2].get("csr"):
        x_test = np.where(x_test < 4, np.nan, x_test).astype(np.float32)
    return binary_auc(y_test, booster.predict_raw(x_test, device="cuda"))


def dist_new_fits(lo: int, hi: int, init: "Booster", base_gather: int) -> dict:
    """Every fit of ``DIST_FITS`` on this rank's rows lo:hi (``_counted``):
    its model string, best iteration, trees grown and kept a second,
    held-out AUC, launches (wrappers' and traced) and the bytes its
    all-gathers move beyond ``base_gather``, the plain integer fit's (the
    bin mapper's sample, the row counts), a kept tree."""
    data = dist_fit_data()
    x_test, y_test = int_dataset(N_TEST, SEED + 21)
    out = {}
    for name in DIST_FITS:
        booster, rec = _counted(lambda: _dist_train(name, data, lo, hi, init))
        rounds = _dist_rounds(name, booster, init)
        gathered = rec["collectives"]["bytes"].get("all_gather", 0)
        rec.update(trees=rounds, trees_per_s=rounds / rec["fit_s"],
                   best_iteration=booster.best_iteration, model=booster.to_model_string(),
                   auc=_dist_auc(name, booster, x_test, y_test),
                   new_gather_bytes_per_round=(gathered - base_gather) / max(rounds, 1))
        out[name] = rec
    return out


def vw_v2_block(rank: int, world: int) -> dict:
    """V2's pipeline (``vw_v2``) fitted on this rank's block of the 80,000
    training texts (every rank of a group fits its own; with two or more
    ranks the learner averages the weights after every pass): held-out
    AUC on the 20,000 others, the fit's seconds and the weights."""
    from mmlspark_tpu_torch import Pipeline
    from mmlspark_tpu_torch.featurize import IndexToValue, ValueIndexer
    from mmlspark_tpu_torch.stages import UnicodeNormalize
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier, VowpalWabbitFeaturizer

    texts, _ = vw_texts()
    score = vw_planted(texts)
    noise = np.random.default_rng(7).normal(size=len(texts)) * 1.0
    labels = np.where(score + noise > 0, "pos", "neg").astype(object)
    n_fit = len(texts) - VW_HOLDOUT
    per = n_fit // world
    block = slice(rank * per, (rank + 1) * per)
    t0 = time.perf_counter()
    model = Pipeline(stages=[
        UnicodeNormalize(input_col="text", output_col="norm"),
        ValueIndexer(input_col="label_str", output_col="label"),
        VowpalWabbitFeaturizer(input_cols=[], string_split_input_cols=["norm"],
                               num_bits=VW_BITS),
        VowpalWabbitClassifier(num_passes=3, batch_size=1024, device="cuda"),
        IndexToValue(input_col="label", output_col="label_back"),
    ]).fit(DataFrame.from_dict({"text": texts[block], "label_str": labels[block]}))
    fit_s = time.perf_counter() - t0
    prob = model.transform(DataFrame.from_dict(
        {"text": texts[n_fit:], "label_str": labels[n_fit:]}))["probability"]
    w = np.asarray(model.stages[3].get("weights"), np.float32)
    return {"auc": binary_auc((labels[n_fit:] == "pos").astype(np.float64), prob),
            "fit_s": fit_s, "rows_fit": per, "weights": w.tobytes()}


def _dist_rank_work(rank: int, world: int) -> dict:
    """What each rank of a group runs on its block of the rows: B4's
    builds, its fixed-scale entries against their plain version and their
    times, the trees/s cell's fits, the integer-column fit, the fits of
    ``DIST_FITS`` on the integer columns (continuing the integer fit's
    model) and V2."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel import cluster_summary, make_mesh

    g = dist.group.WORLD
    per = N // world
    lo, hi = rank * per, (rank + 1) * per
    out = {"backend": dist.get_backend(), "summary": cluster_summary(make_mesh()),
           "b4": _b4_builds(g, lo, hi), "b4_fixed_err": _b4_rank_checks(g, lo, hi)}
    times = {}
    for r in range(world):  # one rank at a time (the ranks may share a card)
        dist.barrier()
        if r == rank:
            times = _b4_kernel_times_local(lo, hi)
    dist.barrier()
    # the all-reduce and the whole build, all ranks together
    together = _b4_reduce_times(g, lo, hi)
    out["b4_times"] = {k: {**times[k], **together[k]} for k in together}

    x_all, y_all = dataset(N + N_TEST)
    x, y, x_test, y_test = x_all[lo:hi], y_all[lo:hi], x_all[N:], y_all[N:]
    tr = DataFrame.from_dict({"features": x, "label": y})
    kw = dict(num_iterations=DIST_MAIN_ROUNDS, num_leaves=63, min_data_in_leaf=20, seed=0,
              device="cuda")
    fits = {}
    for name, extra in (("lossguide", {}), ("depthwise", {"growth_policy": "depthwise"}),
                        ("voting", {"parallelism": "voting_parallel", "top_k": DIST_TOP_K})):
        # traced: the fits behind the B4 entries' launches (voting's are lossguide's)
        fits[name] = _fit_rec(LightGBMClassifier(**kw, **extra), tr, x_test, y_test,
                              trace=name != "voting")
    xi, yi = int_dataset(N)
    fits["integer_b64"] = _fit_rec(LightGBMClassifier(**kw, max_bin=63), DataFrame.from_dict(
        {"features": xi[lo:hi], "label": yi[lo:hi]}), None, None)
    out["fits"] = fits
    base_gather = fits["integer_b64"]["collectives"]["bytes"].get("all_gather", 0)
    out["new_fits"] = dist_new_fits(lo, hi, Booster.from_model_string(
        fits["integer_b64"]["model"]), base_gather)
    out["vw"] = vw_v2_block(rank, world)
    return out


def _dist_rank(rank: int, world: int, rdv: str, out_path: str, backend: str,
               card_per_rank: bool) -> None:
    """A spawned rank: joins the group (``file://`` rendezvous at ``rdv``)
    on card ``rank`` (``card_per_rank``) or all on card 0 (NCCL refuses two
    ranks on one card: gloo there) and writes its result for the parent."""
    import pickle

    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{rdv}", world, rank,
                           device=f"cuda:{rank if card_per_rank else 0}", backend=backend)
    try:
        res = _dist_rank_work(rank, world)
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, backend: str, card_per_rank: bool) -> "tuple[list, float]":
    """Spawns ``world`` ranks (``_dist_rank``) and waits for them: their
    results in rank order, and the seconds from spawn to the last exit. Its
    scratch directory under build/ is removed after."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        mp.spawn(_dist_rank, args=(world, os.path.join(tmp, "rdv"), os.path.join(tmp, "out"),
                                   backend, card_per_rank), nprocs=world, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"out.{r}"), "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ranks, spawn_s


def check_ranks(ranks: list, ref: dict) -> "tuple[list, dict]":
    """The ranks' results against the one-device references ``ref``
    (``backend``; ``one_call``: B4's planes of one kernel call; ``auc``:
    the lossguide and depthwise fits' held-out AUC; ``integer``: the
    integer-column model string; ``vw_auc``: V2's AUC): every plane
    bitwise one call, every fixed-scale entry bitwise its plain version,
    the fits' AUC at least 0.90 and within DIST_AUC_TOL, every rank's
    models byte-identical, voting's bytes a split under a third of
    data_parallel's, the integer model equal to one device's, V2 within
    VW_AUC_TOL, and every fixed-scale entry launched by its fit; ``new``:
    each fit of ``DIST_FITS`` on one device (model string, best
    iteration, AUC), which every rank's must equal byte for byte, best
    iteration included (where one device bins differently by design,
    ``DIST_BINS_DIFFER``, an AUC at least 0.90 and within DIST_AUC_TOL of
    it, the reason recorded), each having launched ``plane_hist_fixed``
    (the wrappers' count, and seen by the trace), and each early-stopping
    fit stopped before its ``num_iterations`` on every rank and on one
    device. Returns (the failures, the record)."""
    fails = []
    if any(res["backend"] != ref["backend"] for res in ranks):
        fails.append(f"not every rank ran {ref['backend']}")
    for r, res in enumerate(ranks):
        bad = sorted(k for k in ref["one_call"] if res["b4"][k] != ref["one_call"][k])
        if bad:
            fails.append(f"rank {r}: B4 {bad} differ from one kernel call")
        bad = sorted(k for k, e in res["b4_fixed_err"].items() if e)
        if bad:
            fails.append(f"rank {r}: fixed-scale entries {bad} differ from the plain version")
    fits = {}
    for name, one in (("lossguide", "lossguide"), ("depthwise", "depthwise"),
                      ("voting", "lossguide"), ("integer_b64", None)):
        f = ranks[0]["fits"][name]
        same = all(res["fits"][name]["model"] == f["model"] for res in ranks)
        fits[name] = {k: v for k, v in f.items() if k != "model"}
        fits[name]["ranks_identical"] = same
        if not same:
            fails.append(f"{name}: the ranks' models differ")
        if one is None:
            fits[name]["model_equals_one_device"] = f["model"] == ref["integer"]
            if f["model"] != ref["integer"]:
                fails.append("integer columns: the model differs from the one-device model")
            continue
        fits[name]["one_device_auc"] = ref["auc"][one]
        if not (f["auc"] >= 0.90 and abs(f["auc"] - ref["auc"][one]) <= DIST_AUC_TOL):
            fails.append(f"{name}: AUC {f['auc']} against one device {ref['auc'][one]}")
    vote_b, dp_b = (fits[k]["allreduce_bytes_per_split"] for k in ("voting", "lossguide"))
    if not vote_b < dp_b / 3:
        fails.append(f"voting moves {vote_b} bytes a split, data_parallel {dp_b}")
    for fit, kernel in (("lossguide", "plane_hist_fixed"), ("integer_b64", "plane_hist_fixed"),
                        ("depthwise", "multi_plane_hist_fixed")):
        if fits[fit]["launches"].get(kernel, 0) == 0:
            fails.append(f"the {fit} fit never launched {kernel}")
    new_fits = {}
    for name, one in ref["new"].items():
        f = ranks[0]["new_fits"][name]
        same = all((res["new_fits"][name]["model"], res["new_fits"][name]["best_iteration"])
                   == (f["model"], f["best_iteration"]) for res in ranks)
        rec = {k: v for k, v in f.items() if k != "model"}
        rec.update(ranks_identical=same, model_equals_one_device=f["model"] == one["model"],
                   one_device_best_iteration=one["best_iteration"],
                   one_device_auc=one["auc"], one_device_fit_s=one["fit_s"])
        if not same:
            fails.append(f"{name}: the ranks' models differ")
        if name in DIST_BINS_DIFFER and not rec["model_equals_one_device"]:
            rec["compared_by_auc"] = DIST_BINS_DIFFER[name]
            if not (f["auc"] >= 0.90 and abs(f["auc"] - one["auc"]) <= DIST_AUC_TOL):
                fails.append(f"{name}: AUC {f['auc']} against one device {one['auc']}")
        elif not (rec["model_equals_one_device"]
                  and f["best_iteration"] == one["best_iteration"]):
            fails.append(f"{name}: the model (best iteration {f['best_iteration']}) differs "
                         f"from the one-device model (best iteration {one['best_iteration']})")
        cap = {**DIST_BASE, **DIST_FITS[name][1]}
        if cap.get("early_stopping_round"):
            # the stop itself: every rank and one device cut the fit before its cap
            ran = [res["new_fits"][name]["trees"] for res in ranks] + [one["trees"]]
            rec.update(num_iterations=cap["num_iterations"], one_device_trees=one["trees"])
            if not all(t < cap["num_iterations"] for t in ran):
                fails.append(f"{name}: no early stop within {cap['num_iterations']} rounds "
                             f"(trees: ranks and one device {ran})")
        # the wrappers count every launch; the trace of a world-2 fit can drop a
        # few kernel records (CUPTI's buffers under load), so it only has to see
        # the kernel, and what it missed is recorded
        wrapped = f["launches"].get("plane_hist_fixed", 0)
        traced = f["traced_launches"]["plane_hist"]
        rec["trace_missed"] = max(wrapped - traced, 0)
        if not (wrapped > 0 and traced > 0):
            fails.append(f"{name}: plane_hist_fixed launched {wrapped} times, traced {traced}")
        new_fits[name] = rec
    vw2 = ranks[0]["vw"]
    vw_same = all(res["vw"]["weights"] == vw2["weights"] for res in ranks)
    if not (vw_same and abs(vw2["auc"] - ref["vw_auc"]) <= VW_AUC_TOL):
        fails.append(f"VW V2: AUC {vw2['auc']} against {ref['vw_auc']}, ranks equal {vw_same}")
    rec = {"backend": ref["backend"], "ranks": len(ranks), "summary": ranks[0]["summary"],
           "rows_per_rank": N // len(ranks),
           "b4_bitwise_one_call": not any("B4" in f for f in fails),
           "b4_fixed_err": {f"rank{r}": res["b4_fixed_err"] for r, res in enumerate(ranks)},
           "b4": {name: {f"rank{r}": res["b4_times"][name] for r, res in enumerate(ranks)}
                  for name in ranks[0]["b4_times"]},
           "fits": fits, "new_fits": new_fits,
           "vw_v2": {"auc": vw2["auc"], "one_device_auc": ref["vw_auc"],
                     "ranks_identical": vw_same, "fit_s": vw2["fit_s"],
                     "rows_fit_per_rank": vw2["rows_fit"]}}
    return fails, rec


def dist_one_device(init: "Booster") -> dict:
    """Every fit of ``DIST_FITS`` on one device on all the rows: model
    string, best iteration, trees kept, held-out AUC and seconds."""
    data = dist_fit_data()
    x_test, y_test = int_dataset(N_TEST, SEED + 21)
    out = {}
    for name in DIST_FITS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster = _dist_train(name, data, 0, N, init)
        torch.cuda.synchronize()
        out[name] = {"model": booster.to_model_string(), "best_iteration": booster.best_iteration,
                     "fit_s": time.perf_counter() - t0, "trees": _dist_rounds(name, booster, init),
                     "auc": _dist_auc(name, booster, x_test, y_test)}
    return out


def distributed_phase(x, y, x_test, y_test, vw_rec: dict) -> dict:
    """Phase ``distributed``: B4 at world 1 under NCCL here, then two gloo
    ranks on this card (spawned processes, 100,000 rows each) held by
    ``check_ranks`` against one-device fits here of the same depth
    (DIST_MAIN_ROUNDS; ``DIST_FITS``'s own) and V2's fit of phase ``vw``."""
    t0 = time.perf_counter()
    w1 = b4_world1()
    kw = dict(num_iterations=DIST_MAIN_ROUNDS, num_leaves=63, min_data_in_leaf=20, seed=0,
              device="cuda")
    score = classifier_score(x_test, y_test)
    one_auc = {p: score(LightGBMClassifier(**kw, **extra).fit(
        DataFrame.from_dict({"features": x, "label": y})))["auc"]
        for p, extra in (("lossguide", {}), ("depthwise", {"growth_policy": "depthwise"}))}
    xi, yi = int_dataset(N)
    one_int = LightGBMClassifier(**kw, max_bin=63).fit(
        DataFrame.from_dict({"features": xi, "label": yi})).get("model_string")
    new = dist_one_device(Booster.from_model_string(one_int))
    ranks, spawn_s = spawn_ranks(DIST_WORLD, "gloo", card_per_rank=False)
    fails, rec = check_ranks(ranks, {
        "backend": "gloo", "one_call": w1["one_call"], "integer": one_int,
        "auc": one_auc,
        "vw_auc": vw_rec["V2"]["auc"], "new": new})
    phase("distributed", part="world 2 (gloo, one card)", spawn_s=spawn_s, **rec,
          seconds=time.perf_counter() - t0)
    if fails:
        raise AssertionError("; ".join(fails))
    return {"world1": w1["times"], "world2": rec["b4"], "fits": rec["fits"],
            "new_fits": rec["new_fits"]}


# -- phase elastic: the elastic gang (fleet registry + fleet train members) ------------

ELASTIC_ROUNDS = 8                  # the gang's fits: depth cut from 20 (10, then 8 for time)
ELASTIC_HEARTBEAT_S = 1.0           # a member's beat; a member busy in a round still beats
ELASTIC_TTL_S = 5.0                 # the registry drops a member silent this long
ELASTIC_KILL_ROUND = 4              # the drill's victim stalls entering this round
ELASTIC_TIMEOUT_S = 300             # a gang's members must all exit within this
ELASTIC_TOP_K = 4                   # voting's K: 2K = 8 candidate columns of 64 a split
ELASTIC_VOTE_RATIO = 0.5            # voting's payload a member under this share of the full gang's
ELASTIC_AUC_TOL = 0.02              # voting's held-out AUC against the full gang's
STREAM_SPEC = f"stream-synth:{N}x{D}:{SEED}:65536"   # the trees/s cell's shape, streamed


def elastic_cfg(policy: str) -> TrainConfig:
    """The fit every member of ``fleet train`` makes (its flags below)."""
    return TrainConfig(objective="binary", num_iterations=ELASTIC_ROUNDS, num_leaves=63,
                       learning_rate=0.1, min_data_in_leaf=20, seed=0, max_bin=255,
                       growth_policy=policy)


_ELASTIC_PROCS: list = []          # every member spawned: elastic_phase kills what outlives it


def _elastic_member(reg_url: str, tmp: str, name: str, world: int, policy: str, mode: str,
                    service: str, fault: "str | None" = None, extra: tuple = (),
                    data: "str | None" = None, ckpt: "str | None" = None):
    """One ``fleet train`` process (this checkout's port, on ``DEV``);
    its stderr goes to ``<tmp>/err-<name>.txt``. ``data``: the spec (the
    npz rows by default); ``ckpt``: its checkpoint dir (the service's by
    default, shared by the gang)."""
    argv = [sys.executable, "-m", "mmlspark_tpu_torch.serving.fleet"]
    if fault:
        argv += ["--fault-plan", fault]
    argv += ["train", "--registry", reg_url, "--name", name,
             "--data", data or f"npz:{os.path.join(tmp, 'data.npz')}",
             "--ckpt-dir", ckpt or os.path.join(tmp, f"ck-{service}"),
             "--world-size", str(world),
             "--partitions", "8", "--num-iterations", str(ELASTIC_ROUNDS), "--num-leaves", "63",
             "--learning-rate", "0.1", "--min-data-in-leaf", "20", "--seed", "0",
             "--growth-policy", policy, "--reduce-mode", mode, "--checkpoint-every", "2",
             "--heartbeat-s", str(ELASTIC_HEARTBEAT_S), "--service-name", service,
             "--device", DEV.type, "--no-growback",
             "--out-model", os.path.join(tmp, f"model-{name}.txt"),
             "--status-file", os.path.join(tmp, f"status-{name}.json"), *extra]
    env = dict(os.environ, PYTHONPATH=ROOT)
    with open(os.path.join(tmp, f"err-{name}.txt"), "w") as err:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)
    _ELASTIC_PROCS.append(proc)
    return proc


def _elastic_wait(procs: dict, tmp: str, t0: float) -> dict:
    """Each member's exit: name -> {model, status}, and ``wall_s`` (spawn to
    the last exit). A member that fails raises with its stderr's tail."""
    out = {}
    for name, p in procs.items():
        try:
            rc = p.wait(timeout=ELASTIC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        if rc != 0:
            with open(os.path.join(tmp, f"err-{name}.txt")) as f:
                raise AssertionError(f"elastic member {name} exited {rc}: {f.read()[-3000:]}")
        with open(os.path.join(tmp, f"model-{name}.txt")) as f:
            model = f.read()
        with open(os.path.join(tmp, f"status-{name}.json")) as f:
            out[name] = {"model": model, "status": json.load(f)}
    return {"members": out, "wall_s": time.perf_counter() - t0}


def _member_rec(m: dict, kernel: str) -> dict:
    """What a member's status says of its fit: seconds, trees/s, its
    kernel's launches (a tree's too), the reducer's calls, bytes and
    seconds (a histogram build's: the scale's max and the cells' sum)."""
    st = m["status"]
    fit_s, launched = sum(st["fit_s"]), st["launches"].get(kernel, 0)
    return {"fit_s": fit_s, "trees_per_s": ELASTIC_ROUNDS / fit_s, "launches": st["launches"],
            "launches_per_tree": launched / ELASTIC_ROUNDS, "payload_bytes": st["payload_bytes"],
            "allreduce_ops": st["allreduce_ops"], "allreduce_s": st["allreduce_s"],
            "reducer_s_per_build": st["allreduce_s"] / max(launched, 1),
            "gen": st["gen"], "members": st["members"], "device": st["device"],
            "hist_lowering": st["hist_lowering"], "vote_rounds": st["vote_rounds"],
            "ingest_s": st["ingest_s"], "ingest_payload_bytes": st["ingest_payload_bytes"],
            "peak_rss_bytes": st["peak_rss_bytes"]}


def _gang_spawn(reg_url: str, tmp: str, policy: str, mode: str, world: int = 2,
                tag: "str | None" = None, extra: tuple = (), data: "str | None" = None) -> dict:
    """Spawns a world-``world`` gang's members (``_gang_end`` waits for them)."""
    tag = tag or f"{policy}-{mode}"
    names = [f"{tag}-{chr(ord('a') + i)}" for i in range(world)]
    return {"tag": tag, "policy": policy, "world": world, "t0": time.perf_counter(),
            "procs": {n: _elastic_member(reg_url, tmp, n, world, policy, mode, tag, extra=extra,
                                         data=data) for n in names}}


def _gang_end(gang: dict, tmp: str, one: "str | None", fails: list) -> dict:
    """A gang of ``_gang_spawn`` to its end: its members' models equal each
    other and ``one`` (the one-device fit; None: no such check), each
    launched its fixed-scale kernel (``plane_hist`` at world 1); the
    record of each member."""
    tag, world = gang["tag"], gang["world"]
    kernel = "multi_plane_hist_fixed" if gang["policy"] == "depthwise" else "plane_hist_fixed"
    if world == 1:
        kernel = kernel.replace("_fixed", "")
    got = _elastic_wait(gang["procs"], tmp, gang["t0"])
    models = {m["model"] for m in got["members"].values()}
    rec = {"world": world, "wall_s": got["wall_s"], "members_identical": len(models) == 1,
           "equals_one_device": None if one is None else models == {one},
           "member": {n: _member_rec(m, kernel) for n, m in got["members"].items()}}
    if not rec["members_identical"]:
        fails.append(f"{tag}: the members' models differ")
    if one is not None and not rec["equals_one_device"]:
        fails.append(f"{tag}: the gang's model differs from the one-device fit")
    for n, m in rec["member"].items():
        if m["launches"].get(kernel, 0) == 0:
            fails.append(f"{tag}: member {n} never launched {kernel}")
    rec["model"] = next(iter(models))
    return rec


def _kill_at_checkpoint(latest: str, a, b, t0: float, what: str) -> None:
    """Wait until ``latest`` names round ELASTIC_KILL_ROUND's checkpoint (b
    then stalls entering that round), give a a second to enter the round's
    first allreduce, and SIGKILL b."""
    want = f"round-{ELASTIC_KILL_ROUND:07d}"
    while True:
        with contextlib.suppress(OSError):
            with open(latest) as f:
                if f.read().strip() == want:
                    break
        if b.poll() is not None or a.poll() is not None or \
                time.perf_counter() - t0 > ELASTIC_TIMEOUT_S:
            a.kill()
            b.kill()
            raise AssertionError(f"{what}: no {want} checkpoint (a {a.poll()}, b {b.poll()})")
        time.sleep(0.1)
    time.sleep(1.0)
    b.kill()
    b.wait()


def _elastic_drill(reg_url: str, tmp: str, one: str, fails: list) -> dict:
    """The host-loss drill: b stalls entering round ELASTIC_KILL_ROUND (the
    round-4 checkpoint written) and is SIGKILLed while a waits in that
    round's first allreduce; a detects the loss, reshards to world 1 from a
    snapshot of the checkpoint and finishes. Its booster must equal a fresh
    world-1 run from that snapshot and the one-device fit."""
    stall = json.dumps({"rules": [{"point": "gbdt.round", "at": [ELASTIC_KILL_ROUND],
                                   "delay_s": 600}]})
    ck = os.path.join(tmp, "ck-drill")
    t0 = time.perf_counter()
    a = _elastic_member(reg_url, tmp, "drill-a", 2, "lossguide", "ring", "drill")
    b = _elastic_member(reg_url, tmp, "drill-b", 2, "lossguide", "ring", "drill", fault=stall)
    _kill_at_checkpoint(os.path.join(ck, "LATEST"), a, b, t0, "drill")
    t_kill = time.perf_counter()
    survivor = _elastic_wait({"drill-a": a}, tmp, t0)["members"]["drill-a"]
    kill_to_done_s = time.perf_counter() - t_kill
    st = survivor["status"]
    snap = st["snapshot"]
    ok = (st["reshards"] == 1 and st["members"] == ["drill-a"] and st["gen"] == 2
          and st["resume_round"] == ELASTIC_KILL_ROUND and bool(snap))
    if not ok:
        fails.append(f"drill: the survivor did not reshard to world 1 at round "
                     f"{ELASTIC_KILL_ROUND}: {st}")
        return {"status": st}
    t1 = time.perf_counter()
    fresh = _elastic_wait({"drill-fresh": _elastic_member(
        reg_url, tmp, "drill-fresh", 1, "lossguide", "ring", "drill-fresh",
        extra=("--resume-from", snap))}, tmp, t1)["members"]["drill-fresh"]
    rec = {"kill_round": ELASTIC_KILL_ROUND, "detect_latency_s": st["detect_latency_s"],
           "reshard_to_first_round_s": st["reshard_to_first_round_s"],
           "kill_to_done_s": kill_to_done_s, "resume_round": st["resume_round"],
           "rounds_per_s_pre": st["rounds_per_s_pre"], "rounds_per_s_post": st["rounds_per_s_post"],
           "survivor_launches": st["launches"], "fresh_launches": fresh["status"]["launches"],
           "equals_fresh_from_snapshot": survivor["model"] == fresh["model"],
           "equals_one_device": survivor["model"] == one,
           "fresh_fit_s": sum(fresh["status"]["fit_s"])}
    if not rec["equals_fresh_from_snapshot"]:
        fails.append("drill: the survivor's booster differs from a fresh world-1 run "
                     "from its snapshot")
    if not rec["equals_one_device"]:
        fails.append("drill: the survivor's booster differs from the one-device fit")
    return rec


def _voting_spawn(reg_url: str, tmp: str) -> dict:
    """World 2 over the ring in voting mode (``--tree-parallelism voting
    --top-k 4``) on the npz rows (``_voting_gang`` checks it)."""
    return _gang_spawn(reg_url, tmp, "lossguide", "ring", tag="voting-ring",
                       extra=("--tree-parallelism", "voting", "--top-k", str(ELASTIC_TOP_K)))


def _voting_gang(gang: dict, tmp: str, full: dict, x_test, y_test, fails: list) -> dict:
    """The voting gang of ``_voting_spawn``: the members byte-equal; a member's
    payload against the full lossguide ring gang's (a (d,) f64 ballot and
    (2, 2K, B, 3) int64 cells a split against a (d*B, 3) plane: ~0.25 at d
    = 64, K = 4, B = 256); held-out AUC within ELASTIC_AUC_TOL of the full
    gang's; ``plane_hist_fixed`` launches and vote rounds a member."""
    rec = _gang_end(gang, tmp, None, fails)
    model = rec.pop("model")
    vote_b = {n: m["payload_bytes"] for n, m in rec["member"].items()}
    full_b = {n: m["payload_bytes"] for n, m in full["member"].items()}
    ratio = max(vote_b.values()) / min(full_b.values())
    auc = {k: binary_auc(y_test, Booster.from_model_string(m).predict(x_test, device=DEV))
           for k, m in (("voting", model), ("full", full["model"]))}
    rec.update(top_k=ELASTIC_TOP_K, payload_ratio=ratio, full_payload_bytes=full_b, auc=auc)
    if not ratio < ELASTIC_VOTE_RATIO:
        fails.append(f"voting: payload ratio {ratio} against the full gang is not under "
                     f"{ELASTIC_VOTE_RATIO}")
    if not abs(auc["voting"] - auc["full"]) < ELASTIC_AUC_TOL:
        fails.append(f"voting: held-out AUC {auc['voting']} not within {ELASTIC_AUC_TOL} of "
                     f"the full gang's {auc['full']}")
    for n, m in rec["member"].items():
        if not m["vote_rounds"]:
            fails.append(f"voting: member {n} made no voting exchange")
    return rec


def _stream_csv(tmp: str) -> str:
    """The stream-synth rows as a CSV (``f00``..``f63``, ``label``; f32
    values at 9 significant digits, which round-trip), chunk by chunk."""
    from mmlspark_tpu_torch.parallel.elastic import load_streaming_data

    factory, _, d = load_streaming_data(STREAM_SPEC)
    path = os.path.join(tmp, "stream.csv")
    with open(path, "w") as f:
        f.write(",".join([f"f{j:02d}" for j in range(d)] + ["label"]) + "\n")
        for x, y in factory():
            np.savetxt(f, np.column_stack([x.astype(np.float64), y]), fmt="%.9g", delimiter=",")
    return path


def _ingest(spec: str):
    """A world-1 member's ingest of ``spec`` here: (BinnedDataset, labels)."""
    from mmlspark_tpu_torch.parallel.elastic import ElasticTrainer, load_streaming_data

    factory, n, d = load_streaming_data(spec)
    return ElasticTrainer(None, "ingest", None, None, elastic_cfg("lossguide"), "",
                          stream=factory, n_rows=n, n_features=d)._ingest_stream(None, 0, n)


def _streaming_gangs(reg_url: str, tmp: str, fails: list) -> dict:
    """``stream-synth:200000x64:3:65536`` at world 2 and world 1, and
    ``stream-csv:`` of the same rows written to a CSV at world 1: every
    booster byte-equal to ``train`` on one device on the world-1
    BinnedDataset; the CSV's ingested bins equal the synth ones. The
    stream-synth members are spawned first and fit while the CSV is written
    here (separate services); the CSV member follows it."""
    w2 = _gang_spawn(reg_url, tmp, "lossguide", "ring", tag="stream-w2", data=STREAM_SPEC)
    t3 = time.perf_counter()
    procs = {"stream-w1": _elastic_member(reg_url, tmp, "stream-w1", 1, "lossguide", "ring",
                                          "stream-w1", data=STREAM_SPEC)}
    t0 = time.perf_counter()
    binned, y = _ingest(STREAM_SPEC)
    ingest_here_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    one = train(binned, y, elastic_cfg("lossguide"), device=DEV).to_model_string()
    one_fit_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    csv_path = _stream_csv(tmp)
    csv_spec, csv_write_s = f"stream-csv:{csv_path}:label", time.perf_counter() - t2
    procs["stream-csv-w1"] = _elastic_member(reg_url, tmp, "stream-csv-w1", 1, "lossguide",
                                             "ring", "stream-csv-w1", data=csv_spec)
    csv_bins, csv_y = _ingest(csv_spec)
    bins_equal = bool(np.array_equal(csv_bins.bins, binned.bins) and np.array_equal(csv_y, y)
                      and all(np.array_equal(a, b) for a, b in
                              zip(csv_bins.mapper.uppers, binned.mapper.uppers)))
    del csv_bins, binned
    if not bins_equal:
        fails.append("stream-csv: the ingested bins differ from stream-synth's")
    gangs = {"stream_w2": _gang_end(w2, tmp, one, fails)}
    got = _elastic_wait(procs, tmp, t3)
    for n, m in got["members"].items():
        rec = {"world": 1, "wall_s": got["wall_s"], "equals_one_device": m["model"] == one,
               "member": {n: _member_rec(m, "plane_hist")}}
        if not rec["equals_one_device"]:
            fails.append(f"{n}: the booster differs from the one-device fit on the "
                         "world-1 BinnedDataset")
        if not m["status"]["launches"].get("plane_hist"):
            fails.append(f"{n}: never launched plane_hist")
        gangs[n.replace("-", "_")] = rec
    gangs["stream_w2"].pop("model")
    for n, m in gangs["stream_w2"]["member"].items():
        if not m["ingest_payload_bytes"]:
            fails.append(f"stream-w2: member {n}'s sketch merge sent nothing")
    return {"spec": STREAM_SPEC, "csv_bins_equal": bins_equal, "csv_write_s": csv_write_s,
            "ingest_here_s": ingest_here_s, "one_device_fit_s": one_fit_s, "gangs": gangs}


def _artifact_drill(reg_url: str, tmp: str, one: str, fails: list) -> dict:
    """Two members, each with its own --ckpt-dir and --artifact-dir (no
    shared directory); b stalls entering round ELASTIC_KILL_ROUND and is
    SIGKILLed. a reshards from the snapshot it froze and put as an
    artifact; a fresh world-1 member with ``--resume-from
    artifact:<name>@<digest>@<url>`` (a's store served from here) pulls it
    over loopback. Both boosters byte-equal, and equal to the one-device
    fit."""
    from mmlspark_tpu_torch.serving.artifacts import ArtifactServer, ArtifactStore

    stall = json.dumps({"rules": [{"point": "gbdt.round", "at": [ELASTIC_KILL_ROUND],
                                   "delay_s": 600}]})

    def member(name, world, service, fault=None, extra=()):
        return _elastic_member(reg_url, tmp, name, world, "lossguide", "ring", service,
                               fault=fault, ckpt=os.path.join(tmp, f"ck-{name}"),
                               extra=("--artifact-dir", os.path.join(tmp, f"art-{name}"),
                                      *extra))

    t0 = time.perf_counter()
    a = member("art-a", 2, "art-drill")
    b = member("art-b", 2, "art-drill", fault=stall)
    # per-host directories: watch the survivor's own checkpoint stream
    _kill_at_checkpoint(os.path.join(tmp, "ck-art-a", "LATEST"), a, b, t0, "artifact drill")
    survivor = _elastic_wait({"art-a": a}, tmp, t0)["members"]["art-a"]
    st = survivor["status"]
    snap = st["snapshot"] or ""
    store = ArtifactStore(os.path.join(tmp, "art-art-a"))   # re-indexed from disk
    refs = [r for r in store.refs() if r.startswith(os.path.basename(snap) + "@")]
    ok = (st["reshards"] == 1 and st["members"] == ["art-a"] and st["gen"] == 2
          and st["resume_round"] == ELASTIC_KILL_ROUND
          and snap.startswith(os.path.join(tmp, "ck-art-a")) and bool(refs))
    if not ok:
        fails.append(f"artifact drill: the survivor did not reshard from its own snapshot "
                     f"artifact: {st}, refs {store.refs()}")
        return {"status": st}
    srv = ArtifactServer(store)
    try:
        t1 = time.perf_counter()
        fresh = _elastic_wait({"art-fresh": member(
            "art-fresh", 1, "art-fresh",
            extra=("--resume-from", f"artifact:{refs[0]}@{srv.url}"))},
            tmp, t1)["members"]["art-fresh"]
    finally:
        srv.stop()
    fs = fresh["status"]
    rec = {"kill_round": ELASTIC_KILL_ROUND, "snapshot_ref": refs[0],
           "survivor_snapshot_replicas": st["snapshot_replicas"],
           "detect_latency_s": st["detect_latency_s"],
           "artifact_fetches": fs["artifact_fetches"],
           "fetch_bytes": fs["artifact_fetch_bytes"], "fetch_s": fs["artifact_fetch_s"],
           "fetch_mb_per_s": fs["artifact_fetch_bytes"] / 1e6 / max(fs["artifact_fetch_s"], 1e-9),
           "survivor_launches": st["launches"], "fresh_launches": fs["launches"],
           "equals_fresh_from_artifact": survivor["model"] == fresh["model"],
           "equals_one_device": survivor["model"] == one}
    if fs["artifact_fetches"] < 1:
        fails.append("artifact drill: the fresh member pulled no artifact")
    if not rec["equals_fresh_from_artifact"]:
        fails.append("artifact drill: the survivor's booster differs from the fresh run "
                     "from the pulled snapshot")
    if not rec["equals_one_device"]:
        fails.append("artifact drill: the survivor's booster differs from the one-device fit")
    return rec


def _artifact_specs(tmp: str, gbdt_string: str, x_test, fails: list) -> dict:
    """``artifact:gbdt:`` and ``artifact:vw:`` specs loaded into a ModelStore
    on this card, fetched from a peer here: each scores bitwise as its
    direct spec."""
    from mmlspark_tpu_torch.serving import artifacts
    from mmlspark_tpu_torch.serving.modelstore import ModelStore
    from mmlspark_tpu_torch.serving.server import CachedRequest

    d = os.path.join(tmp, "models")
    os.makedirs(d)
    gbdt_path, vw_path = os.path.join(d, "elastic.gbdt.json"), os.path.join(d, "vw-art.npz")
    with open(gbdt_path, "w") as f:
        f.write(gbdt_string)
    bits = 18
    rng = np.random.default_rng(SEED)
    np.savez(vw_path, weights=rng.standard_normal(1 << bits).astype(np.float32),
             meta=np.frombuffer(json.dumps({"num_bits": bits, "loss": "logistic"}).encode(),
                                np.uint8))
    producer = artifacts.ArtifactStore(os.path.join(tmp, "art-producer"))
    refs = {k: producer.put(p, name=os.path.basename(p)).spec
            for k, p in (("gbdt", gbdt_path), ("vw", vw_path))}
    srv = artifacts.ArtifactServer(producer)
    artifacts.configure(store=artifacts.ArtifactStore(os.path.join(tmp, "art-consumer")))
    store = ModelStore(device=DEV)
    bodies = {"gbdt": json.dumps({"rows": x_test[:64].tolist()}).encode(),
              "vw": json.dumps({"rows": [{"i": rng.integers(0, 1 << bits, 12).tolist(),
                                          "v": rng.normal(size=12).tolist()}
                                         for _ in range(64)]}).encode()}
    rec = {}
    try:
        for kind, path in (("gbdt", gbdt_path), ("vw", vw_path)):
            t0 = time.perf_counter()
            store.load(f"{kind}-artifact", f"artifact:{kind}:{refs[kind]}@{srv.url}")
            load_s = time.perf_counter() - t0
            store.load(f"{kind}-direct", f"{kind}:{path}")
            req = CachedRequest(id="r", epoch=0, method="POST", path="/", headers={},
                                body=bodies[kind])
            got = {}
            for name in (f"{kind}-artifact", f"{kind}-direct"):
                mv = store.acquire(name)
                try:
                    got[name] = mv.loaded.handler([req])["r"]
                finally:
                    store.release(mv)
            equal = got[f"{kind}-artifact"] == got[f"{kind}-direct"] and got[f"{kind}-direct"][0] == 200
            rec[kind] = {"ref": refs[kind], "load_s": load_s, "bitwise_equal": equal}
            if not equal:
                fails.append(f"artifact:{kind}: scores differ from the direct spec's")
    finally:
        srv.stop()
        for name in list(store.model_names()):
            store.unload(name)
    return rec


def elastic_phase(smi: str) -> dict:
    """Phase ``elastic``: a registry in this process and ``fleet train``
    members on this card (the trees/s cell's rows, written to an ``npz:``
    file): world-2 gangs, lossguide over the ring and the mesh and
    depthwise over the ring, each byte-equal to the same fit on one device
    here, and the voting gang, all four side by side; then, side by side,
    the host-loss drill, the artifact drill (per-host directories, a
    snapshot pulled by digest) and the streaming gangs (``stream-synth:``,
    ``stream-csv:``); last ``artifact:`` model specs in a ModelStore. Side
    by side, the members share the card and the host's cores: their
    seconds are read under that contention."""
    import tempfile

    from mmlspark_tpu_torch.serving import fleet

    t0 = time.perf_counter()
    x_all, y_all = dataset(N + N_TEST)
    x, y, x_test, y_test = x_all[:N], y_all[:N], x_all[N:], y_all[N:]
    one = {}
    for policy in ("lossguide", "depthwise"):
        t1 = time.perf_counter()
        one[policy] = train(x, y, elastic_cfg(policy), device=DEV).to_model_string()
        one[f"{policy}_fit_s"] = time.perf_counter() - t1
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    reg = fleet.run_registry(host="127.0.0.1", port=0, ttl_s=ELASTIC_TTL_S)
    fails: list = []
    t0_gangs = time.perf_counter()
    try:
        np.savez(os.path.join(tmp, "data.npz"), x=x, y=y)
        # wave 1: the four npz gangs side by side (8 members, separate services)
        spawned = {f"{p}_{m}": _gang_spawn(reg.url, tmp, p, m)
                   for p, m in (("lossguide", "ring"), ("lossguide", "mesh"),
                                ("depthwise", "ring"))}
        voting = _voting_spawn(reg.url, tmp)
        gangs = {k: _gang_end(g, tmp, one[g["policy"]], fails) for k, g in spawned.items()}
        ring, mesh = gangs["lossguide_ring"], gangs["lossguide_mesh"]
        bytes_ = {k: sum(m["payload_bytes"] for m in g["member"].values())
                  for k, g in (("ring", ring), ("mesh", mesh))}
        if ring["model"] != mesh.pop("model"):
            fails.append("lossguide: the ring gang's model differs from the mesh gang's")
        gangs["depthwise_ring"].pop("model")
        if not bytes_["ring"] < bytes_["mesh"]:
            fails.append(f"ring payload {bytes_['ring']} B is not under mesh's {bytes_['mesh']} B")
        gangs["voting_ring"] = _voting_gang(voting, tmp, ring, x_test, y_test, fails)
        ring.pop("model")
        t1 = time.perf_counter()
        # wave 2: the two host-loss drills and the streaming gangs side by side
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            drill_f = pool.submit(_elastic_drill, reg.url, tmp, one["lossguide"], fails)
            art_f = pool.submit(_artifact_drill, reg.url, tmp, one["lossguide"], fails)
            streaming = _streaming_gangs(reg.url, tmp, fails)
            drill, art_drill = drill_f.result(), art_f.result()
        t2 = time.perf_counter()
        art_specs = _artifact_specs(tmp, one["lossguide"], x_test, fails)
        part_s = {"wave1_gangs": t1 - t0_gangs, "wave2_drills_streaming": t2 - t1,
                  "artifact_specs": time.perf_counter() - t2}
    finally:
        for p in _ELASTIC_PROCS:
            if p.poll() is None:
                p.kill()
                p.wait()
        reg.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"rows": N, "d": D, "rounds": ELASTIC_ROUNDS, "heartbeat_s": ELASTIC_HEARTBEAT_S,
           "ttl_s": ELASTIC_TTL_S, "nvidia_smi": smi,
           "one_device_fit_s": {p: one[f"{p}_fit_s"] for p in ("lossguide", "depthwise")},
           "payload_bytes": bytes_, "gangs": gangs, "drill": drill, "streaming": streaming,
           "artifact_drill": art_drill, "artifact_specs": art_specs, "part_s": part_s,
           "seconds": time.perf_counter() - t0}
    phase("elastic", **rec)
    if fails:
        raise AssertionError("elastic: " + "; ".join(fails))
    return rec


# -- phase fleet: registry, supervised workers on the card, gateways ----------------------

FLEET_CLIENTS = 8                   # concurrent keep-alive clients
FLEET_REQUESTS = 1000               # requests a load run, split between gbdt: and vw: (cut
                                    # from 2,000 for the script's time)
FLEET_MODELS = ("gbdt", "vw")
FLEET_HEDGE_MS = 1.0                # the hedging gateway's delay
FLEET_BOOT_S = 240.0                # a worker must be routable within this of its spawn
# the workers' AIMD admission floor: below this queue wait a window never
# reads as overload. Two processes time-slice the one card, so a gbdt: batch
# waits 50-250 ms under 8 clients on one worker (the kill drill, hedging);
# at the 2 ms default the limit fell to 7 and shed 429s
FLEET_ADMISSION_FLOOR_MS = 1000


def _fleet_client(port: int, bodies: dict, c: int, n: "int | None", stop, out: list,
                  models: tuple) -> None:
    """One keep-alive client: request i goes to model models[(i + c) % len(models)]
    (``x-mmlspark-model``) with row (7 c + i) % len(bodies[model]), until ``n``
    requests are sent or ``stop`` is set; appends (model, row, status, body, ms)."""
    import http.client

    conn = None
    i = 0
    while (n is None or i < n) and not (stop is not None and stop.is_set()):
        model = models[(i + c) % len(models)]
        k = (7 * c + i) % len(bodies[model])
        t0 = time.perf_counter()
        try:
            if conn is None:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request("POST", "/", body=bodies[model][k],
                         headers={"Content-Type": "application/json",
                                  "x-mmlspark-model": model})
            r = conn.getresponse()
            status, body = r.status, r.read()
        except (OSError, http.client.HTTPException) as e:
            status, body = "conn", repr(e).encode()
            conn = None
        out.append((model, k, status, body, (time.perf_counter() - t0) * 1e3))
        i += 1
    if conn is not None:
        conn.close()


def _fleet_load(ports: list, bodies: dict, n: "int | None", stop=None,
                models: tuple = FLEET_MODELS, clients: int = FLEET_CLIENTS) -> list:
    """``n`` requests from ``clients`` concurrent clients, client c on
    ``ports[c % len(ports)]`` (or, with ``stop``, until it is set; the call
    then returns at once with the running threads and their shared list)."""
    import threading

    out: list = []
    per = None if n is None else -(-n // clients)
    threads = [threading.Thread(target=_fleet_client,
                                args=(ports[c % len(ports)], bodies, c, per, stop, out,
                                      models), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    if stop is not None:
        return [threads, out]
    for t in threads:
        t.join()
    return out


def _fleet_check(name: str, got: list, want: dict, fails: list) -> dict:
    """Every reply 200 and bitwise the in-process call; p50/p99 a model."""
    bad, non_200 = [], []
    for model, k, status, body, _ in got:
        if status != 200:
            non_200.append((model, k, status, body[:120].decode("latin1")))
            continue
        r = json.loads(body)
        if model == "echo":
            ok = r == {"echo": json.loads(want["echo"][k])}
        elif model == "gbdt":
            ok = r["margin"] == float(want["gbdt"][k])
        else:
            ok = r["margin"] == float(np.float32(want["vw"][k])) == float(
                np.float32(want["vw_cpu"][k]))
        if not ok:
            bad.append((model, k))
    if non_200:
        fails.append(f"{name}: {len(non_200)} replies were not 200, e.g. {non_200[:3]}")
    if bad:
        fails.append(f"{name}: {len(bad)} replies differ from the in-process call: {bad[:5]}")
    lat = {}
    for m in sorted({mm for mm, *_ in got}):
        ms = [t for mm, _, s, _, t in got if mm == m and s == 200]
        lat[m] = _quantiles(ms) if ms else {"p50_ms": None, "p99_ms": None, "n": 0}
    return {"requests": len(got), "non_200": len(non_200), "mismatched": len(bad),
            "latency": lat}


def _fleet_role(args: list, log: str):
    """``python -m mmlspark_tpu_torch.serving.fleet <args>`` from this checkout."""
    with open(log, "w") as out:
        return subprocess.Popen([sys.executable, "-m", "mmlspark_tpu_torch.serving.fleet",
                                 *args], cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)


def _metrics(url: str) -> dict:
    from mmlspark_tpu_torch.serving.fleet import scrape_metrics

    try:
        return scrape_metrics(url) or {}
    except OSError:
        return {}


def _sample(parsed: dict, name: str) -> float:
    from mmlspark_tpu_torch import obs

    return obs.sum_samples(parsed, name)


def _wait(cond, timeout_s: float, what: str, where: str = "fleet") -> float:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"{where}: {what} within {timeout_s:g} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _gateway_up(url: str, bodies: dict, backends: int) -> bool:
    """The gateway answers both models 200 and counts ``backends`` live ones."""
    import http.client

    parsed = _metrics(url)
    if _sample(parsed, "mmlspark_gateway_backends_count") < backends:
        return False
    u = url.rstrip("/").rsplit(":", 1)
    try:
        for model in FLEET_MODELS:
            c = http.client.HTTPConnection("127.0.0.1", int(u[1]), timeout=30)
            c.request("POST", "/", body=bodies[model][0],
                      headers={"x-mmlspark-model": model})
            ok = c.getresponse().status == 200
            c.close()
            if not ok:
                return False
    except OSError:
        return False
    return True


def fleet_stop(kept: dict) -> None:
    """Stops what ``fleet_phase`` hands on (its registry and its supervised
    workers), restores PYTHONPATH and removes the fleet's directory."""
    if kept.get("sup") is not None:
        kept["sup"].stop()
    kept["reg"].stop()
    if kept["env_pp"] is None:
        os.environ.pop("PYTHONPATH", None)
    else:
        os.environ["PYTHONPATH"] = kept["env_pp"]
    shutil.rmtree(kept["dir"], ignore_errors=True)


def fleet_phase(smi: str, gbdt_string: str, vw_serve: dict, x_test) -> "tuple[dict, dict]":
    """Phase ``fleet``: the serving fleet through its entry points. A
    registry in this process (``fleet.run_registry``), two ``fleet worker
    --device cuda`` processes on this one card under ``fleet supervise``'s
    supervisor (``fleet.run_supervise`` in this process), each serving the
    trees/s cell's booster (``gbdt:``), V2's classifier (``vw:``) and
    ``echo``; a ``fleet gateway`` process in front. Checks: 8 keep-alive
    clients, 1,000 requests a run routed by ``x-mmlspark-model``, every reply
    200 and bitwise the in-process call, p50/p99 a model with the clients
    split straight over the two workers and through the gateway; ``vw_margin`` counted in an extra worker run in
    this process (``fleet.run_worker``) on the same traffic; a worker
    SIGKILLed mid-load (no request lost, respawned with a new boot stamp,
    routed to again: seconds from the kill); ``rolling_restart`` under load
    (every reply 200); a second gateway with ``--hedge-ms`` (bitwise); one
    request's trace assembled across the gateway->worker hop (``fleet
    trace``); ``fleet top``'s p99, error and SLO columns; the SLO gauges on
    both roles' ``/metrics``. Returns the record and what phases ``online``,
    ``tune`` and ``chaos`` go on using: the registry, the supervisor and its two
    workers' ports (each worker with its own ``--artifact-dir``), PYTHONPATH as
    it was and the fleet's directory, all for ``fleet_stop``; on a failure it
    stops them itself."""
    import threading

    from mmlspark_tpu_torch import obs
    from mmlspark_tpu_torch.obs import traces as traces_mod
    from mmlspark_tpu_torch.ops import sgd
    from mmlspark_tpu_torch.serving import fleet

    t0 = time.perf_counter()
    d = os.path.join(ROOT, "build", "chip_smoke_fleet")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(os.path.join(d, "trees.gbdt.json"), "w") as f:
        f.write(gbdt_string)
    vw_model = vw_serve["model"]
    meta = json.dumps({"num_bits": vw_model.get("num_bits"),
                       "loss": vw_model.get("loss_function") or "logistic",
                       "no_constant": vw_model.get("no_constant")}).encode()
    np.savez(os.path.join(d, "v2.npz"), weights=np.asarray(vw_model.get("weights"), np.float32),
             meta=np.frombuffer(meta, np.uint8))
    gb_rows = x_test[:SERVE_ROWS]
    vw_rows = [{"i": np.asarray(r["i"]).tolist(), "v": np.asarray(r["v"], np.float32).tolist()}
               for r in vw_serve["rows"][:SERVE_ROWS]]
    rng = np.random.default_rng(SEED)
    bodies = {"gbdt": [json.dumps({"features": r.tolist()}).encode() for r in gb_rows],
              "vw": [json.dumps(r).encode() for r in vw_rows],
              "echo": [json.dumps({"k": k, "x": rng.standard_normal(4).tolist()}).encode()
                       for k in range(SERVE_ROWS)]}
    vdf = DataFrame.from_dict({"features": _obj(vw_rows)})
    want = {"gbdt": Booster.from_model_string(gbdt_string).predict(gb_rows, device=DEV),
            "vw": vw_model.copy({"device": DEV.type}).transform(vdf)["raw_prediction"],
            "vw_cpu": vw_model.copy({"device": "cpu"}).transform(vdf)["raw_prediction"],
            "echo": bodies["echo"]}
    worker_args = (f"--model echo --load gbdt=gbdt:{d}/trees.gbdt.json --load vw=vw:{d}/v2.npz "
                   f"--device {DEV.type} --host 127.0.0.1 --heartbeat-s 0.5 --drain-s 10 "
                   f"--admission-initial-limit 64 "
                   f"--admission-min-target-ms {FLEET_ADMISSION_FLOOR_MS}")
    ports = [_free_port(), _free_port()]
    fails: list = []
    rec: dict = {"nvidia_smi": smi, "clients": FLEET_CLIENTS, "requests_a_run": FLEET_REQUESTS,
                 "workers": "2 processes sharing this one card", "worker_args": worker_args}
    env_pp = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = ROOT + (os.pathsep + env_pp if env_pp else "")
    reg = fleet.run_registry(host="127.0.0.1", port=0, ttl_s=10.0)
    kept = {"reg": reg, "sup": None, "ports": ports, "env_pp": env_pp, "dir": d}
    gws = None
    extra = None
    ok = False
    try:
        sup = kept["sup"] = fleet.run_supervise(
            reg.url, [f"{worker_args} --port {p} --artifact-dir {d}/worker{k}_art"
                      for k, p in enumerate(ports)],
            probe_s=0.5, backoff_s=0.5, wedge_after=20)
        gw_port, hedge_port = _free_port(), _free_port()
        gws = {"gateway": _fleet_role(["gateway", "--registry", reg.url, "--host", "127.0.0.1",
                                       "--port", str(gw_port), "--dispatchers", "8"],
                                      os.path.join(d, "gateway.log")),
               "hedging": _fleet_role(["gateway", "--registry", reg.url, "--host", "127.0.0.1",
                                       "--port", str(hedge_port), "--dispatchers", "8",
                                       "--hedge-ms", str(FLEET_HEDGE_MS),
                                       "--retry-budget-ratio", "0.5"],
                                      os.path.join(d, "hedging.log"))}
        gw_url = f"http://127.0.0.1:{gw_port}"
        hedge_url = f"http://127.0.0.1:{hedge_port}"
        rec["cold_start_s"] = _wait(lambda: _gateway_up(gw_url, bodies, 2), FLEET_BOOT_S,
                                    "the two supervised workers did not become routable")
        _wait(lambda: _gateway_up(hedge_url, bodies, 2), 60.0, "the hedging gateway is not up")
        w0 = f"http://127.0.0.1:{ports[0]}"

        # the clients split over the two workers, then all through the gateway
        # (which spreads them over the same two): the difference is its cost
        direct = _fleet_check("direct", _fleet_load(ports, bodies, FLEET_REQUESTS), want, fails)
        via = _fleet_check("gateway", _fleet_load([gw_port], bodies, FLEET_REQUESTS), want,
                           fails)
        # echo alone: the gateway's own hop, without the models' contention
        e_direct = _fleet_check("direct echo", _fleet_load(ports, bodies, FLEET_REQUESTS,
                                                           models=("echo",)), want, fails)
        e_via = _fleet_check("gateway echo", _fleet_load([gw_port], bodies, FLEET_REQUESTS,
                                                         models=("echo",)), want, fails)
        for a, b in ((direct, e_direct), (via, e_via)):
            a["latency"].update(b["latency"])
            a["requests"] += b["requests"]
        rec["direct"], rec["gateway"] = direct, via
        rec["gateway_cost_ms"] = {m: {q: via["latency"][m][q] - direct["latency"][m][q]
                                      for q in ("p50_ms", "p99_ms")}
                                  for m in FLEET_MODELS + ("echo",)}

        # vw_margin counted in one more worker, this process's, on the same traffic
        extra = fleet.run_worker(reg.url, model="echo", host="127.0.0.1", heartbeat_s=0.5,
                                 extra_models=[f"gbdt=gbdt:{d}/trees.gbdt.json",
                                               f"vw=vw:{d}/v2.npz"], device=DEV.type)
        _wait(lambda: _gateway_up(gw_url, bodies, 3), 60.0,
              "the in-process worker did not join the gateway's pool")
        sgd.reset_launch_counts()
        H.reset_launch_counts()
        counted = _fleet_check("counted", _fleet_load([gw_port], bodies, FLEET_REQUESTS), want,
                               fails)
        launches = {**dict(sgd.launches), **dict(H.launches)}
        srv_e, q_e, stop_e = extra
        stop_e.drain(timeout_s=5.0)
        q_e.stop()
        srv_e.stop()
        extra = None
        if launches["vw_margin"] < 1:
            fails.append("the in-process worker served no vw: request with vw_margin")
        rec["counted"] = {**counted, "launches": launches,
                          "workers": "2 supervised processes + 1 in this process"}

        # SIGKILL one worker mid-load: nothing lost, respawned, routed to again
        victim = sup.charges[0]
        old_boot = {e["port"]: e.get("boot") for e in reg.services("serving")}.get(ports[0])
        stop = threading.Event()
        threads, got = _fleet_load([gw_port], bodies, None, stop)
        time.sleep(2.0)
        t_kill = time.perf_counter()
        victim.proc.kill()
        new_boot = lambda: {e["port"]: e.get("boot")  # noqa: E731
                            for e in reg.services("serving")}.get(ports[0])
        rostered = _wait(lambda: new_boot() not in (None, old_boot), FLEET_BOOT_S,
                         "the killed worker was not respawned and re-registered")
        routed = _wait(lambda: _sample(_metrics(w0), "mmlspark_serving_requests_total") > 0,
                       60.0, "the gateway did not route to the respawned worker") + rostered
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join()
        kill = _fleet_check("worker_kill", got, want, fails)
        rec["worker_kill"] = {**kill, "restarts": victim.restarts,
                              "kill_to_rostered_s": rostered, "kill_to_first_routed_s": routed,
                              "boot_changed": new_boot() != old_boot}

        # rolling restart under load
        stop = threading.Event()
        threads, got = _fleet_load([gw_port], bodies, None, stop)
        time.sleep(1.0)
        tr = time.perf_counter()
        rolled = sup.rolling_restart(wait_up_s=FLEET_BOOT_S, settle_s=2.0)
        roll_s = time.perf_counter() - tr
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join()
        if not rolled:
            fails.append("rolling_restart: a replacement did not come back")
        rec["rolling_restart"] = {**_fleet_check("rolling_restart", got, want, fails),
                                  "seconds": roll_s,
                                  "restarts": [c.restarts for c in sup.charges]}
        _wait(lambda: _gateway_up(hedge_url, bodies, 2), 60.0,
              "the hedging gateway did not see both workers again")

        # hedging: replies still bitwise
        hedged = _fleet_check("hedging", _fleet_load([hedge_port], bodies, FLEET_REQUESTS), want,
                              fails)
        hp = _metrics(hedge_url)
        rec["hedging"] = {**hedged, "hedge_ms": FLEET_HEDGE_MS,
                          "hedges": _sample(hp, "mmlspark_gateway_hedges_total"),
                          "hedge_wins": _sample(hp, "mmlspark_gateway_hedge_wins_total")}

        # one request's trace across the gateway->worker hop (fleet trace)
        tid = "f1ee7" + "0" * 19
        import http.client

        c = http.client.HTTPConnection("127.0.0.1", gw_port, timeout=60)
        c.request("POST", "/", body=bodies["gbdt"][0],
                  headers={"x-mmlspark-model": "gbdt", obs.TRACE_HEADER: tid})
        if c.getresponse().status != 200:
            fails.append("trace: the traced request failed")
        c.close()
        time.sleep(0.5)
        spans, _, scraped = traces_mod.collect(
            [gw_url] + [f"http://127.0.0.1:{p}" for p in ports], trace_id=tid)
        roots = traces_mod.assemble(spans)
        tree = fleet.run_trace(tid, registry_url=reg.url, gateway_url=gw_url)
        hop = traces_mod.has_gateway_and_worker_hop(spans)
        if not (hop and [r.span.name for r in roots] == ["gateway.request"]):
            fails.append(f"trace: no one gateway->worker tree ({[r.span.name for r in roots]})")
        if "gateway.request" not in tree or "serving.request" not in tree:
            fails.append("fleet trace: the rendered tree lacks a hop")
        rec["trace"] = {"spans": len(spans), "endpoints_scraped": len(scraped), "roots": len(roots),
                        "gateway_worker_hop": hop, "tree": tree.splitlines()[:12]}

        # fleet top and the SLO gauges on both roles
        top = fleet.run_top(registry_url=reg.url, gateway_url=gw_url)
        lines = top.splitlines()
        hdr = next((ln for ln in lines if ln.startswith("WORKER")), "")
        gw_line = next((ln for ln in lines if ln.startswith("gateway")), "")
        if not all(col in hdr for col in ("ERR_PCT", "LAT_P99_MS", "SLO")) or "slo" not in gw_line:
            fails.append(f"fleet top: columns missing: {hdr!r} / {gw_line!r}")
        slo_on = {role: any(k[0] == "mmlspark_slo_status_count" for k in _metrics(u))
                  for role, u in (("gateway", gw_url), ("worker", w0))}
        if not all(slo_on.values()):
            fails.append(f"SLO gauges missing: {slo_on}")
        rec["top"] = lines
        rec["slo_gauges"] = slo_on
        gp = _metrics(gw_url)
        rec["gateway_metrics"] = {k: _sample(gp, f"mmlspark_gateway_{k}") for k in (
            "requests_total", "retries_total", "failures_total", "backend_backpressure_total",
            "conn_reuse_total", "conn_opened_total")}
        rec["supervisor"] = sup.status()
        ok = True
    finally:
        if extra is not None:
            extra[2].set()
            extra[1].stop()
            extra[0].stop()
        for p in (gws or {}).values():
            p.terminate()
        for p in (gws or {}).values():
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if not ok:
            fleet_stop(kept)
    if fails:
        for name in ("gateway", "hedging"):
            with open(os.path.join(d, f"{name}.log")) as f:
                rec.setdefault("logs", {})[name] = f.read()[-600:]
        fleet_stop(kept)
    rec["seconds"] = time.perf_counter() - t0
    phase("fleet", **rec)
    if fails:
        raise AssertionError("fleet: " + "; ".join(fails))
    return rec, kept


# -- phases online, tune and chaos: continuous learning, ASHA, a chaos scenario -------------

ONLINE_FIT = VW_ROWS - VW_HOLDOUT   # V2's 80,000 training rows, ingested in order
ONLINE_CHUNK = 1024                 # rows an /ingest POST
ONLINE_CLIENTS = 4                  # keep-alive clients scoring vw-online while it learns
ONLINE_ART_CHUNKS = 8               # the artifact-mode run's POSTs (--replicas 1)
ONLINE_BOOT_S = 240.0               # the fleet's workers must serve within this of their spawn
ONLINE_SERVED_ROWS = 64             # held-out rows each worker scores per bitwise check
ONLINE_AFTER = 2000                 # requests after the last publication, held bitwise
ONLINE_MODEL = ("vw-online",)
TUNE_TRIALS, TUNE_SEED, TUNE_MIN, TUNE_MAX, TUNE_ETA = 4, 0, 2, 8, 2
TUNE_SPACE = {"num_leaves": [63], "min_data_in_leaf": [10, 20, 40],
              "learning_rate": {"low": 0.05, "high": 0.3, "log": True}}
TUNE_DEADLINE_S = 600
CHAOS_SEED = 17
CHAOS_PROXIED = 300                 # sequential requests through the proxied link, a run
CHAOS_CLEAR_S = 6.0                 # the scenario clears the link's rules here: the proxied
                                    # requests must all be sent before it
CHAOS_SCENARIO = {"seed": CHAOS_SEED, "steps": [
    {"at_s": 0.0, "action": "rules", "link": "w0",
     "rules": [{"kind": "latency", "delay_ms": 2, "jitter_ms": 3, "direction": "c2s"}]},
    {"at_s": 1.0, "action": "signal", "target": "worker0", "signal": "SIGSTOP"},
    {"at_s": 2.0, "action": "signal", "target": "worker0", "signal": "SIGCONT"},
    {"at_s": 3.5, "action": "check"},
    {"at_s": CHAOS_CLEAR_S, "action": "clear", "link": "w0"},
    {"at_s": 8.5, "action": "check", "final": True}]}
# the laws the scenario's checks evaluate on this fleet (registry, workers, the online
# loop's ingress, the tune controller's status file; no gateway, no trainer status)
CHAOS_LAWS = ("worker_conservation", "modelstore_refs_drain", "admission_drain",
              "online_conservation", "generation_monotonic", "experiment_conservation",
              "single_promotion", "artifact_quarantine")


def _ingest_body(online: dict, lo: int, hi: int) -> bytes:
    """``POST /ingest``'s body: V2's rows lo:hi with their labels."""
    feats, lab = online["features"], online["label"]
    return json.dumps({"rows": [{"i": np.asarray(feats[r]["i"]).tolist(),
                                 "v": np.asarray(feats[r]["v"], np.float32).tolist(),
                                 "label": float(lab[r])} for r in range(lo, hi)]}).encode()


def _held_bodies(online: dict) -> list:
    """Scoring bodies for V2's held-out rows."""
    return [json.dumps({"i": np.asarray(r["i"]).tolist(),
                        "v": np.asarray(r["v"], np.float32).tolist()}).encode()
            for r in online["features"][ONLINE_FIT:]]


def _vw_arrays(online: dict, lo: int, hi: int) -> tuple:
    """The online trainer's featurization of V2's rows lo:hi in one call:
    padded (idx, val) with the Constant, labels as +-1 (logistic)."""
    from mmlspark_tpu_torch.vw.estimators import _append_constant
    from mmlspark_tpu_torch.vw.sparse import pad_sparse_batch

    idx, val = _append_constant(*pad_sparse_batch(online["features"][lo:hi]), VW_BITS)
    return idx, val, np.where(online["label"][lo:hi] > 0, 1.0, -1.0).astype(np.float32)


def _post(port: int, path: str, body: bytes, timeout: float = 120.0) -> tuple:
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", path, body=body, headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _snapshot_examples(loop) -> int:
    """Examples the loop's newest publication covers (its snapshot's meta)."""
    if not loop.publish_results:
        return -1
    with np.load(loop.publish_results[-1]["path"]) as z:
        return int(json.loads(bytes(z["meta"]))["examples"])


def _served_bitwise(ports: list, bodies: list, want, model: str, fails: list,
                    what: str) -> int:
    """Every worker answers ``model`` for the first ONLINE_SERVED_ROWS held-out rows
    with ``want``'s margins bit for bit; returns the replies checked."""
    n = 0
    for p in ports:
        for k in range(ONLINE_SERVED_ROWS):
            status, body = _post(p, f"/models/{model}", bodies[k])
            if status != 200 or json.loads(body)["margin"] != float(want[k]):
                fails.append(f"{what}: worker :{p} row {k} gave {status} {body[:80]!r}, "
                             f"want {float(want[k])}")
                return n
            n += 1
    return n


def online_phase(smi: str, reg, ports: list, loop_parts: tuple, online: dict,
                 d: str) -> dict:
    """Phase ``online``: ``fleet online``'s loop (``fleet.run_online``, in this process,
    so its ``vw_pass`` launches are counted here) learns V2's 80,000 training rows,
    POSTed to its ``/ingest`` in ordered chunks of 1,024, and publishes every 2 s
    (the role's defaults: logistic, lr 0.5, batch 64, 2^18 weights) to the fleet's
    three workers (two ``fleet worker --device cuda`` processes and one in this
    process, which counts ``vw_margin``) while 4 keep-alive clients score
    ``vw-online`` on V2's held-out rows; then ONLINE_AFTER more requests. Checks:
    the last snapshot's weights bitwise one card ``train_sparse_sgd`` over the rows
    in ingest order, and within VW_EXP_TOL * max|w| of the CPU plain version's;
    every reply after the last publication bitwise the in-process scoring of that
    snapshot (card and CPU plain); 0 non-2xx. Then a short artifact-mode run
    (``--artifact-dir``, ``--replicas 1``, 8,192 rows): its snapshot confirmed on a
    second holder, bitwise the card fit, every worker serving it bitwise."""
    import threading

    from mmlspark_tpu_torch.ops import sgd
    from mmlspark_tpu_torch.serving import fleet
    from mmlspark_tpu_torch.vw import learner as VL

    t0 = time.perf_counter()
    stream, loop, _ = loop_parts
    port = stream._ingress.port
    held = _held_bodies(online)
    bodies = {ONLINE_MODEL[0]: held}
    hidx, hval, _ = _vw_arrays(online, ONLINE_FIT, VW_ROWS)
    fails: list = []
    rec: dict = {"nvidia_smi": smi, "rows": ONLINE_FIT, "chunk": ONLINE_CHUNK,
                 "clients": ONLINE_CLIENTS, "workers": "2 processes + 1 in this process",
                 "num_bits": VW_BITS, "batch": loop.trainer.batch, "loss": loop.trainer.loss,
                 "publish_every_s": loop.publish_every_s}

    # the main path: ingest in order while the clients score every publication
    sgd.reset_launch_counts()
    t_ingest = time.perf_counter()
    status, body = _post(port, "/ingest", _ingest_body(online, 0, ONLINE_CHUNK))
    if status != 200:
        raise AssertionError(f"online: the first ingest gave {status} {body[:200]!r}")
    rec["first_servable_s"] = _wait(
        lambda: all(_post(p, "/models/vw-online", held[0])[0] == 200 for p in ports),
        ONLINE_BOOT_S, "the first publication was not served by every worker", "online")
    stop = threading.Event()
    threads, during = _fleet_load(ports, bodies, None, stop, ONLINE_MODEL, ONLINE_CLIENTS)
    for lo in range(ONLINE_CHUNK, ONLINE_FIT, ONLINE_CHUNK):
        status, body = _post(port, "/ingest", _ingest_body(online, lo,
                                                           min(lo + ONLINE_CHUNK, ONLINE_FIT)))
        if status != 200:
            fails.append(f"ingest of rows {lo}: {status} {body[:200]!r}")
    rec["ingest_s"] = time.perf_counter() - t_ingest
    _wait(lambda: _snapshot_examples(loop) == ONLINE_FIT, 300.0,
          "no publication covered every ingested row", "online")
    rec["ingest_to_last_publication_s"] = time.perf_counter() - t_ingest
    stop.set()
    for t in threads:
        t.join()
    after = _fleet_load(ports, bodies, ONLINE_AFTER, None, ONLINE_MODEL, ONLINE_CLIENTS)
    launches = dict(sgd.launches)
    rec["launches"] = launches
    pub = loop.publisher
    rec["publications"] = pub.publishes
    rec["publish_failures"] = pub.failures
    fresh = [f * 1e3 for f in pub.freshness_history]
    rec["freshness"] = _quantiles(fresh)
    rec["examples"] = loop.trainer.examples
    if launches["vw_pass"] < 1 or launches["vw_margin"] < 1:
        fails.append(f"the online path launched no vw_pass or no vw_margin: {launches}")

    # the last snapshot against one call, on the card and the CPU
    path = loop.publish_results[-1]["path"]
    with np.load(path) as z:
        w = np.asarray(z["weights"], np.float32)
    idx, val, y = _vw_arrays(online, 0, ONLINE_FIT)
    kw = dict(loss="logistic", lr=0.5, batch=64, distributed=False)
    card = VL.train_sparse_sgd(idx, val, y, None, VW_BITS, device=DEV, **kw)
    cpu = VL.train_sparse_sgd(idx, val, y, None, VW_BITS, device="cpu", **kw)
    err = float(np.abs(w - cpu).max())
    rec["snapshot"] = {"path": os.path.basename(path), "bitwise_one_card_call": _bits_equal(w, card),
                       "max_abs_err_cpu": err, "tol": VW_EXP_TOL * float(np.abs(cpu).max())}
    if not _bits_equal(w, card):
        fails.append("the last snapshot differs from one card train_sparse_sgd call")
    if not err <= VW_EXP_TOL * np.abs(cpu).max():
        fails.append(f"the last snapshot is {err} from the CPU plain version")

    # the replies after the last publication: the in-process scoring of that snapshot
    want = VL.predict_margin(hidx, hval, w, device=DEV)
    want_cpu = VL.predict_margin(hidx, hval, w, device="cpu")
    if not _bits_equal(want, want_cpu):
        fails.append("in-process scoring of the snapshot: card != CPU plain")
    non_200 = [(k, s, b[:100]) for _, k, s, b, _ in during + after if s != 200]
    bad = [k for _, k, s, b, _ in after
           if s == 200 and json.loads(b)["margin"] != float(want[k])]
    if non_200:
        fails.append(f"{len(non_200)} replies were not 200: {non_200[:3]}")
    if bad:
        fails.append(f"{len(bad)} replies after the last publication are not bitwise: {bad[:5]}")
    rec["replies"] = {"across_publications": len(during), "after_last_publication": len(after),
                      "non_200": len(non_200), "after_bitwise": not bad,
                      "latency_across": _quantiles([t for *_, t in during]),
                      "latency_after": _quantiles([t for *_, t in after])}

    # artifact mode: a second loop, snapshots replicated to one other holder first
    art = fleet.run_online(registry_url=reg.url, model="vw-online-art", host="127.0.0.1",
                           port=0, snapshot_dir=os.path.join(d, "snaps_art"), heartbeat_s=0.5,
                           artifact_dir=os.path.join(d, "online_art"), replicas=1,
                           device=DEV.type)
    try:
        n_art = ONLINE_ART_CHUNKS * ONLINE_CHUNK
        t_art = time.perf_counter()
        for lo in range(0, n_art, ONLINE_CHUNK):
            status, body = _post(art[0]._ingress.port, "/ingest",
                                 _ingest_body(online, lo, lo + ONLINE_CHUNK))
            if status != 200:
                fails.append(f"artifact-mode ingest of rows {lo}: {status} {body[:200]!r}")
        _wait(lambda: _snapshot_examples(art[1]) == n_art, 120.0,
              "the artifact-mode loop did not publish every row", "online")
        res = art[1].publish_results[-1]
        with np.load(res["path"]) as z:
            w_art = np.asarray(z["weights"], np.float32)
        idx, val, y = _vw_arrays(online, 0, n_art)
        card_art = VL.train_sparse_sgd(idx, val, y, None, VW_BITS, device=DEV, **kw)
        want_art = VL.predict_margin(hidx, hval, w_art, device=DEV)
        rec["artifact_mode"] = {
            "rows": n_art, "seconds": time.perf_counter() - t_art,
            "publications": art[1].publisher.publishes, "replicas": res["replicas"],
            "targets": res["targets"], "bitwise_one_card_call": _bits_equal(w_art, card_art),
            "served_bitwise": _served_bitwise(ports, held, want_art, "vw-online-art", fails,
                                              "artifact mode")}
        if not res["replicas"] or res["targets"] < len(ports):
            fails.append(f"artifact mode: replicas {res['replicas']}, targets {res['targets']}")
        if not _bits_equal(w_art, card_art):
            fails.append("artifact mode: the snapshot differs from one card call")
    finally:
        art[2].stop()
    rec["seconds"] = time.perf_counter() - t0
    phase("online", **rec)
    if fails:
        raise AssertionError("online: " + "; ".join(fails))
    return rec


def tune_phase(smi: str, reg, ports: list, x, y, x_test, y_test, d: str) -> dict:
    """Phase ``tune``: ``fleet tune`` (a process) runs ASHA over 4 ``fleet trial
    --device cuda`` charges on this card, on the trees/s cell's rows (200,000 x 64
    to train, the 50,000 held out to score; 63 leaves, rungs at 2, 4 and 8 rounds,
    eta 2), and publishes the winner to the fleet's workers as ``champion``.
    Checks: each rung's promotion set is ``asha.promote`` of the reports; the
    winner refitted fresh to 8 rounds in this process has the committed digest;
    every worker serves ``champion`` bitwise the in-process booster; each trial
    launched the histogram kernels (its status file's counts)."""
    import glob

    from mmlspark_tpu_torch.experiments import asha, records
    from mmlspark_tpu_torch.experiments.controller import sample_trials, space_from_json
    from mmlspark_tpu_torch.serving import fleet

    t0 = time.perf_counter()
    fails: list = []
    train_path, valid_path = os.path.join(d, "train.npz"), os.path.join(d, "valid.npz")
    np.savez(train_path, x=x, y=y)
    np.savez(valid_path, x=x_test, y=y_test)
    status_path = os.path.join(d, "tune.json")
    argv = ["tune", "--registry", reg.url, "--experiment", "tune",
            "--trials", str(TUNE_TRIALS), "--space", json.dumps(TUNE_SPACE),
            "--data", f"npz:{train_path}", "--valid", f"npz:{valid_path}",
            "--min-iters", str(TUNE_MIN), "--max-iters", str(TUNE_MAX), "--eta", str(TUNE_ETA),
            "--seed", str(TUNE_SEED), "--workdir", os.path.join(d, "tune"),
            "--status-file", status_path, "--publish-model", "champion",
            "--device", DEV.type, "--deadline-s", str(TUNE_DEADLINE_S)]
    log = os.path.join(d, "tune.log")
    proc = _fleet_role(argv, log)
    try:
        rc = proc.wait(TUNE_DEADLINE_S + 60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    tune_s = time.perf_counter() - t0
    with open(log) as f:
        tail = f.read()[-2000:]
    if rc != 0:
        raise AssertionError(f"tune: fleet tune exited {rc}: {tail}")
    with open(status_path) as f:
        st = json.load(f)
    state = records.read_state(reg.url, "tune")
    survivors = sorted(sample_trials(space_from_json(TUNE_SPACE), TUNE_TRIALS, TUNE_SEED))
    rungs = {}
    for rung, bound in enumerate(st["boundaries"]):
        promoted, board = asha.promote(state.rung_metrics(survivors, rung), TUNE_ETA, TUNE_SEED)
        rungs[str(bound)] = {"promoted": promoted, "leaderboard": board}
        if not (promoted == st["rungs"][str(rung)] == state.rungs[rung]["promoted"]):
            fails.append(f"rung {rung}: promoted {st['rungs'][str(rung)]}, asha.promote "
                         f"of the reports gives {promoted}")
        survivors = promoted
    winner = st["winner"]
    if not st["published"] or st["running"] or st["trials_spawned"] != (
            st["completed"] + st["demoted"] + st["rescheduled"]):
        fails.append(f"tune's status: {st}")

    # the trials' own launches (their fleet train status files)
    launches = {}
    for path in sorted(glob.glob(os.path.join(d, "tune", "t*", "i*", "status.json"))):
        with open(path) as f:
            member = json.load(f)
        trial = os.path.relpath(path, os.path.join(d, "tune")).split(os.sep)[0]
        launches[trial] = {k: v for k, v in member.get("launches", {}).items()
                           if "hist" in k}
    if sorted(launches) != sorted(sample_trials(space_from_json(TUNE_SPACE), TUNE_TRIALS,
                                                TUNE_SEED)) or not all(
            sum(v.values()) > 0 for v in launches.values()):
        fails.append(f"a trial launched no histogram kernel: {launches}")

    # the winner refitted fresh to max_iters, and served
    t_fresh = time.perf_counter()
    booster = fleet.run_train(reg.url, "fresh", f"npz:{train_path}", os.path.join(d, "fresh"),
                              partitions=4, world_size=1, service_name="tune-fresh",
                              num_iterations=TUNE_MAX, checkpoint_every=1, heartbeat_s=0.5,
                              seed=TUNE_SEED, allow_growback=False, device=DEV.type,
                              **winner["params"])
    fresh_s = time.perf_counter() - t_fresh
    model = booster.to_model_string()
    digest = hashlib.sha256(model.encode()).hexdigest()
    if digest != winner["model"]:
        fails.append(f"the fresh refit's digest {digest} is not the committed {winner['model']}")
    rows = x_test[:ONLINE_SERVED_ROWS]
    want = Booster.from_model_string(model).predict(rows, device=DEV)
    bodies = [json.dumps({"features": r.tolist()}).encode() for r in rows]
    served = _served_bitwise(ports, bodies, want, "champion", fails, "champion")
    rec = {"nvidia_smi": smi, "trials": TUNE_TRIALS, "space": TUNE_SPACE,
           "rows": len(y), "held_out": len(y_test), "boundaries": st["boundaries"],
           "eta": TUNE_ETA, "seed": TUNE_SEED, "tune_s": tune_s, "rungs": rungs,
           "status": {k: st[k] for k in ("trials_spawned", "completed", "demoted",
                                          "rescheduled", "running", "published")},
           "winner": {k: winner[k] for k in ("trial", "metric", "params", "model")},
           "fresh_refit": {"seconds": fresh_s, "digest_equal": digest == winner["model"]},
           "champion_served_bitwise": served, "launches": launches,
           "status_file": status_path}
    rec["seconds"] = time.perf_counter() - t0
    phase("tune", **{k: v for k, v in rec.items() if k != "status_file"})
    if fails:
        rec["log"] = tail
        raise AssertionError("tune: " + "; ".join(fails))
    return rec


def _chaos_run(reg, ports: list, sup, proxy_port: int, ingest_port: int,
               tune_status: str, online: dict, held: list, d: str, tag: str) -> dict:
    """One ``fleet chaos`` run of CHAOS_SCENARIO: worker 0's link through a seeded
    proxy (``--proxy w0=...``), latency with jitter, worker 0 SIGSTOPped and
    SIGCONTed (worker 0: the supervisor's first charge, its process now), a check
    during the load and a final one after it. The load: one
    client sends CHAOS_PROXIED requests through the proxy, one after another on one
    connection (the same bytes every run, so the same schedule), ONLINE_CLIENTS
    others score on the other workers and 8 chunks of feedback are ingested."""
    import http.client
    import socket
    import threading

    out_path = os.path.join(d, f"chaos-{tag}.out")
    proc = _fleet_role(["chaos", "--scenario", json.dumps(CHAOS_SCENARIO),
                        "--proxy", f"w0={proxy_port}:127.0.0.1:{ports[0]}",
                        "--pid", f"worker0={sup.charges[0].proc.pid}", "--registry", reg.url,
                        "--online", f"http://127.0.0.1:{ingest_port}",
                        "--experiment-status-file", tune_status], out_path)

    def up() -> bool:
        try:
            socket.create_connection(("127.0.0.1", proxy_port), timeout=1).close()
            return True
        except OSError:
            return False

    _wait(up, 60.0, "the proxy did not come up", "chaos")
    t_up = time.monotonic()
    stop = threading.Event()
    threads, got = _fleet_load(ports[1:], {ONLINE_MODEL[0]: held}, None, stop, ONLINE_MODEL,
                               ONLINE_CLIENTS)
    ingest = threading.Thread(target=lambda: [
        _post(ingest_port, "/ingest", _ingest_body(online, lo, lo + ONLINE_CHUNK))
        for lo in range(0, ONLINE_ART_CHUNKS * ONLINE_CHUNK, ONLINE_CHUNK)], daemon=True)
    ingest.start()
    proxied = []
    conn = http.client.HTTPConnection("127.0.0.1", proxy_port, timeout=120)
    for k in range(CHAOS_PROXIED):
        t = time.monotonic()
        conn.request("POST", "/models/vw-online", body=held[k],
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        r.read()
        proxied.append((r.status, (time.monotonic() - t) * 1e3))
    conn.close()
    proxied_s = time.monotonic() - t_up
    stop.set()
    for t in threads:
        t.join()
    ingest.join()
    rc = proc.wait(120)
    with open(out_path) as f:
        text = f.read()
    try:
        printed = json.loads(text[text.index("{"):])
    except ValueError:
        raise AssertionError(f"chaos: fleet chaos printed no JSON (rc {rc}): {text[-2000:]}")
    statuses = [s for s, _ in proxied] + [s for _, _, s, _, _ in got]
    return {"rc": rc, "violations": printed["violations"], "schedules": printed["schedules"],
            "journal": [{k: v for k, v in e.items() if k in ("action", "t_rel_s", "violations",
                                                              "signal", "link")}
                        for e in printed["journal"]],
            "proxied_s": proxied_s, "proxied_ms": _quantiles([ms for _, ms in proxied]),
            "requests": len(statuses), "non_200": sum(s != 200 for s in statuses)}


def chaos_phase(smi: str, reg, ports: list, sup, ingest_port: int,
                tune_status: str, online: dict, d: str) -> dict:
    """Phase ``chaos``: ``fleet chaos`` (a process) runs CHAOS_SCENARIO twice with the
    same seed on the online fleet under load; every check of both runs green (the
    laws of CHAOS_LAWS, ``online_conservation`` on the online loop's ingress and
    ``experiment_conservation`` on phase tune's status file among them), every reply
    200, and the proxy's schedule digest the same in both runs."""
    t0 = time.perf_counter()
    held = _held_bodies(online)
    proxy_port = _free_port()   # both runs listen here: the requests' Host header is the same
    runs = {tag: _chaos_run(reg, ports, sup, proxy_port, ingest_port, tune_status, online,
                            held, d, tag) for tag in ("a", "b")}
    fails = []
    for tag, r in runs.items():
        checks = [e.get("violations") for e in r["journal"] if e["action"] == "check"]
        if r["rc"] != 0 or r["violations"] or checks != [0, 0]:
            fails.append(f"run {tag}: rc {r['rc']}, violations {r['violations']}")
        if r["non_200"]:
            fails.append(f"run {tag}: {r['non_200']} of {r['requests']} replies were not 200")
        if r["proxied_s"] >= CHAOS_CLEAR_S:
            fails.append(f"run {tag}: the proxied requests outlasted the rules "
                         f"({r['proxied_s']:.1f} s)")
    if runs["a"]["schedules"] != runs["b"]["schedules"]:
        fails.append(f"the same seed gave other schedules: {runs['a']['schedules']} vs "
                     f"{runs['b']['schedules']}")
    rec = {"nvidia_smi": smi, "scenario": CHAOS_SCENARIO, "laws": CHAOS_LAWS,
           "proxied_requests": CHAOS_PROXIED, "runs": runs,
           "same_schedule": runs["a"]["schedules"] == runs["b"]["schedules"],
           "seconds": time.perf_counter() - t0}
    phase("chaos", **rec)
    if fails:
        raise AssertionError("chaos: " + "; ".join(fails))
    return rec


def continuous(smi: str, kept: dict, online: dict, x, y, x_test, y_test) -> dict:
    """The phases ``online``, ``tune`` and ``chaos`` on what phase ``fleet`` handed
    on (``kept``: its registry and its two supervised ``fleet worker --device
    cuda`` processes, each with an ``--artifact-dir``), with one more worker in
    this process (``fleet.run_worker``, serving ``echo`` until the phases
    publish to it) and ``fleet online``'s loop in this process
    (``fleet.run_online``: logistic, lr 0.5, batch 64, 2^18 weights, a
    publication every 2 s). What they write goes under the fleet's directory;
    the worker and the loop started here are stopped here."""
    from mmlspark_tpu_torch.serving import fleet

    reg, d = kept["reg"], kept["dir"]
    ports = list(kept["ports"])
    inproc = loop_parts = None
    try:
        inproc = fleet.run_worker(reg.url, model="echo", host="127.0.0.1", heartbeat_s=0.5,
                                  artifact_dir=os.path.join(d, "worker_in_art"),
                                  admission_initial_limit=64,
                                  admission_min_target_ms=FLEET_ADMISSION_FLOOR_MS,
                                  device=DEV.type)
        ports.append(inproc[0].port)
        _wait(lambda: len(reg.services("serving")) == 3, ONLINE_BOOT_S,
              "the three workers did not register", "online")
        loop_parts = fleet.run_online(registry_url=reg.url, host="127.0.0.1", port=0,
                                      snapshot_dir=os.path.join(d, "snaps"), heartbeat_s=0.5,
                                      device=DEV.type)
        out = {"online": online_phase(smi, reg, ports, loop_parts, online, d)}
        out["tune"] = tune_phase(smi, reg, ports, x, y, x_test, y_test, d)
        out["chaos"] = chaos_phase(smi, reg, ports, kept["sup"], loop_parts[0]._ingress.port,
                                   out["tune"]["status_file"], online, d)
        return out
    finally:
        if loop_parts is not None:
            loop_parts[2].stop()
        if inproc is not None:
            inproc[2].set()
            inproc[1].stop()
            inproc[0].stop()


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

    binning()
    x_all, y_all = dataset(N + N_TEST)
    x, y, x_test, y_test = x_all[:N], y_all[:N], x_all[N:], y_all[N:]
    runs = {
        "lossguide": fit_main_path(x, y, x_test, y_test, growth_policy="lossguide", max_bin=255),
        "depthwise": fit_main_path(x, y, x_test, y_test, growth_policy="depthwise", max_bin=255),
        "lossguide_b64": fit_main_path(x, y, x_test, y_test, growth_policy="lossguide", max_bin=63),
    }
    gate()
    masked = fused(x, y)
    partitioned(x, y, x_test, y_test, masked)
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
    # the zoo lives under build/ and is removed after
    repo = os.path.join(ROOT, "build", "chip_smoke_zoo")
    shutil.rmtree(repo, ignore_errors=True)
    featurizer(smi, repo)
    pipe_rec = pipeline(x, y, x_test, y_test, repo)
    vw_rec = vw(smi)
    vw_serve = vw_rec.pop("serve")
    serve_rec = serving(smi, repo, runs["lossguide"]["model_string"], vw_serve,
                        pipe_rec["p1_serve"], x_test)
    shutil.rmtree(repo, ignore_errors=True)
    dist_rec = distributed_phase(x, y, x_test, y_test, vw_rec)
    elastic_rec = elastic_phase(smi)
    fleet_rec, kept = fleet_phase(smi, runs["lossguide"]["model_string"], vw_serve, x_test)
    try:
        cont = continuous(smi, kept, vw_serve["online"], x, y, x_test, y_test)
    finally:
        fleet_stop(kept)

    def entry(name, replaces, run, kernel, err, t):
        return {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                "launches": run["launches"][kernel],
                "traced_launches": run["traced_launches"][kernel],
                "max_abs_err": err, "ms": t["ms"],
                "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    kernels = [
        entry("plane_hist (B=256)", f"{TPU}:424 _hist_split_kernel (B2, pallas_call :517)",
              runs["lossguide"], "plane_hist", errs["plane256"], t_plane256),
        entry("plane_hist (B=64)", f"{TPU}:389 _hist_kernel (B1, pallas_call :533)",
              runs["lossguide_b64"], "plane_hist", errs["plane64"], t_plane64),
        entry("multi_plane_hist (S=16)", f"{TPU}:548 _multi_kernel (B3, pallas_call :642)",
              runs["depthwise"], "multi_plane_hist", errs["multi"], t_multi16),
    ]
    # the grad and apply phases run inside vw_pass on the main path: their
    # launches there are vw_pass's, their stand-alone launches (0) beside them
    v2_launches = vw_rec["V2"]["launches"]
    for name, replaces, counted in (
            ("vw_pass", "117-134 (_shard_train's lax.scan over minibatches, compiled by XLA; "
                        "no pallas_call)", "vw_pass"),
            ("vw_grad", "120-123 (_shard_train's lax.scan body, compiled by XLA; no pallas_call)",
             "vw_pass"),
            ("vw_apply", "124-134 (_shard_train's lax.scan body, compiled by XLA; no pallas_call)",
             "vw_pass"),
            ("vw_margin", "337-346 (_predict_margin, compiled by XLA; no pallas_call)",
             "vw_margin")):
        t = vw_rec["times"][name]
        rec = {
            "name": name, "route": "cuda", "source": VW_SOURCE,
            "replaces": f"{VW_TPU}:{replaces}",
            "launches": v2_launches[counted],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library_device_ms": t["library_device_ms"]}
        if name == "vw_margin":
            rec["serving_launches"] = serve_rec["launches"]["vw_margin"]
            # the fleet's in-process worker, on the fleet phase's counted traffic
            rec["fleet_launches"] = fleet_rec["counted"]["launches"]["vw_margin"]
        if name in ("vw_pass", "vw_margin"):
            # phase online's main path: the loop's trainer and the in-process worker
            rec["online_launches"] = cont["online"]["launches"][name]
        if name in ("vw_grad", "vw_apply"):
            rec.update(runs_inside="vw_pass", standalone_launches=v2_launches[name])
        if "chain_floor_ms" in t:
            rec["chain_floor_ms"] = t["chain_floor_ms"]
        if "shapes" in t:
            rec["shapes"] = {m: {key: v[key] for key in (
                "rows", "k", "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
                "library_device_ms", "bound_ms", "share_of_bound", "gather_bound_ms",
                "max_abs_err")}
                for m, v in t["shapes"].items()}
        kernels.append(rec)
    # B4: the fixed-scale entries, timed at world 1 (NCCL, all 200,000 rows); their
    # launches are the world-2 fits' (rank 0; wrappers' and traced), each rank's time
    # beside; the B=64 entry also runs every fit of DIST_FITS
    for name, fit, kernel, src in (
            ("plane_hist_fixed (B=256)", "lossguide", "plane_hist_fixed", "plane"),
            ("plane_hist_fixed (B=64)", "integer_b64", "plane_hist_fixed", "plane"),
            ("multi_plane_hist_fixed (S=16)", "depthwise", "multi_plane_hist_fixed", "multi")):
        t = dist_rec["world1"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"{TPU}:{B4_SOURCE_LINES[src]}",
            "launches": dist_rec["fits"][fit]["launches"][kernel],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "allreduce_ms": t["allreduce_ms"],
            "traced_launches": dist_rec["fits"][fit]["traced_launches"][kernel[:-6]],
            "world2_ranks": dist_rec["world2"][name]})
        if fit != "integer_b64":
            # the elastic gang's members (phase elastic): their own launches
            gang = elastic_rec["gangs"][f"{fit}_ring"]["member"]
            kernels[-1]["gang_launches"] = {n: m["launches"][kernel] for n, m in gang.items()}
        if fit == "lossguide":
            # the voting and streaming gangs' members launch it too
            for key, gang in (("voting_gang_launches", elastic_rec["gangs"]["voting_ring"]),
                              ("streaming_gang_launches",
                               elastic_rec["streaming"]["gangs"]["stream_w2"])):
                kernels[-1][key] = {n: m["launches"][kernel] for n, m in gang["member"].items()}
        if fit == "integer_b64":
            kernels[-1]["new_fits_launches"] = {
                f: {"launches": r["launches"][kernel],
                    "traced_launches": r["traced_launches"][kernel[:-6]]}
                for f, r in dist_rec["new_fits"].items()}
    # phase tune's trials (lossguide, B = 256), from their status files: the wrappers
    # count each trial process's one eager round, not the rounds its CUDA graph replays
    for k in kernels:
        if k["name"] in ("plane_hist (B=256)", "plane_hist_fixed (B=256)"):
            key = k["name"].split(" ")[0]
            k["tune_eager_launches"] = {t: n.get(key, 0)
                                        for t, n in cont["tune"]["launches"].items()}
    phase("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
