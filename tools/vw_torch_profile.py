"""Where the time of VowpalWabbit's pass kernel goes on the card.

    python3 tools/vw_torch_profile.py

Times ``vw_pass`` and its stand-alone phases (``vw_grad_step``,
``vw_apply_step``) in CUDA graphs (``chip_smoke.time_ms``'s device ms) on
rows shaped like ``chip_smoke.py``'s V2 cell: 100,352 rows (98 minibatches
of 1,024) of 12 tokens from a 2,000-word vocabulary hashed into 2^18
weights, 4 padding slots and the Constant (K = 17), labels +-1, logistic
loss, AdaGrad. It prints one JSON line per part:

- ``chain``: the apply phase on K = 1 rows all on one index (one run the
  size of the minibatch, applied by one warp) at batch 64 to 4,096, both
  update rules: ms per run entry, against the chain floor;
- ``short``: the apply phase on K = 1 rows with distinct indices (every
  run one entry, one thread each);
- ``layouts``: the grad phase, the apply phase and whole passes at batch
  1,024 and 64 under each choice of ``ops/sgd.py``'s ``STAGING`` (what is
  kept in shared memory) and ``MAX_CTAS`` (one block, or a cluster that
  forms the gradients), each pass's weights checked bitwise against the
  default's;
- ``fadd``: the SM cycles of one dependent ``__fadd_rn``, timed on one
  thread over 2^20 of them (the unit of the chain floor, which
  ``chip_smoke.py`` takes as 4 cycles);
- ``phases``: one pass at batch 1,024 and 64 through a build of
  ``ops/csrc/sgd.cu`` with ``-DVW_PROFILE``, whose kernel stamps the SM's
  clock at the phase boundaries of every minibatch: mean cycles (and us at
  the clock the pass ran at) of the grad phase (issuing the plan's copies,
  the gathers, thread 0's rows, all of it past the barrier), the apply
  phase (warp 0, which holds the long run; the last thread, short runs)
  and the whole minibatch.

    python3 tools/vw_torch_profile.py --margin [--parent DIR]

profiles the scoring kernel, ``vw_margin``, instead, at its three shapes:
M1 V2-shaped rows (20,000 x 17), M2 newsgroup-length posts (20,000 x 481)
and M3 a million rows x 41 (``chip_smoke.vw_margin_rows``). One JSON line
per part:

- ``margin_shapes`` (with ``--parent``): the kernel of the package unpacked
  at ``DIR`` (``git archive <commit> mmlspark_tpu_torch``; the C interface
  of the one-thread-a-row kernel) and this checkout's, in turns (parent,
  new, new, parent), ms eager and in a CUDA graph, beside ``margin_plain``
  and ``embedding_bag``, each kernel's max |card - CPU plain| and the share
  of the byte bound;
- ``margin_variants``: panel sizes, blocks per SM, and K chunks of several
  widths against whole rows (``ops/sgd.py``'s ``MARGIN_*``), each checked
  bitwise against the default;
- ``fma``: the SM cycles of one dependent ``__fmaf_rn``, the chain's unit;
- ``margin_phases``: one launch at each shape through the ``-DVW_PROFILE``
  build, whose block 0 stamps the SM's clock at each panel's steps: cycles
  of the gathers (with the wait for their rows) and the chains.

The first line names the card and its power limit. Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402  (exits nonzero without a CUDA device)
from mmlspark_tpu_torch.ops import sgd  # noqa: E402

DEV = torch.device("cuda")
BITS, VOCAB, WORDS, K = 18, 2_000, 12, 17
ADAPTIVE = dict(lr=0.5, eps=1e-6, adaptive=True)
# (STAGING, MAX_CTAS): what is kept in shared memory, and the largest cluster
LAYOUTS = {"g_plan": (("g", "plan"), 8), "g_plan_one_block": (("g", "plan"), 1),
           "g_only": (("g",), 8), "g_only_one_block": (("g",), 1)}


def v2_like(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    vocab = rng.choice(1 << BITS, size=VOCAB, replace=False)
    idx = np.zeros((n, K), np.int32)
    val = np.zeros((n, K), np.float32)
    idx[:, :WORDS] = vocab[rng.integers(0, VOCAB, size=(n, WORDS))]
    val[:, :WORDS] = 1.0
    idx[:, -1], val[:, -1] = 11, 1.0
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    return [torch.from_numpy(a).to(DEV) for a in (idx, val, y, np.ones(n, np.float32))]


def one_index_apply(batch: int, adaptive: bool, distinct: bool = False) -> dict:
    idx = (torch.arange(batch, dtype=torch.int32) if distinct
           else torch.full((batch,), 5, dtype=torch.int32)).reshape(batch, 1).to(DEV)
    g = torch.from_numpy(np.random.default_rng(batch).normal(size=(batch, 1))
                         .astype(np.float32)).to(DEV)
    w, g2 = torch.zeros(1 << BITS, device=DEV), torch.ones(1 << BITS, device=DEV)
    plan = sgd.sgd_plan(idx, torch.ones_like(g), batch, 1 << BITS)
    step = torch.full((1,), 0.01, device=DEV)
    kw = dict(ADAPTIVE, adaptive=adaptive)
    _, ms = C.time_ms(lambda: sgd.vw_apply_step(idx, g, w, g2, None if adaptive else step,
                                                plan, **kw))
    longest = int((plan.run_start[1:] - plan.run_start[:-1]).max())
    return {"batch": batch, "adaptive": adaptive, "device_ms": ms, "longest_run": longest,
            "ns_per_entry": ms * 1e6 / batch,
            "chain_floor_ms": C._vw_chain_floor_ms(plan, adaptive, C._sm_clock_hz())}


def layouts(rows) -> dict:
    it, vt, yt, wtt = rows
    d = 1 << BITS
    out, ref = {}, {}
    for batch in (1024, 64):
        plan = sgd.sgd_plan(it, vt, batch, d)
        mb = sgd.sgd_plan(it[:batch], vt[:batch], batch, d)
        w0 = torch.from_numpy(np.random.default_rng(1).normal(size=d).astype(np.float32)
                              * 0.01).to(DEV)
        for name, (order, ctas) in LAYOUTS.items():
            sgd.STAGING, sgd.MAX_CTAS = order, ctas
            lay = sgd.pass_layout(batch, K, plan.max_runs, plan.max_entries)
            w, g2 = torch.zeros(d, device=DEV), torch.zeros(d, device=DEV)
            kw = dict(loss="logistic", batch=batch, tau=0.5, l2=0.0, **ADAPTIVE)
            _, pass_ms = C.time_ms(lambda: sgd.vw_pass(it, vt, yt, wtt, w, g2, None, plan, **kw),
                                   iters=3)
            w.zero_(), g2.zero_()
            sgd.vw_pass(it, vt, yt, wtt, w, g2, None, plan, **kw)
            if name == "g_plan":
                ref[batch] = w.clone()
            rec = {"layout": lay._asdict(), "pass_device_ms": pass_ms,
                   "pass_us_per_minibatch": pass_ms * 1e3 / (it.shape[0] // batch),
                   "bitwise_default": bool(torch.equal(w.view(torch.int32),
                                                       ref[batch].view(torch.int32)))}
            if batch == 1024:
                g = sgd.vw_grad_step(it[:batch], vt[:batch], yt[:batch], wtt[:batch], w0,
                                     loss="logistic", tau=0.5, l2=0.0)
                ws, g2s = w0.clone(), torch.ones(d, device=DEV)
                _, rec["grad_device_ms"] = C.time_ms(lambda: sgd.vw_grad_step(
                    it[:batch], vt[:batch], yt[:batch], wtt[:batch], w0, loss="logistic",
                    tau=0.5, l2=0.0))
                _, rec["apply_device_ms"] = C.time_ms(lambda: sgd.vw_apply_step(
                    it[:batch], g, ws, g2s, None, mb, **ADAPTIVE))
            out[f"{name}_b{batch}"] = rec
    sgd.STAGING, sgd.MAX_CTAS = LAYOUTS["g_plan"]
    return out


def _profiling_library():
    """``sgd.cu`` built with ``-DVW_PROFILE`` beside the real library."""
    from mmlspark_tpu_torch.ops import cuda_build as B

    out = B.build_dir() / "sgd-vw-profile.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([B.nvcc(), *B.NVCC_FLAGS, "-DVW_PROFILE", "-o", str(out),
                    str(B.CSRC / "sgd.cu")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for name in ("prof_read", "mprof_read", "fadd_cycles", "fma_cycles"):
        getattr(lib, f"mmlspark_vw_{name}").restype = ctypes.c_int
    for name in ("prof_read", "mprof_read"):
        getattr(lib, f"mmlspark_vw_{name}").argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name in ("fadd_cycles", "fma_cycles"):
        getattr(lib, f"mmlspark_vw_{name}").argtypes = [ctypes.c_int, ctypes.c_void_p]
    return lib


def chain_cycles(lib, op: str, n: int = 1 << 20) -> dict:
    """The SM cycles of one dependent ``__fadd_rn`` (op "fadd") or
    ``__fmaf_rn`` ("fma") on one thread, over n of them."""
    out = torch.zeros(2, dtype=torch.int64, device=DEV)
    if getattr(lib, f"mmlspark_vw_{op}_cycles")(n, out.data_ptr()):
        raise RuntimeError(f"the {op} timing kernel failed")
    return {"ops": n, "cycles": int(out[0]), "cycles_per_op": int(out[0]) / n}


def phases(rows, lib) -> dict:
    from mmlspark_tpu_torch.ops import cuda_build as B

    real = B.library
    B.library = lambda source: lib if source == "sgd.cu" else real(source)
    it, vt, yt, wtt = rows
    d = 1 << BITS
    out = {}
    try:
        for staging in ("g_plan", "g_plan_one_block"):
            sgd.STAGING, sgd.MAX_CTAS = LAYOUTS[staging]
            for batch in (1024, 64):
                plan = sgd.sgd_plan(it, vt, batch, d)
                nb = it.shape[0] // batch
                w, g2 = torch.zeros(d, device=DEV), torch.zeros(d, device=DEV)
                kw = dict(loss="logistic", batch=batch, tau=0.5, l2=0.0, **ADAPTIVE)
                sgd.vw_pass(it, vt, yt, wtt, w, g2, None, plan, **kw)   # warm
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                sgd.vw_pass(it, vt, yt, wtt, w, g2, None, plan, **kw)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
                n = min(nb, 4096)
                stamps = np.zeros((n, 8), np.int64)
                if lib.mmlspark_vw_prof_read(stamps.ctypes.data, n):
                    raise RuntimeError("reading the clock stamps failed")
                hz = (stamps[-1, 7] - stamps[0, 0]) / (ms / 1e3) if n == nb else None
                steady = stamps[1:]
                cyc = {
                    "plan_copies_issued": steady[:, 1] - steady[:, 0],
                    "grad_gathers": steady[:, 2] - steady[:, 1],
                    "grad_rows_thread0": steady[:, 3] - steady[:, 2],
                    "grad_all": steady[:, 4] - steady[:, 0],
                    "apply_warp0_long_run": steady[:, 5] - steady[:, 4],
                    "apply_last_thread_short_runs": steady[:, 6] - steady[:, 4],
                    "apply_all": steady[:, 7] - steady[:, 4],
                    "minibatch": steady[:, 7] - steady[:, 0],
                }
                rec = {"pass_device_ms": ms, "minibatches": nb, "clock_hz": hz,
                       "layout": sgd.pass_layout(batch, K, plan.max_runs,
                                                 plan.max_entries)._asdict()}
                for name, v in cyc.items():
                    rec[f"{name}_cycles"] = float(v.mean())
                    if hz:
                        rec[f"{name}_us"] = float(v.mean()) / hz * 1e6
                out[f"{staging}_b{batch}"] = rec
    finally:
        B.library = real
        sgd.STAGING, sgd.MAX_CTAS = LAYOUTS["g_plan"]
    return out


# -- the scoring kernel ---------------------------------------------------------


def parent_margin(root: str):
    """Another commit's ``vw_margin`` (the parent's, say): ``sgd.cu`` of the package
    unpacked at ``root`` (``git archive <commit> mmlspark_tpu_torch``), built
    with this checkout's flags beside its library and called through the
    C entry ``mmlspark_vw_margin(idx, val, w, out, n, k, stream)``."""
    from mmlspark_tpu_torch.ops import cuda_build as B

    out = B.build_dir() / "sgd-parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = Path(root) / "mmlspark_tpu_torch" / "ops" / "csrc" / "sgd.cu"
    subprocess.run([B.nvcc(), *B.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).mmlspark_vw_margin
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def margin(idx, val, w):
        m = torch.empty(idx.shape[0], device=idx.device)
        code = fn(idx.data_ptr(), val.data_ptr(), w.data_ptr(), m.data_ptr(), idx.shape[0],
                  idx.shape[1], torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"the parent's vw_margin failed: cudaError {code}")
        return m

    return margin


def margin_case(name: str):
    """vw_margin's inputs at shape ``name`` on the card: M1 V2-shaped rows
    (20,000 x 17, ``v2_like``), M2 and M3 ``chip_smoke.vw_margin_rows``;
    weights from a seed."""
    if name == "M1":
        idx, val = v2_like(20_000, seed=2)[:2]
        w = np.random.default_rng(2).normal(size=1 << BITS).astype(np.float32) * 0.1
        return idx, val, torch.from_numpy(w).to(DEV)
    return [torch.from_numpy(a).to(DEV) for a in C.vw_margin_rows(name)]


def _bits(t) -> torch.Tensor:
    return t.contiguous().view(torch.int32).cpu()


def margin_shapes(parent, new: bool = True) -> dict:
    """At M1-M3: the parent's kernel and this checkout's, in turns (parent,
    new, new, parent; ms eager and in a CUDA graph, ``chip_smoke.time_ms``),
    ``margin_plain`` and ``embedding_bag`` the same two ways, each kernel's
    max |card - CPU plain| (0 = the same bits), and the byte bounds of
    ``chip_smoke.vw_margin_shape``. ``new=False`` times the parent alone
    (its numbers as the record's ``ms`` and ``device_ms``)."""
    out = {}
    for name in ("M1", "M2", "M3"):
        idx, val, w = margin_case(name)
        n, k = idx.shape
        idx64, w1 = idx.long(), w[:, None]
        kernel = (lambda: sgd.vw_margin(idx, val, w)) if new else (lambda: parent(idx, val, w))
        rec = C._timed(kernel,
                       lambda: sgd.margin_plain(idx, val, w),
                       lambda: torch.nn.functional.embedding_bag(
                           idx64, w1, per_sample_weights=val, mode="sum"),
                       n * k * 8 + 4 * int(torch.unique(idx).numel()) + n * 4, n * k * 2)
        rec["gather_bound_ms"] = (n * k * 12 + n * 4) / C.HBM_BYTES_PER_S * 1e3
        cpu = sgd.margin_plain(idx.cpu(), val.cpu(), w.cpu())
        old = parent(idx, val, w).cpu()
        rec.update(rows=n, k=k, padding_share=float((val == 0).float().mean()),
                   parent_max_abs_err=float((old - cpu).abs().max()),
                   parent_bitwise=bool(torch.equal(_bits(old), _bits(cpu))))
        if new:
            turns = [C.time_ms(lambda: parent(idx, val, w)),
                     C.time_ms(lambda: sgd.vw_margin(idx, val, w)),
                     C.time_ms(lambda: sgd.vw_margin(idx, val, w)),
                     C.time_ms(lambda: parent(idx, val, w))]
            got = sgd.vw_margin(idx, val, w).cpu()
            rec.update(
                turns_ms=[t[0] for t in turns], turns_device_ms=[t[1] for t in turns],
                parent_ms=(turns[0][0] + turns[3][0]) / 2,
                parent_device_ms=(turns[0][1] + turns[3][1]) / 2,
                new_ms=(turns[1][0] + turns[2][0]) / 2,
                new_device_ms=(turns[1][1] + turns[2][1]) / 2,
                max_abs_err=float((got - cpu).abs().max()),
                bitwise=bool(torch.equal(_bits(got), _bits(cpu))))
            rec["share_of_bound"] = rec["bound_ms"] / rec["new_device_ms"]
            rec["share_of_gather_bound"] = rec["gather_bound_ms"] / rec["new_device_ms"]
        else:
            rec.update(parent_ms=rec["ms"], parent_device_ms=rec["device_ms"])
        rec["parent_share_of_bound"] = rec["bound_ms"] / rec["parent_device_ms"]
        rec["parent_share_of_gather_bound"] = rec["gather_bound_ms"] / rec["parent_device_ms"]
        out[name] = rec
        del idx, val, w, idx64, w1
        torch.cuda.empty_cache()
    return out


# the scoring kernel's choices: ops/sgd.py's MARGIN_* knobs set apart from the
# defaults: panel sizes (MARGIN_PER slots a thread: 2,048 slots at 128
# threads, 8,192 at 512), blocks per SM, the rows a panel, which sets the
# K chunk where rows are long (at M2, 481 slots: chunks of 241 to 17 slots,
# or whole rows in panels of 8 with MARGIN_PANEL_ROWS 1), and the direct
# path (a thread a row) taken never or wherever a block has a row a thread
MARGIN_KNOBS = ("MARGIN_THREADS", "MARGIN_BLOCKS_PER_SM", "MARGIN_PANEL_ROWS", "MARGIN_MIN_SLOTS",
                "MARGIN_DIRECT_SLOTS")
MARGIN_VARIANTS = {
    "default": {},
    "threads_128": {"MARGIN_THREADS": 128},
    "threads_512": {"MARGIN_THREADS": 512},
    "blocks_per_sm_1": {"MARGIN_BLOCKS_PER_SM": 1},
    "blocks_per_sm_3": {"MARGIN_BLOCKS_PER_SM": 3},
    "blocks_per_sm_4": {"MARGIN_BLOCKS_PER_SM": 4},
    "panel_rows_16": {"MARGIN_PANEL_ROWS": 16},
    "panel_rows_32": {"MARGIN_PANEL_ROWS": 32},
    "panel_rows_128": {"MARGIN_PANEL_ROWS": 128},
    "panel_rows_256": {"MARGIN_PANEL_ROWS": 256},
    "whole_rows": {"MARGIN_PANEL_ROWS": 1},
    "min_slots_4096": {"MARGIN_MIN_SLOTS": 4096},
    "panels_always": {"MARGIN_DIRECT_SLOTS": 0},
    "direct_up_to_a_row_a_thread": {"MARGIN_DIRECT_SLOTS": 1 << 30},
}


@contextlib.contextmanager
def margin_knobs(**knobs):
    saved = {name: getattr(sgd, name) for name in MARGIN_KNOBS}
    try:
        for name, v in knobs.items():
            setattr(sgd, name, v)
        yield
    finally:
        for name, v in saved.items():
            setattr(sgd, name, v)


def margin_variants() -> dict:
    """Each of MARGIN_VARIANTS at M1-M3: its layout, ms eager and in a CUDA
    graph, and whether its margins equal the default's bit for bit."""
    out = {}
    for name in ("M1", "M2", "M3"):
        idx, val, w = margin_case(name)
        n, k = idx.shape
        ref = _bits(sgd.vw_margin(idx, val, w))
        rec = {}
        for variant, knobs in MARGIN_VARIANTS.items():
            with margin_knobs(**knobs):
                lay = sgd.margin_layout(n, k, sgd._sm_count(0))
                ms, dev_ms = C.time_ms(lambda: sgd.vw_margin(idx, val, w))
                same = bool(torch.equal(_bits(sgd.vw_margin(idx, val, w)), ref))
            rec[variant] = {"layout": lay._asdict(), "ms": ms, "device_ms": dev_ms,
                            "bitwise_default": same}
        out[name] = rec
        del idx, val, w
        torch.cuda.empty_cache()
    return out


def margin_phases(lib) -> dict:
    """One launch at M1-M3 (and M1 in panels, M2 in whole rows) through the
    ``-DVW_PROFILE`` build, whose block 0 stamps the SM's clock at each
    panel's steps: mean cycles of thread 0's gathers (and the wait for its
    loads, issued a panel ahead), every thread's (past the barrier), the
    chains and the whole panel, over block 0's panels after the first (the
    first alone beside them), and the launch's device ms (a direct layout
    has no panels: its ms alone)."""
    from mmlspark_tpu_torch.ops import cuda_build as B

    real = B.library
    B.library = lambda source: lib if source == "sgd.cu" else real(source)
    out = {}
    try:
        for name, knobs in (("M1", {}), ("M1_panels", {"MARGIN_DIRECT_SLOTS": 0}), ("M2", {}),
                            ("M3", {}), ("M2_whole_rows", {"MARGIN_PANEL_ROWS": 1})):
            idx, val, w = margin_case(name[:2])
            n, k = idx.shape
            with margin_knobs(**knobs):
                lay = sgd.margin_layout(n, k, sgd._sm_count(0))
                sgd.vw_margin(idx, val, w)  # warm
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                sgd.vw_margin(idx, val, w)
                end.record()
                torch.cuda.synchronize()
            if lay.direct:   # no panels, no stamps
                out[name] = {"device_ms": start.elapsed_time(end), "layout": lay._asdict()}
                continue
            panels = min(-(-min(lay.rows, n) // lay.panel_rows) * -(-k // lay.chunk), 4096)
            stamps = np.zeros((panels, 4), np.int64)
            if lib.mmlspark_vw_mprof_read(stamps.ctypes.data, panels):
                raise RuntimeError("reading the clock stamps failed")
            steps = {"gathers_thread0": stamps[:, 1] - stamps[:, 0],
                     "gathers_all": stamps[:, 2] - stamps[:, 0],
                     "chains": stamps[:, 3] - stamps[:, 2],
                     "panel": stamps[:, 3] - stamps[:, 0]}
            rec = {"device_ms": start.elapsed_time(end), "layout": lay._asdict(),
                   "block0_panels": panels, "block0_cycles": int(stamps[-1, 3] - stamps[0, 0])}
            for step, v in steps.items():
                rec[f"{step}_cycles_first"] = int(v[0])
                rec[f"{step}_cycles"] = float(v[1:].mean()) if panels > 1 else None
            out[name] = rec
            del idx, val, w
            torch.cuda.empty_cache()
    finally:
        B.library = real
    return out


def margin_main(parent_root: "str | None") -> None:
    from mmlspark_tpu_torch.ops import cuda_build as B

    smi = C.card()
    C.build()
    log = B.build_logs.get("sgd.cu", "").splitlines()
    at = [i for i, ln in enumerate(log) if "Compiling entry" in ln and "vw_margin_kernel" in ln]
    print(json.dumps({"part": "ptxas", "vw_margin_kernel": log[at[0]:at[0] + 4] if at else None}),
          flush=True)
    if parent_root:
        shapes = margin_shapes(parent_margin(parent_root))
        print(json.dumps({"part": "margin_shapes", "parent": parent_root, **shapes}), flush=True)
    print(json.dumps({"part": "margin_variants", **margin_variants()}), flush=True)
    lib = _profiling_library()
    print(json.dumps({"part": "fma", **chain_cycles(lib, "fma")}), flush=True)
    print(json.dumps({"part": "margin_phases", **margin_phases(lib)}), flush=True)
    print(smi)


def main() -> None:
    if "--margin" in sys.argv:
        at = sys.argv.index("--parent") + 1 if "--parent" in sys.argv else None
        margin_main(sys.argv[at] if at else None)
        return
    smi = C.card()
    C.build()
    chain = [one_index_apply(b, a) for b in (64, 256, 1024, 4096) for a in (True, False)]
    print(json.dumps({"part": "chain", "runs": chain}), flush=True)
    short = [one_index_apply(b, True, distinct=True) for b in (64, 1024)]
    print(json.dumps({"part": "short", "runs": short}), flush=True)
    rows = v2_like(98 * 1024)
    print(json.dumps({"part": "layouts", **layouts(rows)}), flush=True)
    lib = _profiling_library()
    print(json.dumps({"part": "fadd", **chain_cycles(lib, "fadd")}), flush=True)
    print(json.dumps({"part": "phases", **phases(rows, lib)}), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
