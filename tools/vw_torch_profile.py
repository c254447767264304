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

The first line names the card and its power limit. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

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
    for fn in (lib.mmlspark_vw_prof_read, lib.mmlspark_vw_fadd_cycles):
        fn.restype = ctypes.c_int
    lib.mmlspark_vw_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mmlspark_vw_fadd_cycles.argtypes = [ctypes.c_int, ctypes.c_void_p]
    return lib


def fadd_cycles(lib, n: int = 1 << 20) -> dict:
    out = torch.zeros(2, dtype=torch.int64, device=DEV)
    if lib.mmlspark_vw_fadd_cycles(n, out.data_ptr()):
        raise RuntimeError("the fadd timing kernel failed")
    return {"adds": n, "cycles": int(out[0]), "cycles_per_add": int(out[0]) / n}


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


def main() -> None:
    smi = C.card()
    C.build()
    chain = [one_index_apply(b, a) for b in (64, 256, 1024, 4096) for a in (True, False)]
    print(json.dumps({"part": "chain", "runs": chain}), flush=True)
    short = [one_index_apply(b, True, distinct=True) for b in (64, 1024)]
    print(json.dumps({"part": "short", "runs": short}), flush=True)
    rows = v2_like(98 * 1024)
    print(json.dumps({"part": "layouts", **layouts(rows)}), flush=True)
    lib = _profiling_library()
    print(json.dumps({"part": "fadd", **fadd_cycles(lib)}), flush=True)
    print(json.dumps({"part": "phases", **phases(rows, lib)}), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
