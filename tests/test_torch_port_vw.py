"""The port's VowpalWabbit slice against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through
``mmlspark_tpu.vw`` and ``mmlspark_tpu_torch.vw``. The JAX learner runs as
its single-device program: ``train_sparse_sgd(..., distributed=False)``, or
the estimators under a one-device mesh (the harness gives JAX 8 virtual CPU
devices, and the estimators would otherwise shard and ``pmean`` per pass).

Tolerances:

- squared, quantile and hinge losses: weights bitwise equal at K = 9, 17
  and 25 (adaptive and not, ``l2`` 0 and 0.01, batch 64 and 1,024 with n
  not a multiple of it, 1 and 3 passes);
- logistic and poisson: bitwise with ``dl`` routed through the JAX
  function; without it, within ``EXP_TOL`` * max |w| (XLA's ``exp`` and
  sigmoid round differently from PyTorch's);
- K = 41: XLA:CPU changes the order of its margin sum, so within
  ``WIDE_TOL`` * max |w|;
- ``predict_margin`` bitwise for K <= 17; at K = 25, 41 and 481 the
  stand-alone jit sums in another order: within ``WIDE_TOL`` * max |margin|.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmlspark_tpu.vw import learner as JL
from mmlspark_tpu_torch.ops import sgd as PS
from mmlspark_tpu_torch.vw import learner as PL

EXP_TOL = 1e-5
WIDE_TOL = 1e-5
BITS = 12


def rows(n, k, seed, loss="squared", bits=BITS):
    """k - 1 random slots (a fifth of them padding zeros; indices repeat
    across rows) and a Constant slot of value 1."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, min(1 << bits, 400), size=(n, k)).astype(np.int64)
    val = (rng.normal(size=(n, k)) * (rng.random((n, k)) < 0.8)).astype(np.float32)
    idx[:, -1], val[:, -1] = 7, 1.0
    y = rng.normal(size=n).astype(np.float32)
    if loss in ("logistic", "hinge"):
        y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    if loss == "poisson":
        y = rng.poisson(2.0, size=n).astype(np.float32)
        val *= np.float32(0.1)
    wt = (rng.random(n) + 0.5).astype(np.float32)
    return idx, val, y, wt


def fit_both(data, **kw):
    idx, val, y, wt = data
    want = np.asarray(JL.train_sparse_sgd(idx, val, y, wt, BITS, distributed=False, **kw))
    got = PL.train_sparse_sgd(idx, val, y, wt, BITS, device="cpu", **kw)
    return got, want


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


# (batch, n, passes, l2): batch 64 and 1,024, n not a multiple of either
CONFIGS = {"b64_3pass_l2": (64, 1000, 3, 0.01), "b1024_1pass": (1024, 2500, 1, 0.0)}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("k", [9, 17, 25])
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("loss", ["squared", "quantile", "hinge"])
def test_learner_weights_bitwise(loss, adaptive, k, config):
    batch, n, passes, l2 = CONFIGS[config]
    got, want = fit_both(rows(n, k, seed=k + n, loss=loss), loss=loss, adaptive=adaptive,
                         batch=batch, num_passes=passes, l2=l2,
                         lr=0.5 if adaptive else 0.05, quantile_tau=0.3)
    assert bits_equal(got, want)
    assert np.count_nonzero(got) > 100


@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("adaptive", [True, False])
def test_learner_l2_sweep_bitwise(adaptive, l2):
    """Both l2 values in every update rule at K = 17, batch 64."""
    got, want = fit_both(rows(700, 17, seed=3), loss="squared", adaptive=adaptive,
                         batch=64, num_passes=2, l2=l2, lr=0.5 if adaptive else 0.05)
    assert bits_equal(got, want)


@pytest.fixture
def jax_dloss(monkeypatch):
    """Route the port's dloss through the JAX package's ``_dloss``, so both
    learners see bitwise-equal loss derivatives."""
    import jax.numpy as jnp

    def dloss(loss, m, y, tau):
        out = JL._dloss(loss, jnp.asarray(m.numpy()), jnp.asarray(y.numpy()),
                        jnp.float32(tau))
        return torch.from_numpy(np.array(out, np.float32))

    monkeypatch.setattr(PS, "dloss_plain", dloss)


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("loss", ["logistic", "poisson"])
def test_exp_losses_bitwise_with_jax_dloss(jax_dloss, loss, adaptive):
    got, want = fit_both(rows(1000, 17, seed=11, loss=loss), loss=loss, adaptive=adaptive,
                         batch=64, num_passes=2, lr=0.5 if adaptive else 0.05, l2=0.01)
    assert bits_equal(got, want)


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("loss", ["logistic", "poisson"])
def test_exp_losses_within_tolerance(loss, adaptive):
    got, want = fit_both(rows(1000, 17, seed=11, loss=loss), loss=loss, adaptive=adaptive,
                         batch=64, num_passes=2, lr=0.5 if adaptive else 0.05)
    assert np.abs(got - want).max() <= EXP_TOL * np.abs(want).max()


def test_wide_rows_within_tolerance():
    got, want = fit_both(rows(1000, 41, seed=41), loss="squared", batch=64, num_passes=2)
    assert np.abs(got - want).max() <= WIDE_TOL * np.abs(want).max()


@pytest.mark.parametrize("k", [9, 16, 17, 25, 41, 481])
def test_predict_margin(k):
    idx, val, _, _ = rows(1024, k, seed=k)
    w = np.random.default_rng(k).normal(size=1 << BITS).astype(np.float32)
    want = np.asarray(JL.predict_margin(idx, val, w))
    got = PL.predict_margin(idx, val, w, device="cpu")
    if k <= 17:
        assert bits_equal(got, want)
    else:
        assert np.abs(got - want).max() <= WIDE_TOL * np.abs(want).max()


@pytest.mark.parametrize("adaptive", [True, False])
def test_chunked_state_equals_one_call(adaptive):
    """Chunks of whole minibatches through train_sparse_sgd_state equal one
    call over the concatenation bit for bit (w, g2 and t), and the JAX
    package's state."""
    idx, val, y, wt = rows(1024, 9, seed=5)
    kw = dict(loss="squared", adaptive=adaptive, batch=64, lr=0.5 if adaptive else 0.05)
    one = PL.train_sparse_sgd_state(idx, val, y, wt, BITS, device="cpu", **kw)
    s = None
    for lo, hi in ((0, 256), (256, 320), (320, 1024)):
        s = PL.train_sparse_sgd_state(idx[lo:hi], val[lo:hi], y[lo:hi], wt[lo:hi], BITS, s,
                                      device="cpu", **kw)
    ref = None
    for lo, hi in ((0, 256), (256, 320), (320, 1024)):
        ref = JL.train_sparse_sgd_state(idx[lo:hi], val[lo:hi], y[lo:hi], wt[lo:hi], BITS,
                                        ref, distributed=False, **kw)
    assert float(s.t) == float(ref.t) == float(one.t) == 16.0
    for a, b, c in ((s.w, one.w, ref.w), (s.g2, one.g2, ref.g2)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert bits_equal(a.numpy(), b.numpy())
        assert bits_equal(a.numpy(), np.asarray(c))


def test_state_is_not_changed_and_init_weights():
    idx, val, y, wt = rows(256, 9, seed=6)
    w0 = np.random.default_rng(0).normal(size=1 << BITS).astype(np.float32) * 0.01
    st = PL.sgd_init(BITS, w0, device="cpu")
    before = st.w.clone()
    out = PL.train_sparse_sgd_state(idx, val, y, wt, BITS, st, loss="squared", device="cpu")
    assert torch.equal(st.w, before) and not torch.equal(out.w, before)
    got, want = fit_both((idx, val, y, wt), loss="squared", initial_weights=w0)
    assert bits_equal(got, want)
    with pytest.raises(ValueError):
        PL.sgd_init(BITS, np.zeros(3, np.float32), device="cpu")


def test_batch_default_follows_the_device():
    idx, val, y, wt = rows(200, 9, seed=2)
    got, want = fit_both((idx, val, y, wt), loss="squared", num_passes=2)  # both 64
    assert bits_equal(got, want)
    with pytest.raises(ValueError):
        PL.train_sparse_sgd(idx, val, y, wt, BITS, loss="nope", device="cpu")


def test_sgd_plan_runs():
    """The plan's runs: padding slots dropped, each run one index of one
    minibatch, its entries in (row, slot) order."""
    idx, val, _, _ = rows(256, 9, seed=8)
    it, vt = torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(val)
    plan = PS.sgd_plan(it, vt, 64, 1 << BITS)
    order, starts, mb = plan.order.long(), plan.run_start.long(), plan.mb_runs.long()
    assert int(starts[-1]) == int((vt != 0).sum())
    assert mb.numel() == 5 and int(mb[0]) == 0 and int(mb[-1]) == starts.numel() - 1
    for b in range(4):
        flat_idx = it[b * 64:(b + 1) * 64].reshape(-1)
        seen = set()
        for r in range(int(mb[b]), int(mb[b + 1])):
            pos = order[starts[r]:starts[r + 1]]
            assert (pos[1:] > pos[:-1]).all()
            ids = flat_idx[pos].unique()
            assert ids.numel() == 1 and int(ids) not in seen
            seen.add(int(ids))
    assert plan.max_runs == int((mb[1:] - mb[:-1]).max())


# Shapes that reach the pass kernel's long runs and its block loop:
# (k, batch, n, seed, where every slot of a row, or every row, takes one index)
LONG_RUN_SHAPES = {
    "k1_every_row_one_index": (1, 256, 700, 21, "rows"),
    "row_on_one_index": (32, 64, 300, 22, "row"),
    "batch_1000": (17, 1000, 2500, 23, None),
    "batch_4096": (9, 4096, 5000, 24, None),
}


def long_run_rows(case, loss="squared"):
    k, batch, n, seed, one = LONG_RUN_SHAPES[case]
    idx, val, y, wt = rows(n, k, seed, loss=loss)
    if one == "rows":      # K = 1, every row on one index: one run the size of the minibatch
        idx[:] = 7
        val[:] = np.where(val == 0, np.float32(0.5), val)
    elif one == "row":     # one row of each minibatch holds a single index in all slots
        idx[5::batch] = 3
        val[5::batch] = np.where(val[5::batch] == 0, np.float32(-0.25), val[5::batch])
    return (idx, val, y, wt), batch


@pytest.mark.parametrize("case", sorted(LONG_RUN_SHAPES))
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("loss", ["squared", "quantile", "hinge"])
def test_learner_weights_bitwise_at_long_runs(loss, adaptive, case):
    data, batch = long_run_rows(case, loss)
    got, want = fit_both(data, loss=loss, adaptive=adaptive, batch=batch, num_passes=2,
                         lr=0.5 if adaptive else 0.05, quantile_tau=0.3)
    assert bits_equal(got, want)
    assert np.count_nonzero(got) >= (1 if case.startswith("k1") else 100)


def apply_by_plan(g, w, g2, step, plan, b, *, lr, eps, adaptive):
    """The pass kernel's apply phase over minibatch b's plan, in numpy f32:
    each run from its stored value, in its order, short and long alike (a
    warp forms a long run's products in parallel and keeps the same chains)."""
    f32 = np.float32
    order, rs, ri = (t.numpy() for t in (plan.order, plan.run_start, plan.run_index))
    lo, hi = int(plan.mb_long[b]), int(plan.mb_long[b + 1])
    longs = set(plan.long_runs[lo:hi].tolist())
    gflat = g.reshape(-1).numpy()
    for r in range(int(plan.mb_runs[b]), int(plan.mb_runs[b + 1])):
        s, e, i = int(rs[r]), int(rs[r + 1]), int(ri[r])
        assert (e - s >= PS.LONG_RUN) == (r in longs)
        gj = gflat[order[s:e]]
        wi = w[i]
        if adaptive:
            acc = g2[i]
            for p in gj * gj:
                acc = f32(acc + p)
            g2[i] = acc
            denom = f32(np.sqrt(acc) + f32(eps))
            upd = (f32(-lr) * gj) / denom
        else:
            upd = -step * gj
        for u in upd:
            wi = f32(wi + u)
        w[i] = wi


@pytest.mark.parametrize("case", sorted(LONG_RUN_SHAPES))
def test_sgd_plan_long_runs(case):
    """The plan's long-run list: every run short or long, never both; long
    runs of at least LONG_RUN entries, in (row, slot) order; run_index and
    meta as the kernel reads them. Applied run by run as the kernel applies
    them, the plan gives the plain version's bits."""
    (idx, val, y, wt), batch = long_run_rows(case)
    n_pad = -(-len(y) // batch) * batch
    pad = n_pad - len(y)
    it = torch.from_numpy(np.concatenate([idx, np.zeros((pad, idx.shape[1]), idx.dtype)])
                          .astype(np.int32))
    vt = torch.from_numpy(np.concatenate([val, np.zeros((pad, val.shape[1]), np.float32)]))
    yt = torch.from_numpy(np.concatenate([y, np.zeros(pad, np.float32)]))
    wtt = torch.from_numpy(np.concatenate([wt, np.zeros(pad, np.float32)]))
    plan = PS.sgd_plan(it, vt, batch, 1 << BITS)
    nb = n_pad // batch
    starts = plan.run_start.long()
    lengths = starts[1:] - starts[:-1]
    longs = plan.long_runs.long()
    assert (lengths[longs] >= PS.LONG_RUN).all()
    short = torch.ones_like(lengths, dtype=torch.bool)
    short[longs] = False
    assert (lengths[short] < PS.LONG_RUN).all()
    assert int(short.sum()) + longs.numel() == lengths.numel()
    assert longs.numel() >= nb - (case == "row_on_one_index")
    order = plan.order.long()
    for b in range(nb):
        flat = it[b * batch:(b + 1) * batch].reshape(-1)
        for r in longs[int(plan.mb_long[b]):int(plan.mb_long[b + 1])].tolist():
            assert int(plan.mb_runs[b]) <= r < int(plan.mb_runs[b + 1])
            pos = order[starts[r]:starts[r + 1]]
            assert (pos[1:] > pos[:-1]).all()
            assert (flat[pos] == plan.run_index[r]).all()
    meta = plan.meta.long()
    assert meta.shape == (nb + 1, 4) and plan.meta.is_contiguous()
    assert torch.equal(meta[:, 0], plan.mb_runs.long())
    assert torch.equal(meta[:, 1], starts[plan.mb_runs.long()])
    assert torch.equal(meta[:, 2], plan.mb_long.long())
    for b in range(nb):   # packed: the minibatch's order, run_start and run_index slices
        r0, r1, e0, e1 = (int(x) for x in (meta[b, 0], meta[b + 1, 0], meta[b, 1], meta[b + 1, 1]))
        assert torch.equal(plan.packed[int(meta[b, 3]):int(meta[b + 1, 3])], torch.cat(
            [plan.order[e0:e1], plan.run_start[r0:r1 + 1], plan.run_index[r0:r1]]))
    assert int(meta[-1, 3]) == plan.packed.numel()
    assert plan.max_entries == int((meta[1:, 1] - meta[:-1, 1]).max())
    for adaptive in (True, False):
        kw = dict(lr=0.5 if adaptive else 0.05, eps=1e-6, adaptive=adaptive)
        steps = torch.from_numpy(PS.step_table(kw["lr"], 0.5, 0.0, nb))
        w, g2 = torch.zeros(1 << BITS), torch.zeros(1 << BITS)
        wn, g2n = w.numpy().copy(), g2.numpy().copy()
        for b in range(nb):
            rows_ = slice(b * batch, (b + 1) * batch)
            g = PS.grad_plain(it[rows_], vt[rows_], yt[rows_], wtt[rows_], torch.from_numpy(wn),
                              loss="squared", tau=0.5, l2=0.0)
            apply_by_plan(g, wn, g2n, steps.numpy()[b], plan, b, **kw)
        PS.sgd_pass_plain(it, vt, yt, wtt, w, g2, None if adaptive else steps, loss="squared",
                          batch=batch, tau=0.5, l2=0.0, **kw)
        assert bits_equal(wn, w.numpy()) and bits_equal(g2n, g2.numpy())


# (batch, k, max_runs, max_entries) -> where g lives: shared memory or device memory
LAYOUTS = {
    "v2_1024x17": (1024, 17, 2000, 13_300, True),
    "b1000x17": (1000, 17, 1900, 13_000, True),
    "b64x17": (64, 17, 800, 900, True),
    "b1024x64": (1024, 64, 9000, 52_000, False),
    "b4096x17": (4096, 17, 9000, 55_000, False),
    "b4096x64": (4096, 64, 30_000, 200_000, False),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_pass_layout_follows_the_shape(case):
    """g lives in shared memory exactly where its batch * K * 4 bytes fit
    beside the kernel's fixed bytes (mbarriers, chain windows); the plan
    slices after it where they fit; 16-byte aligned, within the
    227 KB a block may opt in to; one thread a row or run up to 1,024. The
    same shape gives the same layout."""
    batch, k, runs, entries, g_in_smem = LAYOUTS[case]
    lay = PS.pass_layout(batch, k, runs, entries)
    assert lay == PS.pass_layout(batch, k, runs, entries)
    assert (lay.g_off >= 0) == g_in_smem == (PS.SMEM_FIXED + batch * k * 4 <= PS.SMEM_BYTES)
    assert lay.smem_bytes <= PS.SMEM_BYTES
    sizes = {"g_off": batch * k * 4, "plan_off": (entries + 2 * runs + 1) * 4 + PS.SLACK}
    placed = sorted((getattr(lay, f), sizes[f]) for f in sizes if getattr(lay, f) >= 0)
    end = PS.SMEM_FIXED
    for off, nbytes in placed:
        assert off % 16 == 0 and off >= end
        end = off + nbytes
    assert end <= lay.smem_bytes
    assert lay.threads % 32 == 0 and lay.threads == min(1024, -(-max(batch, runs) // 32) * 32)
    # a cluster only where g is in shared memory, a power of two of blocks of 128 rows or more
    assert lay.ctas in (1, 2, 4, 8) and (lay.ctas == 1 or lay.g_off >= 0)
    assert lay.ctas == 1 or batch // lay.ctas >= PS.CLUSTER_ROWS
    assert lay.ctas == {"v2_1024x17": 8, "b1000x17": 4, "b64x17": 1}.get(case, 1)
    if case in ("v2_1024x17", "b64x17"):   # the main path's shapes: g and the plan staged
        assert lay.plan_off > lay.g_off >= 0


# vw_margin's shapes: (n, K) -> whether the kernel's layout takes every SM
MARGIN_SHAPES = {
    "M1_20000x17": (20_000, 17, True), "M2_20000x481": (20_000, 481, True),
    "M3_1000000x41": (1_000_000, 41, True), "one_row": (1, 1, False),
    "127x9": (127, 9, False), "5000x25": (5_000, 25, True),
    "k_wider_than_a_panel": (300, 5_000, True),
    "k1_rows_past_a_panel": (1_081_345, 1, True),
}


@pytest.mark.parametrize("case", sorted(MARGIN_SHAPES))
def test_margin_layout_follows_the_shape(case):
    """Whole rows a block, every row in one block; a panel of at most
    MARGIN_PER slots a thread, whole rows where K fits beside
    MARGIN_PANEL_ROWS of them, else more than half that many rows (or of the
    block's), one a thread, x equal chunks of K; W and V in shared memory an odd
    number of rows apart, within the 227 KB a block may opt in to, whatever
    K is; a thread a row and no panels where a block holds no more than
    MARGIN_DIRECT_SLOTS (M1); every SM busy where the slots allow it (M1
    included); the same shape gives the same layout."""
    n, k, every_sm = MARGIN_SHAPES[case]
    lay = PS.margin_layout(n, k)
    assert lay == PS.margin_layout(n, k)
    assert lay.blocks * lay.rows >= n > (lay.blocks - 1) * lay.rows
    assert lay.threads % 32 == 0 and lay.blocks <= PS.MARGIN_BLOCKS_PER_SM * PS.H100_SMS
    assert (lay.blocks >= PS.H100_SMS) == every_sm
    if every_sm:   # no block idles below MARGIN_MIN_SLOTS while another has more
        assert lay.rows * k >= PS.MARGIN_MIN_SLOTS or lay.blocks == PS.MARGIN_BLOCKS_PER_SM * 132
    # a block of no more than MARGIN_DIRECT_SLOTS: a thread a row, no panels
    assert lay.direct == (lay.rows * k <= PS.MARGIN_DIRECT_SLOTS
                          and lay.rows <= PS.MARGIN_THREADS)
    if lay.direct:
        assert lay.threads >= lay.rows and lay.smem_bytes == 0
        return
    r, c = lay.panel_rows, lay.chunk
    assert 1 <= r <= lay.rows and 1 <= c <= k and r * c <= PS.MARGIN_PER * lay.threads
    chunks = -(-k // c)
    assert (chunks - 1) * c < k and c - (k - (chunks - 1) * c) < chunks   # equal chunks
    if chunks > 1:   # a thread's chain carries its margin from chunk to chunk
        assert r <= lay.threads and 2 * r > min(lay.rows, PS.MARGIN_PANEL_ROWS)
    groups = -(-lay.rows // r)
    assert (groups - 1) * r < lay.rows and r - (lay.rows - (groups - 1) * r) < groups
    assert lay.stride % 2 == 1 and lay.stride >= r
    assert lay.smem_bytes == 2 * c * lay.stride * 4 <= PS.SMEM_BYTES


def margin_replay(idx, val, w, lay):
    """The kernel's walk on the CPU: each block's rows in groups of
    panel_rows, each group chunk after chunk of K, the chunk's slots in
    order, each row's margin carried from chunk to chunk. Checks that every
    slot is taken once, in its row's order."""
    n, k = idx.shape
    gathered = w[idx.long()]
    m = torch.zeros(n)
    done = torch.zeros(n, dtype=torch.long)
    for b in range(lay.blocks):
        r_hi = min(n, (b + 1) * lay.rows)
        for g0 in range(b * lay.rows, r_hi, lay.panel_rows):
            rs = torch.arange(g0, min(r_hi, g0 + lay.panel_rows))
            for c0 in range(0, k, lay.chunk):
                for j in range(c0, min(k, c0 + lay.chunk)):
                    assert bool((done[rs] == j).all())
                    m[rs] = torch.addcmul(m[rs], gathered[rs, j], val[rs, j])
                    done[rs] += 1
    assert bool((done == k).all())
    return m


# (n, K, MARGIN_PANEL_ROWS, MARGIN_THREADS, SMs): whole rows; K cut into chunks
# (K = 41, 481, 600, 5,000) with groups of rows and with one row a block
MARGIN_REPLAYS = {
    "v2_like": (600, 17, 64, 256, 4), "k41_chunks": (3000, 41, 64, 64, 2),
    "k481_chunks": (24, 481, 64, 256, 1), "k481_small_groups": (40, 481, 8, 32, 2),
    "one_row_a_block_k600": (9, 600, 64, 32, 132), "k5000": (6, 5000, 64, 256, 2),
    "k9_127": (127, 9, 64, 256, 3), "one_row": (1, 1, 64, 256, 132),
}


@pytest.mark.parametrize("case", sorted(MARGIN_REPLAYS))
def test_margin_chunked_chain_equals_plain_bitwise(monkeypatch, case):
    """The kernel's order, replayed in torch with its layout (K cut into
    chunks, each chain carried across), equals ``margin_plain`` bit for bit,
    and the JAX package's ``predict_margin`` where that is bitwise (K <= 17)."""
    n, k, panel_rows, threads, sms = MARGIN_REPLAYS[case]
    monkeypatch.setattr(PS, "MARGIN_DIRECT_SLOTS", 0)   # panels (direct is the plain order)
    monkeypatch.setattr(PS, "MARGIN_PANEL_ROWS", panel_rows)
    monkeypatch.setattr(PS, "MARGIN_THREADS", threads)
    idx, val, _, _ = rows(n, k, seed=n + k)
    val[n // 2] = 0.0   # a row all padding
    idx[n // 2] = 0
    w = np.random.default_rng(k).normal(size=1 << BITS).astype(np.float32)
    it, vt, wt = torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(val), torch.from_numpy(w)
    lay = PS.margin_layout(n, k, sms)
    if k > 17:
        assert lay.chunk < k   # the case cuts K into chunks
    got = margin_replay(it, vt, wt, lay)
    want = PS.margin_plain(it, vt, wt)
    assert bits_equal(got.numpy(), want.numpy())
    if k <= 17:
        assert bits_equal(got.numpy(), np.asarray(JL.predict_margin(idx, val, w)))


def test_step_table_matches_the_jax_schedule():
    import jax
    import jax.numpy as jnp

    def body(t, _):
        return t + 1.0, 0.3 * (1.0 / (1.0 + t)) ** 0.7

    want = np.asarray(jax.jit(lambda t0: jax.lax.scan(body, t0, None, length=3000)[1])(
        jnp.float32(17.0)))
    assert bits_equal(PS.step_table(0.3, 0.7, 17.0, 3000), want)


# -- featurizer and interactions -----------------------------------------------


def _text_frame(mod, n=60, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(40)]
    lists = np.empty(n, dtype=object)
    dicts = np.empty(n, dtype=object)
    for i in range(n):
        lists[i] = list(rng.choice(vocab, 3))
        dicts[i] = {"a": float(rng.normal()), "b": float(i % 3)}
    return mod.DataFrame.from_dict(
        {
            "text": np.array([" ".join(rng.choice(vocab, 8)) for _ in range(n)], dtype=object),
            "cat": np.array([["red", "green", None][i % 3] for i in range(n)], dtype=object),
            "num": rng.normal(size=n) * (rng.random(n) < 0.7),
            "flag": rng.random(n) < 0.5,
            "vec": rng.normal(size=(n, 5)).astype(np.float32),
            "toks": lists,
            "kv": dicts,
            "label": (rng.random(n) < 0.5).astype(np.float64),
        },
        num_partitions=2,
    )


def _jax_and_port():
    import mmlspark_tpu
    import mmlspark_tpu.vw as JV
    import mmlspark_tpu_torch
    import mmlspark_tpu_torch.vw as PV

    return (mmlspark_tpu, JV), (mmlspark_tpu_torch, PV)


def assert_sparse_col_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["i"].dtype == y["i"].dtype and np.array_equal(x["i"], y["i"])
        assert bits_equal(x["v"], y["v"])


FEATURIZER_CASES = {
    "split_text": dict(input_cols=[], string_split_input_cols=["text"]),
    "categorical": dict(input_cols=["cat", "text"]),
    "numeric_vector": dict(input_cols=["num", "flag", "vec"]),
    "lists_dicts": dict(input_cols=["toks", "kv"], seed=3),
    "no_sum_collisions": dict(input_cols=["toks"], string_split_input_cols=["text"],
                              sum_collisions=False, num_bits=4),
}


@pytest.mark.parametrize("case", sorted(FEATURIZER_CASES))
def test_featurizer_rows_equal_the_jax_package(case):
    (J, JV), (P, PV) = _jax_and_port()
    kw = {"num_bits": 14, **FEATURIZER_CASES[case]}
    a = JV.VowpalWabbitFeaturizer(**kw).transform(_text_frame(J))
    b = PV.VowpalWabbitFeaturizer(**kw).transform(_text_frame(P))
    assert_sparse_col_equal(a["features"], b["features"])
    assert a.column_metadata("features") == b.column_metadata("features")


def test_interactions_equal_the_jax_package():
    (J, JV), (P, PV) = _jax_and_port()
    out = []
    for mod, V in ((J, JV), (P, PV)):
        df = V.VowpalWabbitFeaturizer(input_cols=[], string_split_input_cols=["text"],
                                      num_bits=12).transform(_text_frame(mod))
        df = V.VowpalWabbitFeaturizer(input_cols=["toks"], output_col="f2",
                                      num_bits=12).transform(df)
        out.append(V.VowpalWabbitInteractions(input_cols=["features", "f2"],
                                              num_bits=12).transform(df))
    assert_sparse_col_equal(out[0]["interactions"], out[1]["interactions"])


def test_sparse_helpers_equal_the_jax_package():
    from mmlspark_tpu.vw import featurizer as JF
    from mmlspark_tpu.vw import sparse as JS
    from mmlspark_tpu_torch.vw import featurizer as PF
    from mmlspark_tpu_torch.vw import sparse as PSP

    r = np.random.default_rng(4)
    rows_ = [JS.make_sparse(r.integers(0, 50, 6), r.normal(size=6)) for _ in range(9)]
    a = JS.concat_sparse(rows_[:3])
    b = PSP.concat_sparse([PSP.make_sparse(x["i"], x["v"]) for x in rows_[:3]])
    assert_sparse_col_equal([a], [b])
    for mult in (8, 4):
        ja, jv = JS.pad_sparse_batch(rows_, multiple=mult)
        pa, pv = PSP.pad_sparse_batch(rows_, multiple=mult)
        assert np.array_equal(ja, pa) and bits_equal(jv, pv)
    cols = {"a": np.array(rows_[:4], dtype=object), "b": np.array(rows_[4:8], dtype=object)}
    assert_sparse_col_equal(JF.combine_namespaces(cols, ["a", "b"]),
                            PF.combine_namespaces(cols, ["a", "b"]))
    assert PSP.SPARSE_META == JS.SPARSE_META and PSP.NUM_BITS_META == JS.NUM_BITS_META


# -- estimators and the contextual bandit --------------------------------------


@pytest.fixture
def one_device_mesh():
    """The JAX estimators on one device: no per-pass pmean."""
    import jax

    from mmlspark_tpu.parallel import mesh as M

    old = M._default_mesh
    M.set_mesh(M.make_mesh(devices=jax.devices()[:1]))
    yield
    M.set_mesh(old)


def _featurized(mod, V, n=600, seed=1, bits=12):
    rng = np.random.default_rng(seed)
    vocab = np.array([f"w{i}" for i in range(150)], dtype=object)
    texts = np.array([" ".join(rng.choice(vocab, 10)) for _ in range(n)], dtype=object)
    score = np.array([sum(int(t[1:]) % 5 - 2 for t in s.split()) for s in texts], np.float64)
    df = mod.DataFrame.from_dict(
        {"text": texts, "label": (score > 0).astype(np.float64), "y": score / 4.0,
         "w": rng.random(n) + 0.5},
        num_partitions=2,
    )
    return V.VowpalWabbitFeaturizer(input_cols=[], string_split_input_cols=["text"],
                                    num_bits=bits).transform(df)


# (estimator, params, exact): exact = bitwise weights and outputs
ESTIMATOR_CASES = {
    "regressor_adaptive": ("VowpalWabbitRegressor", dict(num_passes=3), True),
    "regressor_power_t": ("VowpalWabbitRegressor",
                          dict(adaptive=False, learning_rate=0.1, l2=0.001), True),
    "regressor_quantile_args": ("VowpalWabbitRegressor",
                                dict(pass_through_args="--loss_function quantile "
                                     "--quantile_tau=0.3 -l 0.3 --passes 2"), True),
    "regressor_weighted_no_constant": ("VowpalWabbitRegressor",
                                       dict(weight_col="w", no_constant=True), True),
    "regressor_bit_precision": ("VowpalWabbitRegressor",
                                dict(pass_through_args="-b 13 --no_adaptive"), True),
    "classifier_hinge": ("VowpalWabbitClassifier",
                         dict(loss_function="hinge", num_passes=2), True),
    "classifier_logistic": ("VowpalWabbitClassifier", dict(num_passes=2), False),
    "regressor_poisson": ("VowpalWabbitRegressor",
                          dict(loss_function="poisson", learning_rate=0.1), False),
}


def _columns_equal(a, b, exact):
    assert sorted(a.columns) == sorted(b.columns)
    for c in a.columns:
        x, y = a[c], b[c]
        if x.dtype == object:
            continue  # inputs, compared by the featurizer test
        if exact or c == "label":
            assert np.array_equal(x, y), c
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=EXP_TOL * max(np.abs(x).max(), 1))


@pytest.mark.parametrize("case", sorted(ESTIMATOR_CASES))
def test_estimators_equal_the_jax_package(one_device_mesh, case, tmp_path):
    name, params, exact = ESTIMATOR_CASES[case]
    (J, JV), (P, PV) = _jax_and_port()
    label = "label" if "Classifier" in name else "y"
    jdf, pdf = _featurized(J, JV), _featurized(P, PV)
    jm = getattr(JV, name)(label_col=label, **params).fit(jdf)
    pm = getattr(PV, name)(label_col=label, device="cpu", **params).fit(pdf)
    jw, pw = np.asarray(jm.get("weights")), np.asarray(pm.get("weights"))
    assert isinstance(pm.get("weights"), np.ndarray)
    assert pm.get("num_bits") == jm.get("num_bits")
    if exact:
        assert bits_equal(pw, jw)
    else:
        assert np.abs(pw - jw).max() <= EXP_TOL * np.abs(jw).max()
    _columns_equal(jm.transform(jdf), pm.transform(pdf), exact)
    jr, pr = jm.get_readable_model(), pm.get_readable_model()
    if exact:
        assert np.array_equal(jr["index"], pr["index"])
        assert np.array_equal(jr["weight"], pr["weight"])
    stats = pm.get_performance_statistics()
    assert int(stats["num_devices"][0]) == 1 and int(stats["rows"][0]) == 600
    pm.save(str(tmp_path / "m"))
    from mmlspark_tpu_torch.core.pipeline import load_stage

    back = load_stage(str(tmp_path / "m"))
    assert type(back) is type(pm) and back.get("device") == "cpu"
    _columns_equal(back.transform(pdf), pm.transform(pdf), True)


def test_pass_through_args_errors_match():
    (J, JV), (P, PV) = _jax_and_port()
    for args in ("--loss_function", "--loss_function nope", "-l="):
        errs = []
        for V, kw in ((JV, {}), (PV, {"device": "cpu"})):
            with pytest.raises(ValueError) as e:
                V.VowpalWabbitRegressor(pass_through_args=args, **kw)._resolve_args()
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    with pytest.raises(ValueError):
        PV.VowpalWabbitRegressor(pass_through_args="-b 4", device="cpu").fit(
            _featurized(P, PV, n=64))


def _bandit_frame(mod, V, n=400, seed=2):
    rng = np.random.default_rng(seed)
    acts = np.empty(n, dtype=object)
    shared = np.empty(n, dtype=object)
    chosen = rng.integers(1, 4, n)
    ctx = rng.integers(0, 2, n)
    for i in range(n):
        acts[i] = [V.make_sparse([100 + a, 200 + 3 * ctx[i] + a], [1.0, 1.0]) for a in range(3)]
        shared[i] = V.make_sparse([5 + ctx[i]], [1.0])
    best = 1 + ctx  # action 1 or 2 is cheap, by context
    cost = np.where(chosen == best, 0.0, 1.0) + rng.normal(size=n) * 0.05
    return mod.DataFrame.from_dict(
        {"shared": shared, "features": acts, "chosen_action": chosen,
         "probability": np.full(n, 1 / 3), "label": cost},
        num_partitions=2,
    )


def test_contextual_bandit_equals_the_jax_package(one_device_mesh, tmp_path):
    (J, JV), (P, PV) = _jax_and_port()
    jdf, pdf = _bandit_frame(J, JV), _bandit_frame(P, PV)
    kw = dict(num_bits=10, num_passes=2)
    jm = JV.VowpalWabbitContextualBandit(**kw).fit(jdf)
    pm = PV.VowpalWabbitContextualBandit(device="cpu", **kw).fit(pdf)
    assert bits_equal(np.asarray(pm.get("weights")), np.asarray(jm.get("weights")))
    jo, po = jm.transform(jdf), pm.transform(pdf)
    assert np.array_equal(jo["prediction"], po["prediction"])
    for a, b in zip(jo["scores"], po["scores"]):
        assert np.array_equal(a, b)
    ctx = np.array([int(s["i"][0]) - 5 for s in pdf["shared"]])
    assert (po["prediction"] == 1 + ctx).mean() > 0.9  # learned the cheap action
    pm.save(str(tmp_path / "cb"))
    from mmlspark_tpu_torch.core.pipeline import load_stage

    back = load_stage(str(tmp_path / "cb"))
    assert np.array_equal(back.transform(pdf)["prediction"], po["prediction"])


def test_contextual_bandit_metrics_equal_the_jax_package():
    (J, JV), (P, PV) = _jax_and_port()
    rng = np.random.default_rng(0)
    ms = [JV.ContextualBanditMetrics(), PV.ContextualBanditMetrics()]
    for _ in range(50):
        args = (rng.random(), rng.random() * 0.9 + 0.1, rng.normal())
        for m in ms:
            m.add(*args)
    assert ms[0].get_ips_estimate() == ms[1].get_ips_estimate()
    assert ms[0].get_snips_estimate() == ms[1].get_snips_estimate()
    assert PV.ContextualBanditMetrics().get_snips_estimate() == 0.0
