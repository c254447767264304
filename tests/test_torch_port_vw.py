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
- ``predict_margin`` bitwise for K <= 17; at K = 25 the stand-alone jit
  sums in another order: within ``WIDE_TOL`` * max |margin|.
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


@pytest.mark.parametrize("k", [9, 16, 17, 25])
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
