"""The port's pipeline compiler on the CPU, against its own staged path and
the JAX package's compiler.

The cases of ``tests/test_compiler.py`` that need no module of the
distribution, serving or io slices: the planner's DAG semantics, the
partitioner's decisions (on a stand-in mesh description of 8 CPU
devices), the fuser's exactness, bounded buckets, chunking, guards and
fallback, the critical-path scheduler, and the golden equivalence suite —
compiled output must be **element-wise equal** (values AND dtypes AND
column order) to staged execution. Where both packages build the same
pipeline, the port's plan, segments and schedule are compared with the
JAX package's.

Two contracts hold here that the JAX package's own tests of them do not
meet on XLA:CPU (its logistic head is one ``x @ W`` whose rounding follows
the batch's shape): the bucket-bounded cache at batch sizes 0, 1, 2, 3, 5,
9, 17, 33, 65, 130 and 400 with ``max_bucket=64``, and scoring in chunks of
100, 37, 200, 3 and 160 rows against the whole frame (the chunks are
concatenated here; the streaming DataFrame comes with the io slice).
"""

from __future__ import annotations

import re
import threading
import time

import numpy as np
import pytest
import torch

import mmlspark_tpu as J
import mmlspark_tpu.compiler as JC
from mmlspark_tpu.featurize.featurize import Featurize as JFeaturize
from mmlspark_tpu.models.linear import LogisticRegression as JLogisticRegression
from mmlspark_tpu.stages.basic import UDFTransformer as JUDFTransformer

from mmlspark_tpu_torch import DataFrame, Pipeline, PipelineModel, obs
from mmlspark_tpu_torch.compiler import (
    CompiledPipeline,
    CostModel,
    FusedSegment,
    HostSegment,
    StageKernel,
    build_segments,
    critical_path,
    plan_pipeline,
    plan_sharding,
    schedule_order,
    segment_deps,
    stage_io,
)
from mmlspark_tpu_torch.compiler.partitioner import BATCH, REPLICATED
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.featurize import Featurize
from mmlspark_tpu_torch.models.linear import LinearRegression, LogisticRegression
from mmlspark_tpu_torch.stages import Explode, Lambda, RenameColumn, UDFTransformer

P1B_SIZES = (0, 1, 2, 3, 5, 9, 17, 33, 65, 130, 400)
CHUNKS = (100, 37, 200, 3, 160)


@pytest.fixture(autouse=True)
def _fresh_metrics():
    obs.reset()
    yield


def fallbacks() -> int:
    return sum(int(v) for v in re.findall(
        r"mmlspark_compiler_fallback_total\{[^}]*\} (\d+)", obs.render()))


def assert_exact(staged, compiled) -> None:
    """Element-wise equality: same columns in the same order, same dtypes,
    bit-identical values (object columns compared per element)."""
    assert staged.columns == compiled.columns
    for c in staged.columns:
        a, b = staged[c], compiled[c]
        assert a.dtype == b.dtype, f"{c}: {a.dtype} != {b.dtype}"
        if a.dtype == object:
            assert len(a) == len(b) and all(x == y for x, y in zip(a, b)), c
        else:
            assert np.array_equal(a, b, equal_nan=True), c


def _cols(n=200, seed=0, classes=2) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "a": rng.standard_normal(n),
        "b": rng.standard_normal(n).astype(np.float32),
        "v": rng.standard_normal((n, 5)).astype(np.float32),
        "label": rng.integers(0, classes, n),
    }


def _df(n=200, parts=3, seed=0, classes=2, pkg=None):
    frame = DataFrame if pkg is None else pkg.DataFrame
    return frame.from_dict(_cols(n, seed, classes), num_partitions=parts)


def scale_tanh(x):
    return torch.tanh(x) * 2.0


def _fit_featurize_logistic(df, max_iter=15):
    return Pipeline([
        Featurize(input_cols=["a", "b", "v"], output_col="features"),
        UDFTransformer(input_col="features", output_col="features_s", vector_udf=scale_tanh,
                       jit_compatible=True, device="cpu"),
        LogisticRegression(features_col="features_s", label_col="label", max_iter=max_iter,
                           device="cpu"),
    ]).fit(df)


def _fit_reference(df, max_iter=15):
    import jax.numpy as jnp

    return J.Pipeline([
        JFeaturize(input_cols=["a", "b", "v"], output_col="features"),
        JUDFTransformer(input_col="features", output_col="features_s",
                        vector_udf=lambda x: jnp.tanh(x) * jnp.float32(2.0),
                        jit_compatible=True),
        JLogisticRegression(features_col="features_s", label_col="label", max_iter=max_iter),
    ]).fit(df)


def _structure(comp) -> dict:
    """What the compiler made of a pipeline, in either package."""
    return {
        "plan": [(n.name, n.kind, n.reads, n.writes, sorted(n.deps)) for n in comp.plan.nodes],
        "external": comp.plan.external_inputs,
        "segments": [(type(s).__name__, s.name) for s in comp.segments],
        "order": comp._executor.order(),
        "fused": comp.num_fused_stages,
    }


def _sub(df, n):
    return DataFrame.from_dict({c: df[c][:n] for c in df.columns})


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


def test_planner_linear_chain_matches_the_jax_package():
    model = _fit_featurize_logistic(_df())
    plan = plan_pipeline(model.get("stages"))
    assert [n.kind for n in plan.nodes] == ["fused", "fused", "fused"]
    assert plan.nodes[1].deps == {0} and plan.nodes[2].deps == {1}
    assert set(plan.external_inputs) == {"a", "b", "v"}
    assert plan.all_row_preserving
    ref = _fit_reference(_df(pkg=J))
    assert _structure(model.compile(device="cpu")) == _structure(ref.compile())


def test_planner_opaque_barrier():
    stages = list(_fit_featurize_logistic(_df()).get("stages"))
    stages.insert(1, Lambda.of(lambda d: d))  # declares nothing: barrier
    plan = plan_pipeline(stages)
    lam = plan.nodes[1]
    assert lam.kind == "opaque" and lam.deps == {0}
    assert 1 in plan.nodes[2].deps
    assert plan.final_columns(["a"]) == []  # order unknowable past a barrier


def test_planner_independent_branches():
    df = _df()
    feat_a = Featurize(input_cols=["a"], output_col="fa").fit(df)
    feat_b = Featurize(input_cols=["b"], output_col="fb").fit(df)
    plan = plan_pipeline([feat_a, feat_b])
    assert plan.nodes[0].deps == set() and plan.nodes[1].deps == set()


def test_planner_write_after_read_hazard():
    k1 = StageKernel(reads=("x",), writes=("y",), fn=lambda c: c)
    k2 = StageKernel(reads=("z",), writes=("x",), fn=lambda c: c)

    class S1:
        def fusable_kernel(self):
            return k1

    class S2:
        def fusable_kernel(self):
            return k2

    assert 0 in plan_pipeline([S1(), S2()]).nodes[1].deps


def test_stage_io_explicit_and_param_fallback():
    from mmlspark_tpu_torch.models import TorchModel

    lr = LinearRegression(features_col="f", device="cpu").fit(
        DataFrame.from_dict({"f": np.ones((4, 2), np.float32), "label": [0.0, 1, 0, 1]}))
    assert stage_io(lr) == (("f",), ("prediction",), True)  # pipeline_io: host-bound
    assert plan_pipeline([lr]).nodes[0].kind == "host"
    # no pipeline_io and no kernel: the declared column params
    assert stage_io(TorchModel(input_col="x", output_col="y")) == (("x",), ("y",), True)


@pytest.mark.parametrize("stage", [RenameColumn(input_col="a", output_col="b"),
                                   Explode(input_col="a", output_col="b")],
                         ids=["rename", "explode"])
def test_rename_and_explode_plan_opaque(stage):
    assert stage_io(stage)[2] is False


# ---------------------------------------------------------------------------
# partitioner (a stand-in description of an 8-device CPU mesh: the port keeps
# the plan as data until the distribution slice applies it to ranks)
# ---------------------------------------------------------------------------


class _Mesh:
    devices = np.array([torch.device("cpu")] * 8, dtype=object)


def _mesh8_reference():
    from mmlspark_tpu.parallel.mesh import make_mesh

    return make_mesh()  # conftest forces 8 virtual CPU devices


def _kernels(pkg, spec):
    """Kernels of either package from (reads, writes, row_wise) triples."""
    return [pkg.StageKernel(reads=r, writes=w, fn=lambda c: c, row_wise=rw)
            for r, w, rw in spec]


_ROW = [(("x",), (f"y{i}",), True) for i in range(3)]
_CASES = {
    "propagates_batch": ([(("x",), ("y",), True)], 64, "batch"),
    "cpu_auto_replicates": ([(("x",), ("y",), True)], 64, "auto"),
    "indivisible_bucket_replicates": ([(("x",), ("y",), True)], 4, "batch"),
    "search_picks_batch": (_ROW + [(("x",), ("z",), False)], 64, "batch"),
    "search_picks_replicated": (_ROW[:1] + [(("x",), (f"z{i}",), False) for i in range(9)],
                                64, "batch"),
    "replicated_mode": ([(("x",), ("y",), True)], 64, "replicated"),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_sharding_decisions_match_the_jax_package(case):
    spec, bucket, mode = _CASES[case]
    import mmlspark_tpu_torch.compiler as PC

    got = plan_sharding(_kernels(PC, spec), mesh=_Mesh(), bucket=bucket, mode=mode)
    want = JC.plan_sharding(_kernels(JC, spec), mesh=_mesh8_reference(), bucket=bucket, mode=mode)
    assert got.decisions == want.decisions
    assert got.searched == want.searched
    assert (got.mesh is None) == (want.mesh is None)
    expected = {"propagates_batch": BATCH, "cpu_auto_replicates": REPLICATED,
                "indivisible_bucket_replicates": REPLICATED, "search_picks_batch": BATCH,
                "search_picks_replicated": REPLICATED, "replicated_mode": REPLICATED}[case]
    assert got.decisions["x"] == expected
    assert len(got.searched) == (1 if case.startswith("search") else 0)


def test_in_specs():
    k = StageKernel(reads=("x",), writes=("y",), fn=lambda c: c)
    plan = plan_sharding([k], mesh=_Mesh(), bucket=64, mode="batch")
    assert plan.in_specs({"x": np.zeros((64, 3), np.float32)}) == {"x": ("data", None)}
    # a small bucket the mesh does not divide degrades to replicated
    assert plan.in_specs({"x": np.zeros((4, 3), np.float32)}) == {"x": ()}
    assert plan_sharding([k]).in_specs({"x": np.zeros((4, 3))}) is None  # one card: no mesh


def test_small_batch_runs_fused_without_fallback():
    df = _df(n=40, parts=1)
    model = _fit_featurize_logistic(df)
    comp = model.compile(partition_mode="batch")
    small = _sub(df, 3)
    assert_exact(model.transform(small), comp.transform(small))
    assert fallbacks() == 0


# ---------------------------------------------------------------------------
# fuser
# ---------------------------------------------------------------------------


def test_fused_bucket_cache_is_bounded():
    df = _df(n=400, parts=1)
    model = _fit_featurize_logistic(df)
    comp = model.compile(max_bucket=64)
    seg = comp.fused_segments[0]
    for n in P1B_SIZES:
        sub = _sub(df, n)
        assert_exact(PipelineModel(stages=model.get("stages")).transform(sub),
                     comp.transform(sub))
    # pow2 buckets capped at 64: at most log2(64)+1 = 7 entries
    assert len(seg._graphs) <= 7
    assert sorted(k[0] for k in seg._graphs) == [1, 2, 4, 8, 16, 32, 64]
    assert fallbacks() == 0


@pytest.mark.parametrize("classes", [2, 3])
def test_golden_featurize_linear_chunked_equals_the_whole_frame(classes):
    n = sum(CHUNKS)
    cols = _cols(n, seed=4, classes=classes)
    df = DataFrame.from_dict(cols, num_partitions=1)
    model = _fit_featurize_logistic(df)
    comp = model.compile()
    outs, off = [], 0
    for size in CHUNKS:
        outs.append(comp.transform(DataFrame.from_dict(
            {k: v[off:off + size] for k, v in cols.items()})))
        off += size
    staged = model.transform(df)
    for c in staged.columns:
        got = np.concatenate([o[c] for o in outs])
        assert staged[c].dtype == got.dtype
        assert np.array_equal(staged[c], got), c


@pytest.mark.parametrize("max_bucket", [32, 64])
def test_fused_oversized_partition_chunks(max_bucket):
    df = _df(n=300, parts=1)
    model = _fit_featurize_logistic(df)
    comp = model.compile(max_bucket=max_bucket)  # 300 rows -> 10 or 5 chunks
    assert_exact(model.transform(df), comp.transform(df))
    assert [k[0] for k in comp.fused_segments[0]._graphs] == [max_bucket]


def test_fallback_on_object_column():
    df = DataFrame.from_dict({
        "a": np.array(["x", "y", "z", "w"], dtype=object),
        "b": [1.0, 2.0, 3.0, 4.0],
    })
    model = Pipeline([Featurize(input_cols=["a", "b"], output_col="features")]).fit(df)
    comp = model.compile()
    # one-hot plan on an object column: the stage classifies host-bound
    assert comp.num_fused_stages == 0
    assert_exact(model.transform(df), comp.transform(df))


def test_guard_fallback_to_staged_stays_equal():
    # int64 raw columns: the guard refuses (the 32-bit device world cannot
    # reproduce the staged int64->float64->float32 cast chain) but the
    # staged path handles them — the segment falls back, counted, and stays
    # element-wise equal
    rng = np.random.default_rng(11)
    n = 80
    df = DataFrame.from_dict({
        "a": rng.integers(-10**12, 10**12, n),
        "b": rng.standard_normal(n),
        "v": rng.standard_normal((n, 5)).astype(np.float32),
        "label": rng.integers(0, 2, n),
    }, num_partitions=2)
    model = _fit_featurize_logistic(df)
    comp = model.compile()
    assert comp.num_fused_stages >= 2
    assert_exact(model.transform(df), comp.transform(df))
    assert fallbacks() == 1


def _gbdt(**kw):
    from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier

    return LightGBMClassifier(features_col="features", label_col="label", device="cpu", **kw)


def test_finalize_kernel_closes_fusion_run():
    df = _df(n=120, parts=2)
    model = Pipeline([
        Featurize(input_cols=["a", "b", "v"], output_col="features"),
        _gbdt(num_iterations=5, num_leaves=7),
        UDFTransformer(input_col="probability", output_col="p_scaled",
                       vector_udf=lambda x: x * 1.0, jit_compatible=True, device="cpu"),
    ]).fit(df)
    comp = model.compile()
    # GBDT's finalize (host sigmoid epilogue) ends its segment: the UDF
    # reading `probability` starts a NEW fused segment
    assert len(comp.fused_segments) == 2
    assert_exact(model.transform(df), comp.transform(df))


def test_exact_incapable_kernel_is_host_in_exact_mode():
    k = StageKernel(reads=("x",), writes=("y",), fn=lambda c: c, exact_capable=False)

    class S:
        def fusable_kernel(self):
            return k

    plan = plan_pipeline([S()])
    assert isinstance(build_segments(plan, exact=True)[0], HostSegment)
    assert isinstance(build_segments(plan, exact=False)[0], FusedSegment)


def test_kernels_on_different_devices_start_new_segments():
    def stage(r, w, dev):
        k = StageKernel(reads=(r,), writes=(w,), fn=lambda c: c, device=dev)
        return type("S", (), {"fusable_kernel": lambda self: k})()

    plan = plan_pipeline([stage("a", "b", "cpu"), stage("b", "c", None),
                          stage("c", "d", "cuda"), stage("d", "e", "cuda:0")])
    segs = build_segments(plan)
    assert [len(s.nodes) for s in segs] == [2, 2]
    assert [s.device_name for s in segs] == ["cpu", "cuda"]


def test_a_failing_kernel_raises_instead_of_running_staged():
    class Broken:
        def fusable_kernel(self):
            def fn(cols):
                raise RuntimeError("kernel launch failed")

            return StageKernel(reads=("a",), writes=("c",), fn=fn)

        def transform(self, df):
            return df.with_column("c", lambda p: p["a"])

    comp = CompiledPipeline(stages=[Broken()], device="cpu")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        comp.transform(DataFrame.from_dict({"a": np.arange(4.0)}))
    assert fallbacks() == 0


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    df = _df(n=20, parts=1)
    feats = Featurize(input_cols=["a", "b", "v"], output_col="f").fit(df).transform(df)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UDFTransformer(input_col="f", output_col="g", vector_udf=torch.tanh,
                       jit_compatible=True).transform(feats)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LogisticRegression(features_col="f", label_col="label").fit(feats)
    model = Pipeline([Featurize(input_cols=["a", "b", "v"], output_col="f")]).fit(df)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.compile().transform(df)


@pytest.mark.parametrize("op", [torch.tanh, torch.exp], ids=["tanh", "exp"])
def test_cpu_transcendentals_do_not_depend_on_position(op):
    """The premise of exactness on the CPU: the transcendental ops of the
    fused kernels (the cell's tanh UDF, the head's exp) give an element the
    same bits wherever it lies in an array of any length (PyTorch's
    vectorised loops, their tails and their thread split)."""
    x = torch.from_numpy(
        (np.random.default_rng(0).standard_normal(100_003) * 3).astype(np.float32))
    whole = op(x)
    for n in (1, 7, 17, 1000, 65_537):
        assert torch.equal(op(x[:n]), whole[:n])
    for i in range(0, 2000, 13):
        assert torch.equal(op(x[i:i + 5]), whole[i:i + 5])


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


class _StubSeg:
    def __init__(self, name, nodes):
        self.name = name
        self.nodes = nodes
        self.opaque = False
        self.kernels = ()


def _stub_plan(edges, n):
    from mmlspark_tpu_torch.compiler.planner import StageNode

    nodes = [StageNode(index=i, stage=None, name=f"n{i}", reads=(), writes=(), kernel=None,
                       opaque=False) for i in range(n)]
    for a, b in edges:  # b depends on a
        nodes[b].deps.add(a)
        nodes[a].dependents.add(b)

    class Plan:
        all_row_preserving = True

    plan = Plan()
    plan.nodes = nodes
    return [_StubSeg(f"s{i}", [nodes[i]]) for i in range(n)], plan


def test_critical_path_priorities():
    segs, plan = _stub_plan([(0, 1), (0, 2), (1, 3), (2, 3)], 4)  # diamond, 1 slow
    deps = segment_deps(segs, plan)
    cm = CostModel()
    cm.measured = {"s0": 1.0, "s1": 5.0, "s2": 1.0, "s3": 1.0}
    assert critical_path(segs, deps, cm) == pytest.approx([7.0, 6.0, 2.0, 1.0])
    assert schedule_order(segs, deps, cm) == [0, 1, 2, 3]  # slow branch first


def test_schedule_respects_deps():
    segs, plan = _stub_plan([(1, 0)], 2)
    order = schedule_order(segs, segment_deps(segs, plan), CostModel())
    assert order.index(1) < order.index(0)


def test_cost_model_ewma():
    cm = CostModel(alpha=0.5)
    cm.observe("s", 2.0)
    cm.observe("s", 4.0)
    assert cm.measured["s"] == pytest.approx(3.0)


class SlowHost(Transformer):
    """A host-bound stage (declared I/O, no kernel) that waits: the
    stand-in for an HTTP service."""

    def __init__(self, src="a", dst="s", delay=0.15, log=None):
        super().__init__()
        self.src, self.dst, self.delay, self.log = src, dst, delay, log

    def pipeline_io(self):
        return (self.src,), (self.dst,)

    def transform(self, df):
        def fn(p):
            if self.log is not None:
                self.log.append(threading.get_ident())
            time.sleep(self.delay)
            q = dict(p)
            q[self.dst] = np.asarray(p[self.src], np.float64) * 2
            return q

        return df.map_partitions(fn, parallel=False)


def test_scheduler_overlaps_independent_host_branches():
    df = _df(n=8, parts=1)
    log: list = []
    model = PipelineModel(stages=[SlowHost("a", "s1", log=log), SlowHost("b", "s2", log=log)])
    staged = model.transform(df)
    comp = model.compile()
    assert [type(s).__name__ for s in comp.segments] == ["HostSegment", "HostSegment"]
    log.clear()
    assert_exact(staged, comp.transform(df))
    assert len(set(log)) == 2  # the two services ran on two threads
    assert "mmlspark_compiler_schedule_overlaps_total 2" in obs.render()


def test_row_dropping_stage_pins_original_order(tmp_path):
    from mmlspark_tpu_torch.models import ImageFeaturizer

    feat = ImageFeaturizer(input_col="img", output_col="f", repo_dir=str(tmp_path),
                           device="cpu")  # drop_na=True
    assert not plan_pipeline([feat]).all_row_preserving


# ---------------------------------------------------------------------------
# golden equivalence suite
# ---------------------------------------------------------------------------


def test_golden_featurize_linear_fuses_and_matches():
    df = _df(n=257, parts=3, classes=3)
    model = _fit_featurize_logistic(df)
    comp = model.compile()
    assert comp.num_fused_stages == 3 and len(comp.fused_segments) == 1
    assert_exact(model.transform(df), comp.transform(df))
    ref = _fit_reference(_df(n=257, parts=3, classes=3, pkg=J))
    assert _structure(comp) == _structure(ref.compile())


def _gbdt_pipelines(case):
    """(port PipelineModel, JAX PipelineModel, port df, JAX df)."""
    from mmlspark_tpu.models.gbdt.estimators import LightGBMClassifier as JC_
    from mmlspark_tpu.models.gbdt.estimators import LightGBMRegressor as JR_
    from mmlspark_tpu_torch.models.gbdt import LightGBMRegressor

    if case == "binary":
        cols, ins, lab = _cols(300, 0, 2), ["a", "b", "v"], "label"
        est = dict(num_iterations=12, num_leaves=7)
        port_est, ref_est = _gbdt(**est), JC_(features_col="features", label_col=lab, **est)
    elif case == "multiclass":
        cols, ins, lab = _cols(240, 0, 3), ["a", "b"], "label"
        est = dict(num_iterations=9, num_leaves=7)
        port_est, ref_est = _gbdt(**est), JC_(features_col="features", label_col=lab, **est)
    else:  # poisson: the log-link epilogue rides finalize
        rng = np.random.default_rng(9)
        cols = {"a": rng.standard_normal(150), "b": rng.standard_normal(150),
                "y": np.exp(rng.standard_normal(150) * 0.3)}
        ins, lab = ["a", "b"], "y"
        est = dict(objective="poisson", num_iterations=8, num_leaves=7)
        port_est = LightGBMRegressor(features_col="features", label_col=lab, device="cpu", **est)
        ref_est = JR_(features_col="features", label_col=lab, **est)
    pdf = DataFrame.from_dict(cols, num_partitions=2)
    jdf = J.DataFrame.from_dict(cols, num_partitions=2)
    port = Pipeline([Featurize(input_cols=ins, output_col="features"), port_est]).fit(pdf)
    ref = J.Pipeline([JFeaturize(input_cols=ins, output_col="features"), ref_est]).fit(jdf)
    return port, ref, pdf


@pytest.mark.parametrize("case", ["binary", "multiclass", "poisson"])
def test_golden_featurize_gbdt(case):
    port, ref, df = _gbdt_pipelines(case)
    comp = port.compile()
    assert comp.num_fused_stages == 2  # featurize + gbdt in one segment
    assert len(comp.fused_segments) == 1
    assert_exact(port.transform(df), comp.transform(df))
    assert _structure(comp) == _structure(ref.compile())
    for n in (1, 3, 100):
        assert_exact(port.transform(_sub(df, n)), comp.transform(_sub(df, n)))
    assert fallbacks() == 0


def test_golden_image_zoo_pipeline(tmp_path):
    from mmlspark_tpu_torch.models import ImageFeaturizer
    from mmlspark_tpu_torch.models.linear import LogisticRegressionModel

    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 255, size=(24, 28, 28, 3), dtype=np.uint8)
    df = DataFrame.from_dict({"image": imgs}, num_partitions=2)
    feat = ImageFeaturizer(input_col="image", output_col="features", repo_dir=str(tmp_path),
                           model_name="ResNet8_Digits", cut_output_layers=1, device="cpu")
    d = feat.transform(df)["features"].shape[1]
    lr = LogisticRegressionModel(features_col="features", num_classes=3, device="cpu")
    lr.set(weights=rng.standard_normal((d, 3)).astype(np.float32),
           bias=rng.standard_normal(3).astype(np.float32))
    model = PipelineModel(stages=[feat, lr])
    staged = model.transform(df)

    # exact mode: conv algorithms follow the batch shape, so the zoo stage
    # plans host-bound (exact_capable=False) and equality is exact
    comp = model.compile()
    assert [type(s).__name__ for s in comp.segments] == ["HostSegment", "FusedSegment"]
    assert_exact(staged, comp.transform(df))

    # exact=False: the backbone fuses into the segment; equality relaxes
    # to allclose but hard predictions still agree
    comp2 = model.compile(exact=False)
    assert comp2.num_fused_stages == 2
    out2 = comp2.transform(df)
    np.testing.assert_allclose(out2["features"], staged["features"], rtol=1e-2, atol=1e-2)
    assert np.array_equal(out2["prediction"], staged["prediction"])


def test_golden_host_stage_mid_dag():
    df = _df(n=64, parts=2)
    model = Pipeline([
        Featurize(input_cols=["a", "b", "v"], output_col="features"),
        UDFTransformer(input_col="features", output_col="features_s",
                       vector_udf=lambda x: x * 0.5, jit_compatible=True, device="cpu"),
        SlowHost("a", "svc", delay=0.0),
        LogisticRegression(features_col="features_s", label_col="label", max_iter=10,
                           device="cpu"),
    ]).fit(df)
    comp = model.compile()
    # host stage mid-DAG with fused segments on either side
    assert [type(s).__name__ for s in comp.segments] == [
        "FusedSegment", "HostSegment", "FusedSegment"]
    assert comp.num_fused_stages == 3
    assert_exact(model.transform(df), comp.transform(df))


# ---------------------------------------------------------------------------
# CompiledPipeline surface
# ---------------------------------------------------------------------------


def test_compiled_pipeline_save_load_roundtrip(tmp_path):
    df = _df(n=90, parts=2)
    model = _fit_featurize_logistic(df)
    comp = model.compile(max_bucket=32)
    staged = model.transform(df)
    assert_exact(staged, comp.transform(df))
    comp.save(str(tmp_path / "cp"))
    loaded = CompiledPipeline.load(str(tmp_path / "cp"))
    assert loaded.get("max_bucket") == 32
    assert loaded.num_fused_stages == comp.num_fused_stages
    assert_exact(staged, loaded.transform(df))


def test_explain_reports_plan_segments_schedule():
    comp = _fit_featurize_logistic(_df(n=40, parts=1)).compile()
    text = comp.explain()
    for token in ("== plan ==", "== segments ==", "== schedule ==", "FeaturizeModel",
                  "critical_path", "device: cpu"):
        assert token in text


def test_compile_metrics_exported():
    df = _df(n=50, parts=1)
    comp = _fit_featurize_logistic(df).compile()
    comp.transform(df)
    text = obs.render()
    for fam in (
        "mmlspark_compiler_plan_seconds",
        "mmlspark_compiler_stages_fused_total",
        "mmlspark_compiler_segments_total",
        "mmlspark_compiler_compile_seconds",
        "mmlspark_compiler_segment_latency_seconds",
        "mmlspark_device_seconds_total",
    ):
        assert fam in text, fam
    assert 'mmlspark_compiler_stages_fused_total 3' in text


@pytest.mark.parametrize("n", [0, 1])
def test_compiled_pipeline_transform_empty_and_single_row(n):
    df = _df(n=40, parts=1)
    model = _fit_featurize_logistic(df)
    comp = model.compile()
    sub = _sub(df, n)
    staged, compiled = model.transform(sub), comp.transform(sub)
    assert staged.count() == compiled.count() == n
    assert_exact(staged, compiled)


def test_cross_row_kernel_is_never_padded():
    # a row_wise=False kernel's reduction would see the pow2 pad rows —
    # the fuser must run it at the exact batch shape instead
    class CrossRow:
        def fusable_kernel(self):
            def fn(cols):
                x = cols["a"].to(torch.float32)
                return {"c": x + float(x.shape[0])}

            return StageKernel(reads=("a",), writes=("c",), fn=fn, row_wise=False)

        def transform(self, df):
            def part(p):
                x = np.asarray(p["a"], np.float32)
                q = dict(p)
                q["c"] = x + np.float32(x.shape[0])
                return q
            return df.map_partitions(part)

    df = DataFrame.from_dict({"a": np.random.default_rng(5).standard_normal(37)})
    comp = CompiledPipeline(stages=[CrossRow()], device="cpu")
    seg = comp.fused_segments[0]
    assert not seg.row_wise
    assert_exact(CrossRow().transform(df), comp.transform(df))
    assert [k[0] for k in seg._graphs] == [37]
