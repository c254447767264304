"""Model evaluation and compiled segments sharded over the ranks of a mesh.

``TorchModel`` (an ``apply_fn`` and a two-stage ResNet module), the small
``ImageFeaturizer`` staged and compiled into P3 (``exact=False``), P1
(Featurize -> UDFTransformer -> LogisticRegression) compiled with
``partition_mode="batch"`` at P1b-like row counts (0 to 130 rows, among
them 1, 2 and 3 at world 4, and three partitions), and the partitioner's
search case with a cross-row kernel, run on gloo ranks at worlds 2 and 4
(``tests/torch_port_ranks.py``: one spawn a world, one intra-op thread a
rank) against the same calls in this process (world 1: no group) and
against the JAX package on its 8 virtual CPU devices (``XLAModel``,
``compile(partition_mode="batch")``). The partitioner's plans on the
port's own ``Mesh`` at sizes 2, 4 and 8 are held to the JAX plans.

Tolerances:

- P1 compiled and the search case: bitwise world 1 (values, dtypes,
  columns): each row's bits do not depend on the batch's size
  (``ROADMAP.md`` Queue C, "compiled == staged at every batch size").
- Every rank returns the same bytes.
- TorchModel's ``apply_fn`` (an f32 matrix product, whose rounding follows
  the batch's shape): within 1e-6 * max |world 1|; the ResNet module, P3
  staged and compiled (convolutions at the rank's block shape): within
  1e-4 * max |world 1| per output (``test_torch_port_resnet.py``'s f32
  tolerance).
- Against the JAX package: the ``apply_fn`` within 1e-6 * max |jax| (the
  zoo test's ``rtol``), the ResNet within 1e-4 * max |jax|, P1's logits
  within ``P1_JAX_REL`` * max |logit| and probabilities within
  ``P1_JAX_PROB`` (XLA's and PyTorch's f32 ``tanh`` and XLA's ``x @ W``
  round differently), predictions equal but at near ties.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmlspark_tpu as J
import mmlspark_tpu.compiler as JC
from mmlspark_tpu.featurize.featurize import Featurize as JFeaturize
from mmlspark_tpu.models import XLAModel
from mmlspark_tpu.models import resnet as JR
from mmlspark_tpu.models.linear import LogisticRegression as JLogisticRegression
from mmlspark_tpu.parallel.mesh import make_mesh as j_make_mesh
from mmlspark_tpu.stages.basic import UDFTransformer as JUDFTransformer

import mmlspark_tpu_torch.compiler as PC
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.compiler import FusedSegment, StageKernel, plan_sharding
from mmlspark_tpu_torch.compiler.partitioner import BATCH, REPLICATED
from mmlspark_tpu_torch.parallel import Mesh, process_mesh

sys.path.insert(0, os.path.dirname(__file__))
import torch_port_ranks as R  # noqa: E402

APPLY_REL = 1e-6
F32_REL = 1e-4
P1_JAX_REL = 1e-5
P1_JAX_PROB = 1e-6
WORLDS = (2, 4)


def _perturbed_resnet_variables() -> dict:
    """flax's init of the two-stage ResNet, every leaf moved by a seeded
    numpy draw."""
    v = _jax_resnet().init(jax.random.PRNGKey(0), np.zeros(
        (1, R.EVAL_IMAGE, R.EVAL_IMAGE, 3), np.float32), train=False)
    return R.perturbed(v, 5)


def _jax_resnet():
    return JR.ResNet(stage_sizes=[1, 1], block=JR.BasicBlock, num_classes=3, num_filters=4,
                     dtype=jnp.float32, small_inputs=True)


def _jax_p1():
    cols = R.eval_cols()
    ins = [f"x{i}" for i in range(16)] + ["vec"]
    return J.Pipeline([
        JFeaturize(input_cols=ins, output_col="features"),
        JUDFTransformer(input_col="features", output_col="features_s",
                        vector_udf=lambda x: jnp.tanh(x * jnp.float32(0.5)), jit_compatible=True),
        JLogisticRegression(features_col="features_s", label_col="label", max_iter=15),
    ]).fit(J.DataFrame.from_dict(cols, num_partitions=2))


@pytest.fixture(scope="module")
def case():
    """The shared inputs (the ResNet's variables and P1's fitted params come
    from the JAX package), world 1's outputs here, and the JAX package's."""
    data = R.eval_data()
    data["resnet"] = _perturbed_resnet_variables()
    jp1 = _jax_p1()
    data["p1"] = {name: {k: v for k, _, v in jp1.get("stages")[i].iter_set_params()}
                  for name, i in (("featurize", 0), ("lr", 2))}
    return {"data": data, "world1": R.sharded_eval_outputs(data), "jax_p1": jp1}


@pytest.fixture(scope="module", params=WORLDS, ids=[f"world{w}" for w in WORLDS])
def ranks(request, case, tmp_path_factory):
    world = request.param
    return world, R.run(world, tmp_path_factory.mktemp(f"sharded{world}"),
                        "sharded_eval_suite", case["data"])


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max(initial=0.0)) <= rel * float(np.abs(want).max(initial=0.0))


def _exact(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        assert np.array_equal(got[c], want[c], equal_nan=True), c


# -- plans on the port's Mesh -------------------------------------------------

_ROW = [(("x",), (f"y{i}",), True) for i in range(3)]
_CASES = {
    "propagates_batch": ([(("x",), ("y",), True)], 64, "batch"),
    "cpu_auto_replicates": ([(("x",), ("y",), True)], 64, "auto"),
    "indivisible_bucket": ([(("x",), ("y",), True)], 6, "batch"),
    "search_picks_batch": (_ROW + [(("x",), ("z",), False)], 64, "batch"),
    "search_picks_replicated": (_ROW[:1] + [(("x",), (f"z{i}",), False) for i in range(9)],
                                64, "batch"),
    "replicated_mode": ([(("x",), ("y",), True)], 64, "replicated"),
}


def _kernels(pkg, spec):
    return [pkg.StageKernel(reads=r, writes=w, fn=lambda c: c, row_wise=rw)
            for r, w, rw in spec]


def _mesh(size: int, device: str = "cpu") -> Mesh:
    return Mesh(group=None, rank=0, size=size, device=torch.device(device))


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_plans_on_the_port_mesh_equal_the_jax_plans(name, size):
    spec, bucket, mode = _CASES[name]
    got = plan_sharding(_kernels(PC, spec), mesh=_mesh(size), bucket=bucket, mode=mode)
    want = JC.plan_sharding(_kernels(JC, spec), mesh=j_make_mesh(devices=jax.devices()[:size]),
                            bucket=bucket, mode=mode)
    assert got.decisions == want.decisions
    assert got.searched == want.searched
    assert (got.mesh is None) == (want.mesh is None)
    if name == "indivisible_bucket":  # 6 rows divide by 2, not by 4 or 8
        assert got.decisions["x"] == (BATCH if size == 2 else REPLICATED)


@pytest.mark.parametrize("size", [2, 4, 8])
def test_auto_batch_shards_on_a_cuda_mesh_only(size):
    k = _kernels(PC, [(("x",), ("y",), True)])
    assert plan_sharding(k, mesh=_mesh(size, "cuda"), bucket=64).decisions["x"] == BATCH
    assert plan_sharding(k, mesh=_mesh(size, "cpu"), bucket=64).decisions["x"] == REPLICATED
    assert plan_sharding(k, mesh=_mesh(1, "cuda"), bucket=64).decisions["x"] == REPLICATED


def test_in_specs_on_the_port_mesh():
    k = StageKernel(reads=("x",), writes=("y",), fn=lambda c: c)
    plan = plan_sharding([k], mesh=_mesh(4), bucket=64, mode="batch")
    assert plan.in_specs({"x": np.zeros((8, 3), np.float32)}) == {"x": ("data", None)}
    assert plan.in_specs({"x": np.zeros((2, 3), np.float32)}) == {"x": ()}


def test_without_a_group_the_process_mesh_has_one_rank_and_plans_replicated():
    mesh = process_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))
    assert process_mesh(None).device.type == "cuda"  # named, not resolved: no card needed
    model = R.eval_p1(_p1_params_stub())
    comp = model.compile(partition_mode="batch").build()
    seg = comp.fused_segments[0]
    assert isinstance(seg, FusedSegment) and seg.mesh.size == 1
    assert seg.sharding.mesh is None and set(seg.sharding.decisions.values()) == {REPLICATED}
    out = comp.transform(DataFrame.from_dict(R.eval_cols(n=20)))
    assert sorted(k[0] for k in seg._graphs) == [32]
    assert all(k[-1][0] != "block" for k in seg._graphs)
    assert out["prediction"].shape == (20,)
    assert model.compile(partition_mode="replicated").build().fused_segments[0].mesh is None


def _p1_params_stub() -> dict:
    """P1's params without a fit: Featurize's plans from a port fit, a
    seeded head."""
    from mmlspark_tpu_torch.featurize import Featurize

    cols = R.eval_cols(n=20)
    fm = Featurize(input_cols=[f"x{i}" for i in range(16)] + ["vec"],
                   output_col="features").fit(DataFrame.from_dict(cols))
    rng = np.random.default_rng(1)
    return {"featurize": {"plans": fm.get("plans"), "output_col": "features"},
            "lr": {"features_col": "features_s", "num_classes": 4,
                   "weights": rng.normal(size=(32, 4)).astype(np.float32),
                   "bias": rng.normal(size=(4,)).astype(np.float32)}}


# -- over ranks against world 1 -----------------------------------------------


def test_every_rank_returns_the_same_bytes(ranks):
    world, res = ranks
    assert len(res) == world
    for r in res[1:]:
        for key in ("apply_fn_frame", "module"):
            assert np.asarray(r[key]).tobytes() == np.asarray(res[0][key]).tobytes(), key
        for n in R.EVAL_SIZES:
            _exact(r["p1"][n], res[0]["p1"][n])
            assert r["apply_fn"][n].tobytes() == res[0]["apply_fn"][n].tobytes()
        _exact(r["p3_compiled"], res[0]["p3_compiled"])
        _exact(r["p3_staged"], res[0]["p3_staged"])


def test_torch_model_equals_world_1(ranks, case):
    world, res = ranks
    w1 = case["world1"]
    for r in res:
        for n in R.EVAL_SIZES:
            assert r["apply_fn"][n].shape == (n, 3)
            _close(r["apply_fn"][n], w1["apply_fn"][n], APPLY_REL)
        _close(r["apply_fn_frame"], w1["apply_fn_frame"], APPLY_REL)
        _close(r["module"], w1["module"], F32_REL)


def test_p1_compiled_over_ranks_is_world_1_bitwise(ranks, case):
    world, res = ranks
    w1 = case["world1"]
    for r in res:
        for n in R.EVAL_SIZES:
            _exact(r["p1"][n], w1["p1"][n])
        _exact(r["p1_frame"], w1["p1_frame"])
    assert set(res[0]["p1_decisions"].values()) == {BATCH}
    assert set(w1["p1_decisions"].values()) == {REPLICATED}


def test_p1_graphs_are_keyed_at_the_rank_block(ranks, case):
    world, res = ranks
    for rank, r in enumerate(res):
        blocks = {k[0]: k[-1] for k in r["p1_keys"]}
        # buckets 1, 2, 4, ..., 64: those the world divides run at a block
        assert sorted(blocks) == [1, 2, 4, 8, 16, 32, 64]
        for b, last in blocks.items():
            want = ("block", b // world) if b % world == 0 else None
            assert (last if last[0] == "block" else None) == want, (rank, b, last)
    assert all(k[-1][0] != "block" for k in case["world1"]["p1_keys"])


def test_p3_over_ranks_equals_world_1(ranks, case):
    world, res = ranks
    w1 = case["world1"]
    assert w1["p3_segments"] == res[0]["p3_segments"] == [2]  # featurizer + head fused
    for r in res:
        for key in ("p3_staged", "p3_compiled"):
            assert list(r[key]) == list(w1[key])
            for c in ("features", "raw_prediction", "probability"):
                _close(r[key][c], w1[key][c], F32_REL)
            assert r[key]["features"].shape == (R.EVAL_IMAGES, 8)


def test_search_case_gathers_before_the_cross_row_kernel(ranks, case):
    world, res = ranks
    w1 = case["world1"]
    for r in res:
        for n, want in w1["search"].items():
            _exact(r["search"][n], want)
    plan = res[0]["search_plan"]
    assert plan["decisions"] == {"x": BATCH, "y0": BATCH, "y1": BATCH, "y2": BATCH,
                                 "z": REPLICATED}
    assert [g["chosen"] for g in plan["searched"]] == [BATCH]
    # 8 and 12 rows divide by the world: x cut to the block, gathered for
    # the cross-row kernel; 13 rows run whole on every rank
    assert sorted(k[0] for k in plan["steps"]) == [8, 12]
    for (b, blocks), (per, steps, out_blocks) in plan["steps"].items():
        assert per == b // world and blocks == frozenset({"x"})
        assert list(steps) == [((), ()), ((), ()), ((), ()), (("x",), ())]
        assert out_blocks == ["y0", "y1", "y2"]
    assert w1["search_plan"]["steps"] == {}


def test_mismatched_rows_raise_on_every_rank(ranks):
    world, res = ranks
    for r in res:
        for name in ("torch_model", "compiled"):
            assert r["raised"][name] and "every rank must pass the same rows" in r["raised"][name]


# -- against the JAX package on its 8 virtual devices -------------------------


def test_torch_model_against_xla_model(ranks, case):
    world, res = ranks
    data = case["data"]
    j = XLAModel(input_col="x", output_col="y", batch_size=R.EVAL_BATCH, output_node="y")
    j.set(apply_fn=lambda vs, x: {"y": jnp.tanh(x @ vs["w"] + vs["b"]), "double": x * 2},
          variables={"w": data["w"], "b": data["b"]})
    jm = XLAModel.from_flax(_jax_resnet(), data["resnet"], output_node="pool",
                            input_col="img", output_col="f", batch_size=R.EVAL_BATCH)
    want_module = jm.apply_batch(data["images"].astype(np.float32))
    for r in res:
        for n in R.EVAL_SIZES:
            _close(r["apply_fn"][n], np.asarray(j.apply_batch(data["x"][:n]), np.float32),
                   APPLY_REL)
        _close(r["module"], np.asarray(want_module, np.float32), F32_REL)


def test_p1_against_the_jax_compiled_pipeline(ranks, case):
    world, res = ranks
    comp = case["jax_p1"].compile(partition_mode="batch", max_bucket=R.EVAL_BUCKET)
    cols = R.eval_cols()
    for n in R.EVAL_SIZES:
        if n == 0:
            continue
        want = comp.transform(J.DataFrame.from_dict({c: v[:n] for c, v in cols.items()}))
        got = res[0]["p1"][n]
        assert list(got) == list(want.columns)
        lg, wl = got["raw_prediction"], np.asarray(want["raw_prediction"])
        tol = P1_JAX_REL * float(np.abs(wl).max())
        assert float(np.abs(lg - wl).max()) <= tol, n
        assert float(np.abs(got["probability"] - np.asarray(want["probability"])).max()) \
            <= P1_JAX_PROB, n
        top2 = np.sort(wl, axis=1)[:, -2:]
        off = (got["prediction"] != np.asarray(want["prediction"])) & (
            top2[:, 1] - top2[:, 0] > 2 * tol)
        assert not off.any(), n
