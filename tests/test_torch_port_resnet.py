"""The port's ResNet backbones against the JAX package's flax modules.

Same seeded numpy weights and inputs through ``mmlspark_tpu.models.resnet``
and ``mmlspark_tpu_torch.models.resnet`` on the CPU, every named output
compared. Every parameter and batch statistic is perturbed from a seeded
numpy draw first: a fresh init zeroes the last batch norm of each block, so
its residual branches would output 0 and hide the convs behind them.

Tolerances: float32, max |port - jax| <= 1e-4 * max |jax| per output (the
two only sum in another order); bfloat16, relative L2 <= 1e-2 per output
(the rounding points are the same, so a single rounded value that flips
by one bf16 ulp, 2^-8 relative, is what this allows to spread).

The seeded init's structure and distributions are checked in
``tests/test_torch_port_resnet_init.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import resnet as JR
from mmlspark_tpu_torch.models import resnet as TR

F32_TOL = 1e-4
BF16_L2 = 1e-2

# (variant, constructor kwargs, input size): ResNet-8 as the digits zoo
# entry has it, ResNet-18 with the full stem, and a ResNet-50-structured
# net (bottlenecks, full stem) at 4 filters
NETS = {
    "resnet8": ("ResNet8", dict(num_classes=10, small_inputs=True), 32),
    "resnet18": ("ResNet18", dict(num_classes=7, num_filters=8), 64),
    "resnet50": ("ResNet50", dict(num_classes=5, num_filters=4), 64),
}


@pytest.fixture(scope="module")
def flax_init():
    """flax's ``init`` of a module at an input size, made once a module:
    its variables depend on neither ``dtype`` (the computation's; params
    are f32) nor ``torch_padding``, so those share one init."""
    cache: dict = {}

    def init(module, size):
        key = (type(module).__name__, size, tuple(
            (f.name, repr(getattr(module, f.name))) for f in dataclasses.fields(module)
            if f.name not in ("dtype", "torch_padding", "parent", "name")))
        if key not in cache:
            cache[key] = module.init(jax.random.PRNGKey(0),
                                     np.zeros((1, size, size, 3), np.float32), train=False)
        return cache[key]

    return init


def perturbed_variables(module, size, seed, init):
    """flax init of ``module`` (``init``: the ``flax_init`` fixture), every
    leaf moved by a seeded numpy draw; variances kept positive."""
    v = init(module, size)
    rng = np.random.default_rng(seed)

    def move(tree, key=None):
        if isinstance(tree, dict):
            return {k: move(x, k) for k, x in tree.items()}
        a = np.asarray(tree, np.float32)
        a = a + rng.normal(size=a.shape).astype(np.float32) * 0.1 * (np.abs(a).mean() + 0.1)
        return np.abs(a) + 0.5 if key == "var" else a

    return {"params": move(v["params"]), "batch_stats": move(v["batch_stats"])}


def assert_outputs_close(got: dict, want: dict, dtype: str) -> None:
    assert list(got) == list(want)
    for k in want:
        a = np.asarray(want[k], np.float32)
        b = got[k].float().numpy()
        assert b.shape == a.shape, (k, b.shape, a.shape)
        assert np.isfinite(b).all(), k
        if dtype == "f32":
            err = float(np.abs(a - b).max())
            assert err <= F32_TOL * float(np.abs(a).max()), (k, err)
        else:
            rel = float(np.linalg.norm(a - b) / np.linalg.norm(a))
            assert rel <= BF16_L2, (k, rel)


@pytest.mark.parametrize("torch_padding", [False, True], ids=["same", "torch_padding"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_named_outputs_match_flax(flax_init, net, dtype, torch_padding):
    variant, kw, size = NETS[net]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    fm = JR.RESNETS[variant](dtype=jdt, torch_padding=torch_padding, **kw)
    variables = perturbed_variables(fm, size, seed=1, init=flax_init)
    x = np.random.default_rng(2).normal(size=(3, size, size, 3)).astype(np.float32)
    want = fm.apply(variables, jnp.asarray(x), train=False)
    tm = TR.load_flax_variables(TR.RESNETS[variant](dtype=tdt, torch_padding=torch_padding, **kw),
                                variables).eval()
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert_outputs_close(got, dict(want), dtype)


@pytest.mark.parametrize("until", ["stem", "layer2", "pool"])
def test_forward_stops_at_the_requested_output(flax_init, until):
    variant, kw, size = NETS["resnet18"]
    fm = JR.RESNETS[variant](dtype=jnp.float32, **kw)
    variables = perturbed_variables(fm, size, seed=3, init=flax_init)
    tm = TR.load_flax_variables(TR.RESNETS[variant](dtype=torch.float32, **kw), variables)
    blocks_run = []
    for blk in tm.blocks:
        blk.register_forward_hook(lambda *a: blocks_run.append(1))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, size, size, 3)).astype(np.float32))
    with torch.inference_mode():
        out = tm(x, until=until)
        ran = len(blocks_run)
        full = tm(x)
    names = tm.output_names()
    assert list(out) == names[: names.index(until) + 1]
    assert ran == {"stem": 0, "layer2": 4, "pool": 8}[until]
    for k in out:
        assert torch.equal(out[k], full[k])


@pytest.mark.parametrize("net", sorted(NETS))
def test_flax_variables_round_trip(flax_init, net):
    variant, kw, size = NETS[net]
    fm = JR.RESNETS[variant](dtype=jnp.float32, **kw)
    variables = perturbed_variables(fm, size, seed=5, init=flax_init)
    tm = TR.load_flax_variables(TR.RESNETS[variant](**kw), variables)
    back = TR.to_flax_variables(tm)
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_loading_rejects_a_tree_of_another_architecture(flax_init):
    variant, kw, size = NETS["resnet18"]
    variables = perturbed_variables(JR.RESNETS[variant](**kw), size, seed=6, init=flax_init)
    with pytest.raises(KeyError):
        TR.load_flax_variables(TR.resnet34(**kw), variables)
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros(1)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        TR.load_flax_variables(TR.RESNETS[variant](**kw), extra)
