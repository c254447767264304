"""The port's ViT (``models/vit.py``) against the JAX package's.

- named outputs and shapes, the layer names the zoo's schemas carry;
- ``dtype=float32``: every named output within 1e-4 * max|ref| of flax's
  apply on the same weights; the default bf16: relative L2 within 1e-2 per
  output (both packages round at the same points; XLA and PyTorch round
  bf16 softmax and GELU differently inside);
- the seeded init within 4 ulp of flax's ``init_vit`` (XLA's f32 ``log1p``
  inside ``erf_inv`` rounds differently), ViTTiny and ViT-B/16 at full width;
- flax-layout round trips; ``ImageFeaturizer("ViTTiny")`` against the JAX
  featurizer (relative L2 2e-2, as the ResNet featurizers).

The sequence-parallel encoder over ranks is in
``tests/test_torch_port_ring_attention.py``, ViT-B/16's seeded init at full
width in ``tests/test_torch_port_vit_b16.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu import DataFrame as JDataFrame
from mmlspark_tpu.downloader.zoo import BUILTIN_MODELS as J_BUILTIN
from mmlspark_tpu.models import ImageFeaturizer as JImageFeaturizer
from mmlspark_tpu.models.vit import VITS as J_VITS
from mmlspark_tpu.models.vit import ViT as JViT
from mmlspark_tpu.models.vit import init_vit
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.downloader import zoo
from mmlspark_tpu_torch.models import ImageFeaturizer
from mmlspark_tpu_torch.models import vit as V

F32_REL = 1e-4
BF16_L2 = 1e-2
FEAT_L2 = 2e-2
INIT_ULP = 4


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _moved(variables, seed: int) -> dict:
    """Every leaf moved by a seeded numpy draw (a fresh init has zero
    biases and class token, which would hide a layout mix-up)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(size=np.shape(a)) * 0.05).astype(np.float32),
        variables)


def _images(n: int = 3, size: int = 32, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(n, size, size, 3)) * 40).astype(np.float32)


def test_named_outputs_and_shapes():
    model = V.vit_tiny(num_classes=10)
    V.init_flax_variables(model, seed=0)
    with torch.no_grad():
        out = model(torch.from_numpy(_images(2)))
    assert set(out) == set(V.ViT.LAYER_NAMES)
    assert out["patches"].shape == (2, 64, 32)
    assert out["encoder"].shape == (2, 65, 32)
    assert out["pool"].shape == (2, 32) and out["logits"].shape == (2, 10)
    for name in V.ViT.LAYER_NAMES:
        assert out[name].dtype == torch.float32 and torch.isfinite(out[name]).all(), name


@pytest.mark.parametrize("until", ["patches", "encoder", "pool", "logits"])
def test_forward_stops_at_until(until):
    model = V.vit_tiny(num_classes=10)
    V.init_flax_variables(model, seed=0)
    with torch.no_grad():
        full = model(torch.from_numpy(_images(2)))
        cut = model(torch.from_numpy(_images(2)), until=until)
    order = model.output_names()
    assert list(cut) == order[: order.index(until) + 1]
    assert torch.equal(cut[until], full[until])


def test_layer_names_match_both_zoos():
    assert tuple(J_VITS) == tuple(V.VITS)
    assert tuple(zoo._VIT_LAYERS) == V.LAYER_NAMES == tuple(JViT.LAYER_NAMES)
    for name in ("ViTB16", "ViTTiny"):
        assert zoo.BUILTIN_MODELS[name].layer_names == list(V.ViT.LAYER_NAMES)
        assert zoo.BUILTIN_MODELS[name].layer_names == J_BUILTIN[name].layer_names


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [32, 48], ids=["img32", "img48"])
def test_outputs_match_flax(dtype, size):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = _images(3, size)
    jm = J_VITS["ViTTiny"](num_classes=10, dtype=jdt)
    variables = _moved(jm.init(jax.random.PRNGKey(1), x), seed=2)
    want = jm.apply(variables, x)
    model = V.load_flax_variables(V.vit_tiny(num_classes=10, dtype=tdt, image_size=size),
                                  variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for name in V.LAYER_NAMES:
        a, b = np.asarray(want[name], np.float64), got[name].double().numpy()
        assert a.shape == b.shape, name
        if dtype == "float32":
            assert np.abs(a - b).max() <= F32_REL * np.abs(a).max(), name
        else:
            assert _rel_l2(b, a) <= BF16_L2, name


def test_flax_layout_round_trip():
    _, variables = init_vit("ViTTiny", image_size=32, num_classes=10, seed=3)
    variables = _moved(variables, 4)
    model = V.load_flax_variables(V.vit_tiny(num_classes=10), variables)
    back = V.to_flax_variables(model)
    fa = jax.tree_util.tree_flatten_with_path(variables)[0]
    fb = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, a), (_, b) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


def test_from_flax_is_strict():
    _, variables = init_vit("ViTTiny", image_size=32, num_classes=10)
    extra = jax.tree_util.tree_map(np.asarray, variables)
    extra["params"]["block_9"] = {"ln_1": {"scale": np.ones(32, np.float32)}}
    with pytest.raises(KeyError, match="block_9"):
        V.from_flax_variables(V.vit_tiny(num_classes=10), extra)
    missing = jax.tree_util.tree_map(np.asarray, variables)
    del missing["params"]["head"]
    with pytest.raises(KeyError):
        V.from_flax_variables(V.vit_tiny(num_classes=10), missing)


def _ulp_check(want, got) -> None:
    fa = jax.tree_util.tree_flatten_with_path(want)[0]
    fb = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, a), (_, b) in zip(fa, fb):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, path
        ulp = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
        assert int(ulp.max()) <= INIT_ULP, path


@pytest.mark.parametrize("seed,size,classes", [(0, 32, 10), (5, 48, 7)])
def test_seeded_init_equals_flax(seed, size, classes):
    _, want = init_vit("ViTTiny", image_size=size, num_classes=classes, seed=seed)
    got = V.init_flax_variables(V.vit_tiny(num_classes=classes, image_size=size), seed=seed)
    _ulp_check(want, got)


def _featurize(pkg: str, imgs: np.ndarray, tmp_path, **kw) -> np.ndarray:
    if pkg == "jax":
        f = JImageFeaturizer(input_col="image", output_col="f",
                             repo_dir=str(tmp_path / "j"), **kw)
        return f.transform(JDataFrame.from_dict({"image": imgs}))["f"]
    f = ImageFeaturizer(input_col="image", output_col="f", repo_dir=str(tmp_path / "t"),
                        device="cpu", **kw)
    return f.transform(DataFrame.from_dict({"image": imgs}))["f"]


@pytest.mark.parametrize("cut", [0, 1, 2], ids=["logits", "pool", "encoder"])
def test_featurizer_serves_vit_tiny_as_jax(cut, tmp_path):
    """Both zoos materialise ViTTiny's seeded init; both featurizers give
    the same features."""
    imgs = np.random.default_rng(2).integers(0, 255, size=(6, 32, 32, 3), dtype=np.uint8)
    kw = dict(model_name="ViTTiny", cut_output_layers=cut, batch_size=4)
    want = _featurize("jax", imgs, tmp_path, **kw)
    got = _featurize("torch", imgs, tmp_path, **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert _rel_l2(got, want) <= FEAT_L2
