"""The port's seeded ResNet init against flax's, and the zoo's seeded
ResNet-50 featurized by both packages (no checkpoint covers it).

Split from ``tests/test_torch_port_zoo.py`` (its featurize helper and
tolerances), so the test workers can share the two out.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from mmlspark_tpu.models.resnet import init_resnet
from mmlspark_tpu_torch.models import resnet as TR

from test_torch_port_zoo import BF16_L2, INIT_BITWISE, INIT_ULP, _featurize, _rel_l2


# -- flax's seeded init ------------------------------------------------------------------


@pytest.mark.parametrize("variant,kw,size", [
    ("ResNet8", dict(num_classes=10, small_inputs=True, num_filters=16), 32),
    ("ResNet18", dict(num_classes=10, small_inputs=True, num_filters=64), 32),
    ("ResNet50", dict(num_classes=1000), 224),
], ids=["resnet8", "resnet18", "resnet50"])
def test_seeded_init_equals_flax(variant, kw, size):
    """``init_flax_variables(module, seed)`` gives flax's
    ``model.init(PRNGKey(seed))`` numbers (the JAX package's
    ``init_resnet``), ResNet-50 at full width."""
    _, want = init_resnet(variant, image_size=size, seed=5, **kw)
    got = TR.init_flax_variables(TR.RESNETS[variant](**kw), seed=5)
    fa = jax.tree_util.tree_flatten_with_path(want)[0]
    fb = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    same = total = 0
    for (path, a), (_, b) in zip(fa, fb):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, path
        ulp = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
        assert int(ulp.max()) <= INIT_ULP, path
        same += int((a == b).sum())
        total += a.size
    assert same / total >= INIT_BITWISE


def test_seeded_resnet50_features_equal_the_jax_package(tmp_path):
    """No checkpoint covers ResNet-50: both zoos materialise the seeded
    init, and both featurizers give the same pool features (bf16)."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, size=(2, 224, 224, 3), dtype=np.uint8)
    kw = dict(model_name="ResNet50", cut_output_layers=1, batch_size=2)
    want = _featurize("jax", {"image": imgs}, tmp_path, **kw)["f"]
    got = _featurize("torch", {"image": imgs}, tmp_path, **kw)["f"]
    assert got.shape == want.shape == (2, 2048)
    assert _rel_l2(got, want) <= BF16_L2
