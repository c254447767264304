"""The port's seeded ResNet init (``init_flax_variables``) against the
structure and distributions of flax's init of the JAX package's modules:
the same tree, the same seed giving the same numbers, kernels truncated
at two standard deviations of flax's variance scaling, every other leaf
flax's constant.

Split from ``tests/test_torch_port_resnet.py`` (its ``NETS``), so the test
workers can share the two out.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from mmlspark_tpu.models import resnet as JR
from mmlspark_tpu_torch.models import resnet as TR

from test_torch_port_resnet import NETS


@pytest.mark.parametrize("net", sorted(NETS))
def test_seeded_init_has_flax_structure_and_distributions(net):
    variant, kw, size = NETS[net]
    want = JR.RESNETS[variant](**kw).init(
        jax.random.PRNGKey(0), np.zeros((1, size, size, 3), np.float32), train=False)
    got = TR.init_flax_variables(TR.RESNETS[variant](**kw), seed=7)
    again = TR.init_flax_variables(TR.RESNETS[variant](**kw), seed=7)
    fa = jax.tree_util.tree_flatten_with_path(want)[0]
    fb = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, a), (_, b), (_, c) in zip(fa, fb, jax.tree_util.tree_flatten_with_path(again)[0]):
        a = np.asarray(a)
        assert a.shape == b.shape and b.dtype == np.float32, path
        np.testing.assert_array_equal(b, c)  # the same seed, the same numbers
        if path[-1].key == "kernel":  # truncated at 2 std of 1/sqrt(fan_in)/0.8796
            std = (1.0 / np.prod(a.shape[:-1])) ** 0.5 / 0.87962566103423978
            assert np.abs(b).max() <= 2 * std * (1 + 1e-6), path
            if a.size >= 512:
                assert abs(b.std() / a.std() - 1) < 0.2, path
        else:  # scales, biases and statistics are constants in flax's init
            np.testing.assert_array_equal(b, a)
