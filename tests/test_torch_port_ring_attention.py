"""The port's ring attention against the JAX package's.

``ring_attention`` in the port is the per-rank body of the JAX package's
``shard_map``: each rank passes its block of the sequence. Multi-rank
cases run on gloo ranks spawned once per world size
(``torch_port_ranks.ring_suite``, at 2 and 4); their blocks, in rank
order, are held against the JAX ring on the 8-device CPU mesh (and its
``dense_attention``). World 4 is where a ring turning the wrong way would
show: in a causal run the block offsets set the mask. One-process cases
(the single-shard form) run here.

Tolerances: outputs f32 ``rtol = atol = 2e-5``, as the JAX tests hold the
ring to dense; the long-sequence case 1e-4; gradients 1e-4. A query row
with no visible key is NaN in ``dense_attention`` and 0 in
``ring_attention`` (one shard or many), in both packages.
"""

from __future__ import annotations

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.ring_attention import dense_attention as j_dense
from mmlspark_tpu.ops.ring_attention import ring_attention as j_ring
from mmlspark_tpu_torch.ops import ring_attention as RA

sys.path.insert(0, os.path.dirname(__file__))
import torch_port_ranks as R  # noqa: E402

TOL = 2e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, R.run(world, tmp_path_factory.mktemp(f"ring{world}"), "ring_suite")


def _case_inputs(name: str) -> tuple:
    seed, causal, mk = R.RING_CASES[name]
    q, k, v = R.ring_qkv(seed)
    return q, k, v, causal, None if mk is None else R.ring_mask(*mk)


@functools.lru_cache(maxsize=None)
def _j_case(name: str) -> tuple:
    """The JAX ring's output and gradients of sum(o^2) for a case, on the
    8-device mesh (jitted: eager shard_map dispatch takes ~35 s a case)."""
    q, k, v, causal, mask = _case_inputs(name)
    m = None if mask is None else jnp.asarray(mask)

    def fwd(q, k, v):
        return j_ring(q, k, v, causal=causal, kv_mask=m)

    def loss(q, k, v):
        return (fwd(q, k, v) ** 2).sum()

    args = tuple(map(jnp.asarray, (q, k, v)))
    out = jax.jit(fwd)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _joined(results: list, case: str, key: str) -> np.ndarray:
    return np.concatenate([r[case][key] for r in results], axis=1)


@pytest.mark.parametrize("case", sorted(R.RING_CASES))
def test_ring_blocks_and_grads_match_jax_ring(ranks, case, devices8):
    world, res = ranks
    want, grads = _j_case(case)
    np.testing.assert_allclose(_joined(res, case, "o"), want, rtol=TOL, atol=TOL)
    for key, g in zip(("dq", "dk", "dv"), grads):
        got = _joined(res, case, key)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, g, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=key)


@pytest.mark.parametrize("case", ["plain", "causal", "masked", "causal_masked"])
def test_ring_matches_dense(ranks, case):
    """Every query sees a key: the ring over ranks equals dense attention."""
    _, res = ranks
    q, k, v, causal, mask = _case_inputs(case)
    want = np.asarray(j_dense(*map(jnp.asarray, (q, k, v)), causal=causal,
                              kv_mask=None if mask is None else jnp.asarray(mask)))
    np.testing.assert_allclose(_joined(res, case, "o"), want, rtol=TOL, atol=TOL)


def test_fully_masked_rows_are_zero_with_zero_grads(ranks):
    _, res = ranks
    for key in ("o", "dq", "dk", "dv"):
        got = _joined(res, "all_masked", key)
        assert np.isfinite(got).all() and (got == 0).all(), key


def test_long_sequence_blockwise_stability(ranks):
    world, res = ranks
    q, k, v = R.large_qkv()
    got = np.concatenate([r["large"]["o"] for r in res], axis=1)
    assert np.isfinite(got).all()
    want = np.asarray(j_dense(*map(jnp.asarray, (q, k, v)), causal=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ring_vit_encoder_matches_dense(ranks):
    """ViTTiny with its 65 tokens padded to a multiple of the world size,
    the tail kv-masked, over the ring: the JAX package's dense ViT in f32
    on the same weights, within its own ring test's 2e-4."""
    from mmlspark_tpu.models.vit import vit_tiny

    _, res = ranks
    variables, x = R.vit_ring_inputs()
    want = vit_tiny(num_classes=10, dtype=jnp.float32).apply(variables, jnp.asarray(x))
    for r in res:  # every rank holds the whole output
        for key in ("pool", "logits", "encoder"):
            np.testing.assert_allclose(r["vit"][key], np.asarray(want[key]), rtol=2e-4,
                                       atol=2e-4, err_msg=key)


# -- one process: the single-shard form ---------------------------------------------------


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("case", sorted(R.RING_CASES))
def test_single_shard_matches_jax_ring(case, devices8):
    q, k, v, causal, mask = _case_inputs(case)
    want, grads = _j_case(case)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = RA.ring_attention(tq, tk, tv, causal=causal,
                          kv_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(o.detach().numpy(), want, rtol=TOL, atol=TOL)
    (o ** 2).sum().backward()
    for t, g in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_attention_matches_jax(causal, masked):
    q, k, v = R.ring_qkv(6)
    mask = (np.arange(64)[None, :].repeat(2, 0) < 50) if masked else None
    want = np.asarray(j_dense(*map(jnp.asarray, (q, k, v)), causal=causal,
                              kv_mask=None if mask is None else jnp.asarray(mask)))
    got = RA.dense_attention(*_t(q, k, v), causal=causal,
                             kv_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_padded_equals_unpadded():
    """56 tokens padded to 64 with the tail masked == dense over the 56."""
    b, t_real, t_pad, h, d = 2, 56, 64, 4, 16
    r = np.random.default_rng(4)
    q, k, v = (r.normal(size=(b, t_real, h, d)).astype(np.float32) for _ in range(3))
    pad = ((0, 0), (0, t_pad - t_real), (0, 0), (0, 0))
    mask = np.arange(t_pad)[None, :].repeat(b, 0) < t_real
    got = RA.ring_attention(*_t(*(np.pad(a, pad) for a in (q, k, v))),
                            kv_mask=torch.from_numpy(mask))
    want = np.asarray(j_dense(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got.numpy()[:, :t_real], want, rtol=TOL, atol=TOL)


def test_masked_row_is_nan_in_dense_and_zero_in_ring_in_both_packages(devices8):
    """The edge case the port settles as the reference does: a row with no
    visible key (causal row 0 with key 0 masked) is NaN from dense softmax
    and 0 from the ring's guarded online softmax, in both packages."""
    q, k, v = R.ring_qkv(9)
    mask = np.ones((2, 64), bool)
    mask[:, 0] = False
    jm = jnp.asarray(mask)
    jd = np.asarray(j_dense(*map(jnp.asarray, (q, k, v)), causal=True, kv_mask=jm))
    jr = np.asarray(jax.jit(lambda q, k, v: j_ring(q, k, v, causal=True, kv_mask=jm))(
        *map(jnp.asarray, (q, k, v))))
    pd = RA.dense_attention(*_t(q, k, v), causal=True, kv_mask=torch.from_numpy(mask)).numpy()
    pr = RA.ring_attention(*_t(q, k, v), causal=True, kv_mask=torch.from_numpy(mask)).numpy()
    for dense, ring in ((jd, jr), (pd, pr)):
        assert np.isnan(dense[:, 0]).all() and np.isfinite(dense[:, 1:]).all()
        assert (ring[:, 0] == 0).all()
        np.testing.assert_allclose(ring[:, 1:], dense[:, 1:], rtol=TOL, atol=TOL)
