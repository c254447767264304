"""The port's BiLSTM tagger (``models/sequence.py``) against the JAX
package's.

- On carried weights (the JAX model's flax tree loaded into the port):
  ``logits`` at every position and ``hidden`` at valid positions within
  1e-5 relative (to the output's max |.|), ``embedded`` exactly, pad
  positions' logits exactly ``-1e9`` with tag 0 at 0, with and without
  lengths; ``flip_sequences`` exactly flax's.
- ``train_tagger``: one Adam step from the same weights within 1e-5
  relative L2 per leaf (measured 7e-7): Adam's first step is ``lr * g /
  (|g| + eps)``, so an entry whose gradient is below eps (2e-9 at the
  worst entry) turns the two packages' last-bit gradient differences into
  update differences of ~1e-5 of the leaf's max; the loss after 10 steps within 1e-3
  relative of optax's (``torch.optim.Adam`` and optax's Adam compute the
  same update with different rounding, so the fits are held by loss and
  quality, not bits); from the port's own init, the JAX test's accuracy
  bar (> 0.9 on valid positions after 150 steps).
- ``packed_apply_fn`` through ``TorchModel`` against ``XLAModel``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.linen.recurrent import flip_sequences as j_flip

from mmlspark_tpu import DataFrame as JDataFrame
from mmlspark_tpu.models import XLAModel
from mmlspark_tpu.models.sequence import BiLSTMTagger as JTagger
from mmlspark_tpu.models.sequence import pack_lengths as j_pack
from mmlspark_tpu.models.sequence import train_tagger as j_train
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.models import TorchModel
from mmlspark_tpu_torch.models import sequence as S

REL = 1e-5
LOSS_REL = 1e-3


def _task(n=64, t=12, vocab=50, seed=0):
    """tests/test_sequence.py's task: tokens >= 40 are tag 1; the token
    after trigger token 5 is tag 2; else 0."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (n, t))
    tags = np.where(tokens >= 40, 1, 0)
    trig = np.zeros_like(tokens)
    trig[:, 1:] = tokens[:, :-1] == 5
    tags = np.where(trig.astype(bool) & (tags == 0), 2, tags)
    lens = rng.integers(6, t + 1, (n,))
    return tokens, tags, lens


def _j_vars(tokens, lens, seed=0, **kw):
    model = JTagger(vocab_size=50, num_tags=3, **kw)
    vs = model.init(jax.random.PRNGKey(seed), jnp.asarray(tokens[:1]), jnp.asarray(lens[:1]))
    return model, jax.tree_util.tree_map(np.asarray, vs)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_flip_sequences_is_flax():
    x = np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32)
    lens = np.array([0, 1, 3, 7, 5])
    for lengths in (lens, None):
        want = np.asarray(j_flip(jnp.asarray(x), None if lengths is None else jnp.asarray(lengths),
                                 num_batch_dims=1, time_major=False))
        got = S.flip_sequences(torch.from_numpy(x),
                               None if lengths is None else torch.from_numpy(lengths))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_lengths", [True, False], ids=["lengths", "no_lengths"])
@pytest.mark.parametrize("widths", [(64, 64), (16, 8)], ids=["ref_widths", "narrow"])
def test_outputs_match_flax_on_carried_weights(with_lengths, widths):
    tokens, _, lens = _task(n=16, t=12, seed=1)
    model, vs = _j_vars(tokens, lens, embed_dim=widths[0], hidden_dim=widths[1])
    sl = lens if with_lengths else None
    want = model.apply(vs, jnp.asarray(tokens), None if sl is None else jnp.asarray(sl))
    port = S.BiLSTMTagger(50, 3, *widths).load_flax_variables(vs).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(tokens), None if sl is None else torch.from_numpy(sl))
    assert set(got) == set(S.BiLSTMTagger.LAYER_NAMES)
    valid = (np.arange(12)[None, :] < lens[:, None]) if with_lengths else np.ones((16, 12), bool)
    np.testing.assert_array_equal(got["embedded"].numpy(), np.asarray(want["embedded"]))
    h, wh = got["hidden"].numpy(), np.asarray(want["hidden"])
    assert _rel(h[valid], wh[valid]) <= REL
    lg, wl = got["logits"].numpy(), np.asarray(want["logits"])
    assert _rel(lg, wl) <= REL
    if with_lengths:
        np.testing.assert_array_equal(lg[~valid], wl[~valid])
        assert (lg[~valid][:, 0] == 0).all() and (lg[~valid][:, 1:] == -1e9).all()


def test_flax_layout_round_trip():
    tokens, _, lens = _task(n=4)
    _, vs = _j_vars(tokens, lens)
    back = S.BiLSTMTagger(50, 3).load_flax_variables(vs).to_flax_variables()
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(vs)
    for a, b in zip(jax.tree_util.tree_leaves(vs), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def _optax_steps(model, vs, tokens, tags, lens, steps, lr=3e-3):
    tok, tg, sl = (jnp.asarray(a, jnp.int32) for a in (tokens, tags, lens))

    def loss_fn(v):
        logits = model.apply(v, tok, sl)["logits"]
        ll = optax.softmax_cross_entropy_with_integer_labels(logits, tg)
        mask = jnp.arange(tok.shape[1])[None, :] < sl[:, None]
        return (ll * mask).sum() / jnp.maximum(mask.sum(), 1)

    opt = optax.adam(lr)
    state = opt.init(vs)
    step = jax.jit(lambda v, s: (lambda lg: (optax.apply_updates(
        v, opt.update(lg[1], s)[0]), opt.update(lg[1], s)[1], lg[0]))(
        jax.value_and_grad(loss_fn)(v)))
    for _ in range(steps):
        vs, state, _ = step(vs, state)
    return jax.tree_util.tree_map(np.asarray, vs), float(loss_fn(vs))


def test_one_adam_step_matches_optax():
    tokens, tags, lens = _task(n=32, seed=2)
    model, vs = _j_vars(tokens, lens)
    want, _ = _optax_steps(model, vs, tokens, tags, lens, 1)
    _, got = S.train_tagger(tokens, tags, 50, 3, seq_lengths=lens, num_steps=1,
                            device="cpu", variables=vs)
    fa = jax.tree_util.tree_flatten_with_path(want)[0]
    fb = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, a), (_, b) in zip(fa, fb):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.linalg.norm(b - a) <= REL * np.linalg.norm(a), path


def test_loss_after_ten_steps_matches_optax():
    tokens, tags, lens = _task(n=32, seed=3)
    model, vs = _j_vars(tokens, lens)
    _, want_loss = _optax_steps(model, vs, tokens, tags, lens, 10)
    port, _ = S.train_tagger(tokens, tags, 50, 3, seq_lengths=lens, num_steps=10,
                             device="cpu", variables=vs)
    with torch.no_grad():
        got_loss = float(S.tagger_loss(port, torch.from_numpy(tokens), torch.from_numpy(tags),
                                       torch.from_numpy(lens)))
    assert abs(got_loss - want_loss) <= LOSS_REL * abs(want_loss)


def test_tagger_learns_contextual_tags():
    tokens, tags, lens = _task()
    model, vs = S.train_tagger(tokens, tags, vocab_size=50, num_tags=3, seq_lengths=lens,
                               num_steps=150, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(tokens), torch.from_numpy(lens))
    pred = out["logits"].argmax(-1).numpy()
    mask = np.arange(tokens.shape[1])[None, :] < lens[:, None]
    assert (pred == tags)[mask].mean() > 0.9
    assert set(out) == set(S.BiLSTMTagger.LAYER_NAMES)
    assert jax.tree_util.tree_structure(vs) == jax.tree_util.tree_structure(_j_vars(tokens, lens)[1])


def test_padding_does_not_leak_into_real_positions():
    tokens, tags, lens = _task(n=16, t=10)
    model, _ = S.train_tagger(tokens, tags, 50, 3, seq_lengths=lens, num_steps=40, device="cpu")
    tokens_p = np.zeros((16, 16), tokens.dtype)
    tokens_p[:, :10] = tokens
    with torch.no_grad():
        lo = model(torch.from_numpy(tokens), torch.from_numpy(lens))["logits"].numpy()
        lp = model(torch.from_numpy(tokens_p), torch.from_numpy(lens))["logits"].numpy()
    mask = np.arange(10)[None, :] < lens[:, None]
    np.testing.assert_allclose(lp[:, :10][mask], lo[mask], rtol=1e-5, atol=1e-5)
    assert (lp.argmax(-1)[:, 10:] == 0).all()


def test_packed_serving_matches_xla_model():
    """Lengths packed as the trailing column ride TorchModel's one-input
    contract as they ride XLAModel's, on the same weights."""
    tokens, tags, lens = _task(n=32, t=12)
    jmodel, vs = j_train(tokens, tags, vocab_size=50, num_tags=3, seq_lengths=lens,
                         num_steps=30)
    vs = jax.tree_util.tree_map(np.asarray, vs)
    packed = S.pack_lengths(tokens, lens)
    np.testing.assert_array_equal(packed, j_pack(tokens, lens))
    xm = XLAModel(input_col="packed", output_col="tag_logits", batch_size=16, input_dtype="int32")
    xm.set(apply_fn=jmodel.packed_apply_fn(), variables=vs)
    want = np.stack(xm.transform(JDataFrame.from_dict({"packed": packed}))["tag_logits"])
    tm = TorchModel(input_col="packed", output_col="tag_logits", batch_size=16,
                    input_dtype="int32", device="cpu")
    tm.set(apply_fn=S.BiLSTMTagger(50, 3).packed_apply_fn(), variables=vs)
    got = np.stack(tm.transform(DataFrame.from_dict({"packed": packed}))["tag_logits"])
    assert got.shape == want.shape == (32, 12, 3)
    assert _rel(got, want) <= REL
    mask = np.arange(12)[None, :] < lens[:, None]
    assert (got.argmax(-1)[~mask] == 0).all()
