"""Recurrent sequence models: the port of ``mmlspark_tpu.models.sequence``.

A per-token BiLSTM tagger (embed -> BiLSTM -> per-position logits) with the
JAX package's numbers: flax's ``OptimizedLSTMCell`` is the LSTM recurrence
``nn.LSTM`` runs (cuDNN on the card), gates in i, f, g, o order, sigmoid
gates, tanh cell, zero initial carry. flax keeps one input kernel per gate
without a bias and one hidden kernel per gate with a bias; here
``weight_ih``/``weight_hh`` stack the four gates and the hidden bias is
``bias_hh``, while ``bias_ih`` stays 0 and is never trained.

Padded batches follow flax's ``RNN(seq_lengths=...)``: the forward scan
runs over the pad tail (those outputs are masked from the logits); the
backward direction reverses each row's first ``length`` tokens (and the
tail among itself, ``flip_sequences``), scans, and reverses back
(``reverse=True, keep_order=True``), so padding never reaches a real
position. With lengths, pad positions' logits are exactly ``-1e9`` with
tag 0 at 0, so they predict tag 0.

``TorchModel``'s input is one batch array: :func:`pack_lengths` packs each
row's length as a trailing column, and :meth:`BiLSTMTagger.packed_apply_fn`
unpacks it inside the model call, so the mask rides the serving path too.
:func:`train_tagger` fits with ``torch.optim.Adam`` (optax's Adam in the
JAX package: the same update, rounded differently).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mmlspark_tpu_torch.core.device import resolve_device

GATES = ("i", "f", "g", "o")


def flip_sequences(x: torch.Tensor, seq_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """flax's ``flip_sequences`` on (B, T, ...): each row's first ``length``
    steps reversed and the tail reversed among itself
    (index ``(T - 1 - t + length) mod T``); the whole row without lengths."""
    t = x.shape[1]
    if seq_lengths is None:
        return torch.flip(x, dims=(1,))
    idx = (torch.arange(t - 1, -1, -1, device=x.device)[None, :]
           + seq_lengths.to(x.device)[:, None].long()) % t
    idx = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


class BiLSTMTagger(nn.Module):
    """Per-token tagger: embed -> BiLSTM -> per-position logits.

    Named outputs follow the zoo convention for ``cut_output_layers``:
    ["logits", "hidden", "embedded"]."""

    LAYER_NAMES = ("logits", "hidden", "embedded")

    def __init__(self, vocab_size: int, num_tags: int, embed_dim: int = 64,
                 hidden_dim: int = 64):
        super().__init__()
        self.vocab_size, self.num_tags = vocab_size, num_tags
        self.embed_dim, self.hidden_dim = embed_dim, hidden_dim
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.lstm_fwd = nn.LSTM(embed_dim, hidden_dim, batch_first=True)
        self.lstm_bwd = nn.LSTM(embed_dim, hidden_dim, batch_first=True)
        for lstm in (self.lstm_fwd, self.lstm_bwd):
            with torch.no_grad():
                lstm.bias_ih_l0.zero_()
            lstm.bias_ih_l0.requires_grad_(False)  # flax's input kernels have no bias
        self.head = nn.Linear(2 * hidden_dim, num_tags)

    def forward(self, tokens: torch.Tensor, seq_lengths: Optional[torch.Tensor] = None) -> dict:
        """tokens (B, T) int, seq_lengths (B,) int or None -> named outputs."""
        x = self.embed(tokens.long())
        fwd, _ = self.lstm_fwd(x)
        bwd, _ = self.lstm_bwd(flip_sequences(x, seq_lengths))
        h = torch.cat([fwd, flip_sequences(bwd, seq_lengths)], dim=-1)
        logits = self.head(h)
        if seq_lengths is not None:
            # pad positions predict tag 0, so batch content cannot leak
            # through the pad tail
            t = tokens.shape[1]
            valid = torch.arange(t, device=tokens.device)[None, :] < seq_lengths.to(
                tokens.device)[:, None]
            neg = torch.full_like(logits, -1e9)
            neg[..., 0] = 0.0
            logits = torch.where(valid[..., None], logits, neg)
        return {"embedded": x, "hidden": h, "logits": logits}

    def packed_apply_fn(self, node: str = "logits") -> Any:
        """``(variables, packed) -> output`` for ``TorchModel``'s
        ``apply_fn``: ``packed`` is (B, T + 1) int with each row's length in
        the last column (:func:`pack_lengths`); ``variables`` is
        :meth:`to_flax_variables`'s tree (numpy or tensors, on the batch's
        device)."""

        def fn(variables: Any, packed: torch.Tensor) -> torch.Tensor:
            return functional_apply(self, variables, packed[:, :-1], packed[:, -1])[node]

        return fn

    # -- flax layout ---------------------------------------------------------

    def to_flax_variables(self) -> dict:
        """The weights as flax's ``{"params"}`` tree (f32 numpy): ``embed``,
        ``OptimizedLSTMCell_0`` (forward) and ``_1`` (backward) with
        ``i<gate>``/``h<gate>`` kernels, ``head``."""
        def a(t: torch.Tensor) -> np.ndarray:
            return t.detach().float().cpu().numpy().copy()

        params: dict = {}
        for k, lstm in enumerate((self.lstm_fwd, self.lstm_bwd)):
            wi = lstm.weight_ih_l0.chunk(4)
            wh = lstm.weight_hh_l0.chunk(4)
            b = (lstm.bias_hh_l0 + lstm.bias_ih_l0).chunk(4)
            cell = {}
            for j, g in enumerate(GATES):
                cell[f"h{g}"] = {"bias": a(b[j]), "kernel": a(wh[j].T)}
                cell[f"i{g}"] = {"kernel": a(wi[j].T)}
            params[f"OptimizedLSTMCell_{k}"] = dict(sorted(cell.items()))
        params["embed"] = {"embedding": a(self.embed.weight)}
        params["head"] = {"bias": a(self.head.bias), "kernel": a(self.head.weight.T)}
        return {"params": params}

    def load_flax_variables(self, variables: dict) -> "BiLSTMTagger":
        self.load_state_dict(_state_from_flax(variables), strict=True)
        return self


def _state_from_flax(variables: dict) -> dict:
    p = variables["params"]

    def t(a: Any) -> torch.Tensor:
        return a.detach().float() if isinstance(a, torch.Tensor) else torch.tensor(
            np.asarray(a, np.float32))

    state = {"embed.weight": t(p["embed"]["embedding"]),
             "head.weight": t(p["head"]["kernel"]).T.contiguous(),
             "head.bias": t(p["head"]["bias"])}
    for k, name in enumerate(("lstm_fwd", "lstm_bwd")):
        cell = p[f"OptimizedLSTMCell_{k}"]
        state[f"{name}.weight_ih_l0"] = torch.cat([t(cell[f"i{g}"]["kernel"]).T for g in GATES])
        state[f"{name}.weight_hh_l0"] = torch.cat([t(cell[f"h{g}"]["kernel"]).T for g in GATES])
        state[f"{name}.bias_hh_l0"] = torch.cat([t(cell[f"h{g}"]["bias"]) for g in GATES])
        state[f"{name}.bias_ih_l0"] = torch.zeros_like(state[f"{name}.bias_hh_l0"])
    return state


def functional_apply(model: BiLSTMTagger, variables: dict, tokens: torch.Tensor,
                     seq_lengths: Optional[torch.Tensor] = None) -> dict:
    """``model.apply(variables, tokens, seq_lengths)``: ``model`` run with
    the weights of a flax-layout tree (placed on the tokens' device)."""
    state = {k: v.to(tokens.device) for k, v in _state_from_flax(variables).items()}
    return torch.func.functional_call(model, state, (tokens, seq_lengths))


def pack_lengths(tokens: np.ndarray, seq_lengths: np.ndarray) -> np.ndarray:
    """(B, T) tokens + (B,) lengths -> (B, T + 1) with the length as the
    trailing column: the serving-side carrier for the pad mask."""
    tokens = np.asarray(tokens)
    return np.concatenate([tokens, np.asarray(seq_lengths, tokens.dtype)[:, None]], axis=1)


def init_tagger(model: BiLSTMTagger, seed: int = 0) -> BiLSTMTagger:
    """flax's initializer families from a ``torch.Generator(seed)`` (not
    flax's draws): the embedding ``normal(1/sqrt(embed_dim))``, input
    kernels and the head lecun-normal (truncated normal, std
    sqrt(1/fan_in) / 0.8796), hidden kernels orthogonal per gate, biases 0."""
    gen = torch.Generator().manual_seed(int(seed))

    def lecun(fan_in: int, shape: tuple) -> torch.Tensor:
        w = torch.empty(shape)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w * (np.sqrt(1.0 / fan_in) / 0.87962566103423978)

    with torch.no_grad():
        e, h = model.embed_dim, model.hidden_dim
        model.embed.weight.copy_(torch.randn(model.embed.weight.shape, generator=gen) / np.sqrt(e))
        for lstm in (model.lstm_fwd, model.lstm_bwd):
            lstm.weight_ih_l0.copy_(torch.cat([lecun(e, (h, e)) for _ in GATES]))
            hh = []
            for _ in GATES:
                w = torch.empty(h, h)
                nn.init.orthogonal_(w, generator=gen)
                hh.append(w)
            lstm.weight_hh_l0.copy_(torch.cat(hh))
            lstm.bias_hh_l0.zero_()
            lstm.bias_ih_l0.zero_()
        model.head.weight.copy_(lecun(2 * h, tuple(model.head.weight.shape)))
        model.head.bias.zero_()
    return model


def tagger_loss(model: BiLSTMTagger, tokens: torch.Tensor, tags: torch.Tensor,
                seq_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Token cross-entropy, averaged over valid positions (all without lengths)."""
    logits = model(tokens, seq_lengths)["logits"]
    ll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tags.reshape(-1).long(),
                         reduction="none").view(tags.shape)
    if seq_lengths is None:
        return ll.mean()
    mask = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
            < seq_lengths[:, None]).to(ll.dtype)
    return (ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def train_tagger(tokens: np.ndarray, tags: np.ndarray, vocab_size: int, num_tags: int,
                 seq_lengths: Optional[np.ndarray] = None, num_steps: int = 200,
                 learning_rate: float = 3e-3, seed: int = 0,
                 device: "str | torch.device | None" = None,
                 variables: Optional[dict] = None, **kw: Any) -> tuple:
    """Fit a :class:`BiLSTMTagger` with Adam (full batch, ``num_steps``
    steps) on token cross-entropy masked by ``seq_lengths``. Returns
    (model on ``device``, flax-layout variables). ``variables`` starts from
    given weights (a flax tree) instead of :func:`init_tagger`'s draw;
    ``device`` None is the card."""
    dev = resolve_device(device)
    model = BiLSTMTagger(vocab_size=vocab_size, num_tags=num_tags, **kw)
    if variables is not None:
        model.load_flax_variables(variables)
    else:
        init_tagger(model, seed)
    model.to(dev).train()
    tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=dev)
    tg = torch.as_tensor(np.asarray(tags), dtype=torch.int64, device=dev)
    sl = None if seq_lengths is None else torch.as_tensor(
        np.asarray(seq_lengths), dtype=torch.int64, device=dev)
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                           lr=learning_rate, eps=1e-8)
    for _ in range(num_steps):
        opt.zero_grad(set_to_none=True)
        tagger_loss(model, tok, tg, sl).backward()
        opt.step()
    model.eval()
    return model, model.to_flax_variables()
