"""Ring attention: sequence-parallel exact attention over the ranks.

The port of ``mmlspark_tpu.ops.ring_attention``. When a sequence is split
over the ranks of a group, each rank holds one Q/K/V block, and the K/V
blocks (with their pad mask) rotate around the ring one neighbour hop a
step (``collectives.ring_permute``). Each block's scores fold into the
running output with the online-softmax update (running max, rescaled
accumulator), so the result is exact attention over the whole sequence
while no rank holds more than its own block pair.

The JAX package runs the ring inside ``shard_map`` over a mesh axis of one
process's devices and takes whole arrays. In the port a rank is a process
(one per card, or several gloo ranks on one card), so
:func:`ring_attention` is the per-rank body: it takes this rank's block of
the sequence, ``(batch, seq / world, heads, head_dim)``, and returns this
rank's block of the output. Rank r holds the r-th block. With one rank, or
without ``torch.distributed``, it is the single-shard form.

The reference's ring sends each block from rank j to rank j - 1
(``ppermute`` pairs ``(j, j - 1)``), so after step i rank ``my`` holds the
block of rank ``my + i``; the port rotates the same way (``shift=-1``).
The rotation is differentiable: its backward sends the cotangent the other
way round the ring (the transpose of the permutation), so gradients flow
through the ring as through ``ppermute``.

Scores are an ``einsum`` and the online softmax as the reference computes
them (no fused attention kernel), with its ``-inf`` guards: a query row
with no visible key gives 0 in :func:`ring_attention` (``o / max(l,
1e-30)``), and NaN in :func:`dense_attention` (softmax over all ``-inf``),
as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.parallel.mesh import group_rank_size


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                  m: torch.Tensor, l: torch.Tensor, q_off: int, k_off: int, scale: float,
                  causal: bool, kv_mask: Optional[torch.Tensor] = None) -> tuple:
    """Fold one K/V block into the online-softmax accumulators: q (B, Tq, H,
    D), k and v (B, Tk, H, D), o (B, Tq, H, D) unnormalised, m and l (B, Tq,
    H) running max and sum; kv_mask (B, Tk) bool, False = pad key."""
    s = torch.einsum("bqhd,bkhd->bqhk", q, k) * scale
    neg = torch.tensor(float("-inf"), dtype=s.dtype, device=s.device)
    if causal:
        qi = q_off + torch.arange(q.shape[1], device=q.device)
        ki = k_off + torch.arange(k.shape[1], device=q.device)
        s = torch.where((qi[:, None] >= ki[None, :])[None, :, None, :], s, neg)
    if kv_mask is not None:
        # padding keys receive no attention; a fully masked block keeps the
        # running max at -inf, which the guards below tolerate
        s = torch.where(kv_mask[:, None, None, :], s, neg)
    new_m = torch.maximum(m, s.amax(dim=-1))
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    safe_m = torch.where(torch.isfinite(new_m), new_m, zero)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isfinite(s), p, zero)
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), zero)
    new_l = l * corr + p.sum(dim=-1)
    new_o = o * corr[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, v)
    return new_o, new_m, new_l


class _RingPermute(torch.autograd.Function):
    """``ring_permute`` with a backward: the cotangent goes the other way."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any, shift: int) -> torch.Tensor:
        ctx.group, ctx.shift = group, shift
        return collectives.ring_permute(x, group, shift)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> tuple:
        return collectives.ring_permute(g.contiguous(), ctx.group, -ctx.shift), None, None


def ring_permute(x: torch.Tensor, group: Any = None, shift: int = 1) -> torch.Tensor:
    """Differentiable ``collectives.ring_permute``."""
    return _RingPermute.apply(x, group, shift)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: Any = None,
                   causal: bool = False, scale: Optional[float] = None,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention with the sequence split over the ranks of ``group``
    (None = the default group).

    ``q``/``k``/``v``: this rank's block (batch, seq / world, heads,
    head_dim) of the sequence, rank r holding block r; every rank's blocks
    have the same length. Returns this rank's block of the output.
    ``causal=True`` masks with global positions (each rank knows its
    block's offset). ``kv_mask``: this rank's (batch, seq / world) bool
    block, False keys receive no attention; it rides the ring with its K/V
    block, so a sequence padded to a multiple of the world size and masked
    at its tail attends as the unpadded one."""
    sc = scale if scale is not None else q.shape[-1] ** -0.5
    my, n = group_rank_size(group)
    B, T, H, _ = q.shape
    o = torch.zeros_like(q)
    m = torch.full((B, T, H), float("-inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros((B, T, H), dtype=q.dtype, device=q.device)
    if n == 1:
        o, m, l = _block_attend(q, k, v, o, m, l, 0, 0, sc, causal, kv_mask)
        return o / torch.clamp(l, min=1e-30)[..., None]
    kv = torch.stack([k, v])
    mk = None if kv_mask is None else kv_mask.to(torch.uint8)
    for i in range(n - 1):
        # the block held now arrived from rank (my + i) % n
        src = (my + i) % n
        o, m, l = _block_attend(q, kv[0], kv[1], o, m, l, my * T, src * kv.shape[2], sc,
                                causal, None if mk is None else mk.bool())
        # rotate K/V and the pad mask one hop: rank j sends to j - 1
        kv = ring_permute(kv, group, -1)
        if mk is not None:
            mk = collectives.ring_permute(mk, group, -1)
    # the last block attends outside the loop: no final hop whose result
    # would be discarded
    src = (my + n - 1) % n
    o, m, l = _block_attend(q, kv[0], kv[1], o, m, l, my * T, src * kv.shape[2], sc, causal,
                            None if mk is None else mk.bool())
    # rows with no visible key -> 0
    return o / torch.clamp(l, min=1e-30)[..., None]


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-device attention (the golden for the ring): softmax of the
    masked scores; a row with no visible key is NaN."""
    sc = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bqhk", q, k) * sc
    neg = torch.tensor(float("-inf"), dtype=s.dtype, device=s.device)
    if causal:
        T, S = s.shape[1], s.shape[3]
        mask = torch.arange(T, device=s.device)[:, None] >= torch.arange(S, device=s.device)[None, :]
        s = torch.where(mask[None, :, None, :], s, neg)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, neg)
    return torch.einsum("bqhk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
