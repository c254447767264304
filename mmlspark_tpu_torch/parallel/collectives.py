"""Collectives over a ``torch.distributed`` process group.

The PyTorch port of ``mmlspark_tpu.parallel.collectives``. The JAX package
collapses the reference's three communication backends (LightGBM's socket
ring allreduce, TrainUtils.scala:496-512; VW's driver spanning tree,
VowpalWabbitBase.scala:401-429; the driver TCP rendezvous,
LightGBMUtils.scala:116-185) into XLA collectives on a named mesh axis. In
the port a mesh axis is a process group and each collective is a
``torch.distributed`` call on it. Every function takes ``group`` (None =
the default group) where the JAX package takes ``axis``, returns a new
tensor on the input's device, and is the identity when
``torch.distributed`` is not initialised (one process, one rank).

Transport. NCCL moves CUDA tensors (a CPU input goes to the rank's card
and back). Gloo is a host transport: a CUDA input is copied into a pinned
host buffer, reduced there, and copied back, so on one card two gloo ranks
cost two host copies per collective; that is the gloo branch, not a
fallback.

Every collective that runs adds to :data:`counts`, by operation: calls,
elements and bytes of its input (what one rank contributes). The voting
tests and ``chip_smoke.py`` read the elements all-reduced per split here.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from mmlspark_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, get_mesh, group_rank_size

counts: dict = {"calls": {}, "elements": {}, "bytes": {}}


def reset_counts() -> None:
    for table in counts.values():
        table.clear()


def _count(op: str, x: torch.Tensor) -> None:
    for key, v in (("calls", 1), ("elements", x.numel()),
                   ("bytes", x.numel() * x.element_size())):
        counts[key][op] = counts[key].get(op, 0) + v


def _staged(group: Any, *ts: torch.Tensor) -> tuple:
    """Copies of the tensors for the transport, which reduces in place:
    host copies (pinned where a card is present) for gloo, copies on the
    rank's card for NCCL (never the caller's own tensor)."""
    if dist.get_backend(group) == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
        return tuple(t.to(dev, memory_format=torch.contiguous_format, copy=True) for t in ts)
    out = []
    for t in ts:
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            out.append(buf)
        else:
            out.append(t.contiguous().clone())
    return tuple(out)


def _reduce(op: str, rop: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
    if not dist.is_initialized():
        return x.clone()
    _count(op, x)
    (buf,) = _staged(group, x)
    dist.all_reduce(buf, rop, group=group)
    return buf.to(x.device)


def allreduce_sum(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    return _reduce("allreduce_sum", dist.ReduceOp.SUM, x, group)


def allreduce_mean(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """The sum over ranks divided by the world size, as ``lax.pmean``
    (``psum(x) / n``); float tensors."""
    _, size = group_rank_size(group)
    s = _reduce("allreduce_mean", dist.ReduceOp.SUM, x, group)
    return s / size if size > 1 else s


def allreduce_max(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    return _reduce("allreduce_max", dist.ReduceOp.MAX, x, group)


def _global(group: Any, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def broadcast(x: torch.Tensor, src: int = 0, group: Any = None) -> torch.Tensor:
    """Rank ``src``'s ``x`` (a rank of ``group``) on every rank."""
    if not dist.is_initialized():
        return x.clone()
    _count("broadcast", x)
    (buf,) = _staged(group, x)
    dist.broadcast(buf, _global(group, src), group=group)
    return buf.to(x.device)


def _gather_into(out: torch.Tensor, x: torch.Tensor, group: Any) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def all_gather(x: torch.Tensor, group: Any = None, tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in rank order: stacked on a new axis 0, or with
    ``tiled`` concatenated along axis 0."""
    if not dist.is_initialized():
        return x.clone() if tiled else x[None].clone()
    _, size = group_rank_size(group)
    _count("all_gather", x)
    (buf,) = _staged(group, x.reshape(-1))
    out = buf.new_empty(size * buf.numel())
    _gather_into(out, buf, group)
    out = out.to(x.device).reshape((size,) + tuple(x.shape))
    return out.reshape((size * x.shape[0],) + tuple(x.shape[1:])) if tiled else out


def all_gather_rows(x: torch.Tensor, group: Any = None,
                    counts: Optional[list] = None) -> torch.Tensor:
    """Every rank's rows of ``x`` (axis 0) concatenated in rank order,
    where the ranks may hold different row counts (``counts``: every
    rank's, when the caller knows them; else one all-gather more): each
    rank pads its rows to the largest count for one all-gather, and the
    padding is dropped."""
    if not dist.is_initialized():
        return x.clone()
    if counts is None:
        counts = [int(c) for c in all_gather(torch.tensor([x.shape[0]], dtype=torch.int64),
                                             group)]
    m = max(counts)
    if x.shape[0] < m:
        x = torch.cat([x, x.new_zeros((m - x.shape[0],) + tuple(x.shape[1:]))])
    got = all_gather(x, group, tiled=False)
    return torch.cat([got[r, :c] for r, c in enumerate(counts)])


def reduce_scatter(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Sum over ranks of ``x`` (world * m, ...), of which this rank keeps
    block ``rank`` (m, ...) (``psum_scatter(tiled=True)``)."""
    if not dist.is_initialized():
        return x.clone()
    _, size = group_rank_size(group)
    if x.shape[0] % size:
        raise ValueError(f"axis 0 of {tuple(x.shape)} does not divide by {size} ranks")
    _count("reduce_scatter", x)
    (buf,) = _staged(group, x.reshape(-1))
    out = buf.new_empty(buf.numel() // size)
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, buf, group=group)
    return out.to(x.device).reshape((x.shape[0] // size,) + tuple(x.shape[1:]))


def ring_permute(x: torch.Tensor, group: Any = None, shift: int = 1) -> torch.Tensor:
    """Neighbour exchange on the ring: rank r sends ``x`` to r + shift and
    receives from r - shift (``lax.ppermute``), as one batch of
    ``isend``/``irecv``."""
    if not dist.is_initialized():
        return x.clone()
    rank, size = group_rank_size(group)
    _count("ring_permute", x)
    send, recv = _staged(group, x, torch.empty_like(x))
    ops = [dist.P2POp(dist.isend, send, _global(group, (rank + shift) % size), group),
           dist.P2POp(dist.irecv, recv, _global(group, (rank - shift) % size), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


def axis_index(group: Any = None) -> int:
    """This process's rank in ``group``."""
    return group_rank_size(group)[0]


def shard_apply(
    fn: Callable,
    mesh: Optional[Mesh] = None,
    in_specs: Any = DATA_AXIS,
    out_specs: Any = DATA_AXIS,
) -> Callable:
    """``shard_map`` over the ranks: the returned function takes whole
    tensors (the same on every rank), gives ``fn`` this rank's block of
    axis 0 of each argument whose spec is ``DATA_AXIS`` (None: the whole
    tensor), and all-gathers each output whose spec is ``DATA_AXIS`` back
    into a whole tensor. A spec is one value for every argument (output) or
    a tuple of one per argument (output)."""
    mesh = mesh or get_mesh()

    def specs(spec: Any, k: int) -> tuple:
        return tuple(spec) if isinstance(spec, (tuple, list)) else (spec,) * k

    def mapped(*args: torch.Tensor) -> Any:
        ins = []
        for a, s in zip(args, specs(in_specs, len(args))):
            if s == DATA_AXIS:
                if a.shape[0] % mesh.size:
                    raise ValueError(
                        f"axis 0 of {tuple(a.shape)} does not divide by {mesh.size} ranks")
                a = a.chunk(mesh.size)[mesh.rank]
            ins.append(a)
        out = fn(*ins)
        single = not isinstance(out, tuple)
        outs = (out,) if single else out
        res = tuple(all_gather(o, mesh.group) if s == DATA_AXIS else o
                    for o, s in zip(outs, specs(out_specs, len(outs))))
        return res[0] if single else res

    return mapped
