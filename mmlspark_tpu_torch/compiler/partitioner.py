"""Partitioner: propagate batch/replicated specs through fused segments.

The PyTorch port of ``mmlspark_tpu.compiler.partitioner``. The decision
logic is the JAX package's; the plan stays data (a spec per column, and
``in_specs`` per bucket). The JAX package hands it to
``jax.jit(in_shardings=...)``; in the port its application to ranks comes
with ``torch.distributed`` (ROADMAP.md, Queue A item 4). On one card there
is no mesh, so every column plans replicated.

Automap (arXiv:2112.02958) observes that most sharding decisions in an ML
program are *forced* by their neighbours — annotations propagate through
elementwise/row-wise ops unambiguously, and search is only needed at the
few points where propagation meets a conflicting constraint. The fused
segments here are exactly that easy case made explicit: every
:class:`~mmlspark_tpu_torch.compiler.kernels.StageKernel` declares whether
it is row-wise (batch axis 0 flows through untouched) and which inputs it
needs replicated. So:

1. **Propagate**: union-find columns that must share a spec (all reads +
   writes of a row-wise kernel form one group — the batch axis flows
   through). A group nobody constrains resolves to the default
   ``data``-axis batch sharding; a group with one consistent demand
   resolves to that demand. No search.
2. **Search at conflicts**: a group carrying *both* batch-preferring uses
   and replication demands (a non-row-wise kernel, or
   ``needs_replicated``) is ambiguous. Enumerate the candidate specs and
   score each: choosing ``batch`` pays one resharding (allgather) per
   replication demand; choosing ``replicated`` pays duplicated
   compute/placement for every batch-preferring use. Pick the minimum —
   the conflict set is tiny, so exhaustive scoring is exact.
3. **Fall back to replicated** when the mesh cannot batch-shard at all —
   no mesh or one device, a CPU mesh in ``auto`` mode, or a bucket the
   mesh size does not divide.

A mesh here is any object with a ``devices`` array whose elements name
their platform (``platform``, or a ``torch.device``'s ``type``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

BATCH = "batch"
REPLICATED = "replicated"


class _UnionFind:
    def __init__(self) -> None:
        self.parent: dict = {}

    def find(self, x: Any) -> Any:
        p = self.parent.setdefault(x, x)
        if p != x:
            p = self.parent[x] = self.find(p)
        return p

    def union(self, a: Any, b: Any) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


@dataclass
class ShardingPlan:
    """Per-column spec decisions for one fused segment."""

    decisions: dict                      # col -> BATCH | REPLICATED
    searched: list = field(default_factory=list)  # groups resolved by search
    mesh: Any = None
    data_axis: str = "data"

    def in_specs(self, cols: dict) -> Optional[dict]:
        """The partition spec of each of the segment's (bucketed) input
        columns — ``(data_axis, None, ...)`` for batch, ``()`` for
        replicated — or None when there is no mesh to place them on.
        Called per bucket: a batch-destined column whose *actual* leading
        dim the mesh does not divide (a small pow2 bucket on a larger
        mesh) degrades to replicated for that bucket."""
        if self.mesh is None:
            return None
        size = int(np.asarray(self.mesh.devices).size)
        out = {}
        for name, arr in cols.items():
            if (
                self.decisions.get(name) == BATCH
                and arr.ndim
                and arr.shape[0] % size == 0
            ):
                out[name] = (self.data_axis,) + (None,) * (arr.ndim - 1)
            else:
                out[name] = ()
        return out


def plan_sharding(
    kernels: list,
    mesh: Any = None,
    bucket: Optional[int] = None,
    mode: str = "auto",
) -> ShardingPlan:
    """Assign a spec to every column a run of kernels touches.

    ``mode``: ``auto`` (batch-shard on an accelerator mesh, replicate on
    CPU), ``batch`` (force batch sharding when divisible — used by tests
    and by callers who know their CPU mesh is the deployment), or
    ``replicated``.
    """
    cols: list = []
    uf = _UnionFind()
    batch_pref: dict = {}   # col -> count of batch-preferring uses
    repl_demand: dict = {}  # col -> count of replication demands
    for k in kernels:
        touched = list(k.reads) + list(k.writes)
        for c in touched:
            if c not in batch_pref:
                cols.append(c)
                batch_pref[c] = 0
                repl_demand[c] = 0
        if k.row_wise:
            # batch axis flows through: all touched columns share a spec
            for c in touched[1:]:
                uf.union(touched[0], c)
            for c in touched:
                batch_pref[c] += 1
        else:
            for c in touched:
                repl_demand[c] += 1
        for c in k.needs_replicated:
            repl_demand[c] = repl_demand.get(c, 0) + 1

    devices = np.asarray(mesh.devices).reshape(-1) if mesh is not None else ()
    mesh_size = len(devices) if mesh is not None else 1
    divisible = bucket is None or (mesh_size > 0 and bucket % mesh_size == 0)
    platform = ""
    if mesh_size and mesh is not None:
        d0 = devices[0]
        platform = getattr(d0, "platform", None) or getattr(d0, "type", "")
    can_batch = (
        mesh is not None and mesh_size > 1 and divisible
        and mode != "replicated"
        and (mode == "batch" or platform not in ("", "cpu"))
    )

    groups: dict = {}
    for c in cols:
        groups.setdefault(uf.find(c), []).append(c)

    decisions: dict = {}
    searched: list = []
    for members in groups.values():
        prefs = sum(batch_pref[c] for c in members)
        demands = sum(repl_demand[c] for c in members)
        if not can_batch:
            spec = REPLICATED
        elif demands == 0:
            spec = BATCH            # unambiguous propagation
        elif prefs == 0:
            spec = REPLICATED       # unambiguous propagation
        else:
            # conflict point: score the candidates (Automap's search step).
            # batch   -> one reshard (allgather) per replication demand;
            # replicated -> duplicated compute for each batch use, scaled
            # by the fraction of the mesh doing redundant work.
            cost_batch = float(demands)
            cost_repl = prefs * (1.0 - 1.0 / mesh_size)
            spec = BATCH if cost_batch <= cost_repl else REPLICATED
            searched.append({
                "columns": sorted(members),
                "chosen": spec,
                "cost_batch": cost_batch,
                "cost_replicated": round(cost_repl, 3),
            })
        for c in members:
            decisions[c] = spec
    return ShardingPlan(
        decisions=decisions,
        searched=searched,
        mesh=mesh if can_batch else None,
    )
