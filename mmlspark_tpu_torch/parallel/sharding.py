"""Batch and weight placement over the ranks.

The PyTorch port of ``mmlspark_tpu.parallel.sharding``. Where the JAX
package places one global array batch-sharded over the mesh, a rank here
holds its own block of rows as a tensor on its device, and weights are
broadcast from rank 0 (the reference broadcasts native models to executors
and maps rows per partition, cntk/CNTKModel.scala:411-413,515-520).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, get_mesh, local_device_count


def pad_batch(arr: np.ndarray, multiple: int) -> tuple:
    """Pad axis 0 up to a multiple (the JAX package's fixed shapes; a
    FixedMiniBatchTransformer analogue). Returns (padded, real_n)."""
    n = arr.shape[0]
    target = max(multiple, ((n + multiple - 1) // multiple) * multiple)
    if target == n:
        return arr, n
    pad_width = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width), n


def _tree_map(fn: Any, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(x: Any, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def shard_batch(tree: Any, mesh: Optional[Mesh] = None, axis: str = DATA_AXIS) -> Any:
    """This rank's contiguous block of axis 0 of every leaf (numpy arrays or
    tensors holding all rows), as tensors on the rank's device. Axis 0
    must divide by the world size (``pad_batch`` first)."""
    if axis != DATA_AXIS:
        raise ValueError(f"the port shards over {DATA_AXIS!r} only, got {axis!r}")
    mesh = mesh or get_mesh()

    def put(x: Any) -> torch.Tensor:
        if x.shape[0] % mesh.size:
            raise ValueError(f"axis 0 of {tuple(x.shape)} does not divide by {mesh.size} ranks")
        per = x.shape[0] // mesh.size
        return _tensor(x[mesh.rank * per:(mesh.rank + 1) * per], mesh.device)

    return _tree_map(put, tree)


def multihost_pad_target(n_local: int, mesh: Optional[Mesh] = None) -> int:
    """Common per-rank row count: the largest local count over the ranks
    (one all-gather), rounded up to the local device count (one a rank)."""
    mesh = mesh or get_mesh()
    counts = collectives.all_gather(torch.tensor([int(n_local)], dtype=torch.int64), mesh.group)
    ldc = local_device_count()
    m = int(counts.max())
    return ((m + ldc - 1) // ldc) * ldc


def shard_batch_multihost(tree: Any, mesh: Optional[Mesh] = None,
                          axis: str = DATA_AXIS) -> Any:
    """This rank's own rows -> its block of the global row-sharded batch:
    tensors on the rank's device. The global batch stacks the blocks in
    rank order, as ``jax.make_array_from_process_local_data`` stacks
    processes."""
    if axis != DATA_AXIS:
        raise ValueError(f"the port shards over {DATA_AXIS!r} only, got {axis!r}")
    mesh = mesh or get_mesh()
    return _tree_map(lambda x: _tensor(x, mesh.device), tree)


def replicate(tree: Any, mesh: Optional[Mesh] = None) -> Any:
    """Every leaf as rank 0 holds it, on every rank's device (one broadcast
    a leaf; the weights-to-executors broadcast)."""
    mesh = mesh or get_mesh()

    def put(x: Any) -> torch.Tensor:
        t = _tensor(x, mesh.device)
        if mesh.size == 1:
            return t
        return collectives.broadcast(t, 0, mesh.group)

    return _tree_map(put, tree)


def check_same_rows(counts: Sequence[int], mesh: Mesh, what: str) -> None:
    """Raise ValueError unless every rank of ``mesh`` passes the same
    ``counts`` (row counts, one per partition or batch): a call that shards
    rows over the ranks and all-gathers the results is a collective, and
    ranks holding other rows would get back a mix of them. One all-gather
    of a fixed-size summary (how many counts, their sum, and a weighted
    sum that tells their order apart); every rank sees every summary, so
    every rank raises alike."""
    c = [int(v) for v in counts]
    summary = torch.tensor([len(c), sum(c), sum((i + 1) * v for i, v in enumerate(c))],
                           dtype=torch.int64)
    got = collectives.all_gather(summary, mesh.group, tiled=False)
    if not bool((got == got[0]).all()):
        raise ValueError(
            f"{what} is a collective: every rank must pass the same rows, but the ranks' "
            f"row counts differ (rows by rank: {got[:, 1].tolist()})")
