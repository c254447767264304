"""TorchModel — batched model evaluation on the card (the CNTKModel analogue).

The port's counterpart of ``mmlspark_tpu.models.xla_model.XLAModel``. The
model is either an ``nn.Module`` (``module``, evaluated as ``module(batch)``)
or a function of variables and a batch (``apply_fn`` + ``variables``, the
XLAModel form); the module or the variables move to the device once, and
every batch then runs there under ``torch.inference_mode()``:

- rows are cut into batches of a fixed ``batch_size``; the last one is
  padded with zero rows and its outputs dropped, as XLAModel's
  ``pad_batch`` pads (the shapes the card sees stay the same);
- on the card a host batch is copied into a pinned buffer and sent with a
  ``non_blocking`` copy, and its result comes back the same way, so the
  copies overlap the compute of other batches; up to ``_MAX_IN_FLIGHT`` (4)
  batches are in flight, and results come back in order;
- a model that returns a dict of outputs keeps ``output_node``;
- ``input_dtype`` None keeps the host dtype on the wire (uint8 pixels travel
  at a byte each and the model casts on the card); bf16 outputs come back
  widened to f32, as numpy has no bf16.

``device`` None is the card, which raises without one; ``device="cpu"`` runs
the same batches on the CPU.

Over the ranks of the process's mesh (``parallel.process_mesh``: the
default ``torch.distributed`` group), as XLAModel over its devices: the
batch is ``batch_size`` rounded up to a multiple of the world size, each
rank runs its contiguous block of every padded batch on its own device
(the module or variables placed once a rank, rank 0's values broadcast to
every rank, as ``replicate`` places them), and the outputs are
all-gathered in rank order, so every rank returns the whole output. That
makes ``apply_batch`` and ``transform`` collectives: every rank must call
them with the same rows (a call exchanges the row counts first and raises
if they differ). Without an initialised group, or in a group of one rank,
nothing of this runs.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.params import (
    ComplexParam,
    HasBatchSize,
    HasInputCol,
    HasOutputCol,
    Param,
)
from mmlspark_tpu_torch.core.pipeline import Model
from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.parallel.mesh import Mesh, process_mesh
from mmlspark_tpu_torch.parallel.sharding import check_same_rows, replicate


def _to_device(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, dev) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return torch.as_tensor(np.asarray(tree), device=dev)


def _host(y: torch.Tensor) -> np.ndarray:
    return (y.float() if y.dtype == torch.bfloat16 else y).numpy()


class TorchModel(Model, HasInputCol, HasOutputCol, HasBatchSize):
    module = ComplexParam("torch.nn.Module: module(batch) -> tensor | dict[name, tensor]")
    apply_fn = ComplexParam(
        "function (variables, batch) -> tensor | dict[name, tensor]; with "
        "``variables``, the alternative to ``module``"
    )
    variables = ComplexParam("variables of apply_fn: a tree of arrays or tensors")
    output_node = Param(
        "name of the output to keep when the model returns a dict", type_=str
    )
    batch_size = Param(
        "fixed minibatch size; the last batch is padded to it (rounded up to a "
        "multiple of the world size over ranks)",
        default=64,
        type_=int,
        validator=lambda v: v > 0,
    )
    input_dtype = Param(
        "cast input batches to this numpy dtype on the host; None = keep the "
        "host dtype (e.g. ship uint8 pixels and cast on the device)",
        default="float32",
        type_=str,
    )
    device = Param(
        "torch device: 'cuda' (default; raises without a card) or 'cpu'", type_=str
    )

    # how many batches may be in flight on the card at once: bounds the
    # device memory of inputs and outputs while copies overlap compute
    _MAX_IN_FLIGHT = 4

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        self._placed: Any = None
        self._placed_key: Any = None

    # -- device-side plumbing ----------------------------------------------

    def _runner(self, dev: torch.device) -> Any:
        """The model on ``dev`` as a function of one batch (made once a
        rank; over more than one rank the module is a copy holding rank
        0's weights, the variables rank 0's)."""
        src = self.get("module") if self.is_set("module") else self.get_or_fail("variables")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = process_mesh(dev)
        key = (id(src), dev, mesh.size)
        if self._placed_key != key:
            if self.is_set("module"):
                # a module elsewhere is copied, so the caller's stays put
                on = {t.device for t in list(src.parameters()) + list(src.buffers())}
                keep = on <= {dev} and mesh.size == 1
                run = (src if keep else copy.deepcopy(src).to(dev)).eval()
                if mesh.size > 1:
                    held = list(run.parameters()) + list(run.buffers())
                    with torch.no_grad():
                        for t, v in zip(held, replicate(held, mesh)):
                            t.copy_(v)
            else:
                placed = _to_device(src, dev)
                if mesh.size > 1:
                    placed = replicate(placed, mesh)
                fn = self.get_or_fail("apply_fn")

                def run(x: torch.Tensor) -> Any:
                    return fn(placed, x)

            self._placed, self._placed_key = run, key
        return self._placed

    def _effective_batch(self, mesh: Mesh) -> int:
        """``batch_size`` rounded up to a multiple of the world size."""
        bs = self.get("batch_size")
        return -(-bs // mesh.size) * mesh.size

    def _select(self, out: Any) -> torch.Tensor:
        if isinstance(out, dict):
            node = self.get("output_node")
            if node is None:
                raise ValueError(f"the model returned outputs {sorted(out)}; set output_node")
            return out[node]
        return out

    def apply_batch(self, x: np.ndarray) -> np.ndarray:
        """Evaluate host rows in fixed batches; returns host outputs in order.

        Over more than one rank a collective: every rank must pass the same
        rows, gets its block of each batch computed on its device and the
        whole output back (ValueError when the ranks' row counts differ)."""
        dev = resolve_device(self.get("device"))
        mesh = process_mesh(dev)
        run = self._runner(dev)
        dt = self.get("input_dtype")
        x = np.asarray(x, dtype=dt) if dt else np.asarray(x)
        n, bs = x.shape[0], self._effective_batch(mesh)
        host = torch.from_numpy(np.ascontiguousarray(x))
        if mesh.size > 1:
            check_same_rows([n, int(np.prod(x.shape[1:], dtype=np.int64))], mesh,
                            "TorchModel.apply_batch")
            host, bs = _rank_block(host, bs, mesh), bs // mesh.size
        outs: list = []
        with torch.inference_mode():
            if dev.type == "cpu":
                for i in range(0, max(host.shape[0], 1), bs):
                    outs.append(_host(self._select(run(_padded(host[i: i + bs], bs)))))
            else:
                self._apply_cuda(host, bs, dev, run, outs)
        y = np.concatenate(outs, axis=0)
        if mesh.size > 1:
            y = _gathered(y, bs, mesh)
        return y[:n]

    def _apply_cuda(self, host: torch.Tensor, bs: int, dev: torch.device, run: Any,
                    outs: list) -> None:
        n = host.shape[0]
        k = self._MAX_IN_FLIGHT
        staging = [torch.empty((bs,) + tuple(host.shape[1:]), dtype=host.dtype,
                               pin_memory=True) for _ in range(min(k, -(-max(n, 1) // bs)))]
        pending: deque = deque()
        for j, i in enumerate(range(0, max(n, 1), bs)):
            if len(pending) >= k:
                outs.append(_finish(pending.popleft()))
            buf = staging[j % len(staging)]  # its last batch has finished
            rows = host[i: i + bs]
            buf[: len(rows)].copy_(rows)
            buf[len(rows):].zero_()
            y = self._select(run(buf.to(dev, non_blocking=True)))
            back = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            back.copy_(y, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            pending.append((done, back))
        outs.extend(_finish(p) for p in pending)

    # -- stage interface ----------------------------------------------------

    def transform(self, df: DataFrame) -> DataFrame:
        ic = self.get_or_fail("input_col")
        oc = self.get_or_fail("output_col")

        def fn(p: Partition) -> Partition:
            q = dict(p)
            x = p[ic]
            if x.dtype == object:  # ragged rows: stack (must be uniform shape)
                x = np.stack(list(x))
            q[oc] = self.apply_batch(x)
            return q

        # partitions run one after another: there is one device a rank (and
        # over ranks each partition's gather must meet on every rank in
        # order), and the overlap comes from the batches in flight inside
        # apply_batch
        return df.map_partitions(fn, parallel=False)


def _rank_block(host: torch.Tensor, bs: int, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of every batch of ``bs`` rows of the
    rows zero-padded to whole batches, the blocks one after another."""
    k = -(-max(host.shape[0], 1) // bs)
    if host.shape[0] < k * bs:
        host = torch.cat([host, host.new_zeros((k * bs - host.shape[0],) + tuple(host.shape[1:]))])
    per = bs // mesh.size
    return host.view((k, mesh.size, per) + tuple(host.shape[1:]))[:, mesh.rank].reshape(
        (k * per,) + tuple(host.shape[1:]))


def _gathered(y: np.ndarray, per: int, mesh: Mesh) -> np.ndarray:
    """Every rank's block outputs ``y`` (batch after batch of ``per``
    rows) all-gathered and put back in row order: batch by batch, the
    ranks' blocks in rank order."""
    got = collectives.all_gather(torch.from_numpy(np.ascontiguousarray(y)), mesh.group,
                                 tiled=False).numpy()
    k = y.shape[0] // per
    got = got.reshape((mesh.size, k, per) + y.shape[1:]).swapaxes(0, 1)
    return got.reshape((k * mesh.size * per,) + y.shape[1:])


def _padded(rows: torch.Tensor, bs: int) -> torch.Tensor:
    if rows.shape[0] == bs:
        return rows
    pad = torch.zeros((bs - rows.shape[0],) + tuple(rows.shape[1:]), dtype=rows.dtype)
    return torch.cat([rows, pad])


def _finish(item: tuple) -> np.ndarray:
    done, back = item
    done.synchronize()
    return _host(back)
