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
        "fixed minibatch size; the last batch is padded to it",
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
        """The model on ``dev`` as a function of one batch (made once)."""
        src = self.get("module") if self.is_set("module") else self.get_or_fail("variables")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (id(src), dev)
        if self._placed_key != key:
            if self.is_set("module"):
                # a module elsewhere is copied, so the caller's stays put
                on = {t.device for t in list(src.parameters()) + list(src.buffers())}
                run = (src if on <= {dev} else copy.deepcopy(src).to(dev)).eval()
            else:
                placed = _to_device(src, dev)
                fn = self.get_or_fail("apply_fn")

                def run(x: torch.Tensor) -> Any:
                    return fn(placed, x)

            self._placed, self._placed_key = run, key
        return self._placed

    def _select(self, out: Any) -> torch.Tensor:
        if isinstance(out, dict):
            node = self.get("output_node")
            if node is None:
                raise ValueError(f"the model returned outputs {sorted(out)}; set output_node")
            return out[node]
        return out

    def apply_batch(self, x: np.ndarray) -> np.ndarray:
        """Evaluate host rows in fixed batches; returns host outputs in order."""
        dev = resolve_device(self.get("device"))
        run = self._runner(dev)
        dt = self.get("input_dtype")
        x = np.asarray(x, dtype=dt) if dt else np.asarray(x)
        n, bs = x.shape[0], self.get("batch_size")
        host = torch.from_numpy(np.ascontiguousarray(x))
        outs: list = []
        with torch.inference_mode():
            if dev.type == "cpu":
                for i in range(0, max(n, 1), bs):
                    outs.append(_host(self._select(run(_padded(host[i: i + bs], bs)))))
            else:
                self._apply_cuda(host, bs, dev, run, outs)
        return np.concatenate(outs, axis=0)[:n]

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

        # partitions run one after another: there is one device, and the
        # overlap comes from the batches in flight inside apply_batch
        return df.map_partitions(fn, parallel=False)


def _padded(rows: torch.Tensor, bs: int) -> torch.Tensor:
    if rows.shape[0] == bs:
        return rows
    pad = torch.zeros((bs - rows.shape[0],) + tuple(rows.shape[1:]), dtype=rows.dtype)
    return torch.cat([rows, pad])


def _finish(item: tuple) -> np.ndarray:
    done, back = item
    done.synchronize()
    return _host(back)
