"""OnlineTrainer: incremental VW training over feedback micro-batches.

The PyTorch port of ``mmlspark_tpu.online.trainer``. A thin stateful
wrapper over ``vw/learner.py``'s :func:`train_sparse_sgd_state`: the full
optimizer state (weights, AdaGrad accumulator, schedule counter) lives in
``self.state`` as tensors on the trainer's device (the card unless given
``device="cpu"``) and stays **device-resident between micro-batches** —
each ``step()`` is one ``vw_pass`` launch a pass (``ops/csrc/sgd.cu``)
warm-started from the previous state, and the weights only come to host
when the publisher snapshots them.

The learner updates a copy of the state it is given and returns new
tensors, so ``self.state`` is replaced whole by each step: a snapshot
taken on another thread reads a state no running step writes into, and
:meth:`weights_host` returns a host copy, never a view.

Because the whole state is carried (not just weights), feeding rows
chunk-by-chunk is *bit-identical* to one batch ``train_sparse_sgd`` call
over the concatenated rows whenever chunk sizes are multiples of the
minibatch size (the warm-start identity pinned in
tests/test_torch_port_online.py). ``batch`` (64 by default, the JAX
trainer's) and ``distributed`` are passed to the learner explicitly: its
own default minibatch on the card is 1,024. ``distributed=True`` over a
``torch.distributed`` group of two or more ranks averages ``w`` and ``g2``
over them after every pass (VW's allreduce-per-pass semantics), trading
that identity for multi-card throughput; with one rank it is the
single-device program.

Input micro-batches are plain DataFrames with a label column plus
either a sparse features column (``{"i": ..., "v": ...}`` rows — the
``VowpalWabbitFeaturizer`` output, or raw JSON dicts from the HTTP
ingest path) or a text column hashed here through the featurizer.
``initial_weights`` (numpy) is how weights cross between this trainer
and the JAX package's.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.vw.learner import (
    LOSS_HINGE,
    LOSS_LOGISTIC,
    LOSSES,
    SGDState,
    sgd_init,
    train_sparse_sgd_state,
)
from mmlspark_tpu_torch.vw.sparse import pad_sparse_batch

_M_EXAMPLES = obs.counter(
    "mmlspark_online_examples_total", "Examples trained by the online loop",
)
_M_BATCHES = obs.counter(
    "mmlspark_online_batches_total", "Micro-batches trained",
)
_M_TRAIN_S = obs.histogram(
    "mmlspark_online_train_seconds", "Wall time per training micro-batch",
)


class OnlineTrainer:
    """Incremental trainer: ``step(chunk)`` folds one micro-batch into
    the resident learner state.

    ``text_col``: hash this string column through a
    ``VowpalWabbitFeaturizer`` (whitespace-split tokens) instead of
    reading pre-hashed ``features_col`` rows. ``no_constant`` mirrors
    the estimator's intercept semantics — published weights score
    identically through the ``vw:`` serving handler and the
    ``VowpalWabbit*Model`` stages. ``device``: where the state lives and
    the passes run (None = the card; it raises without one)."""

    def __init__(
        self,
        num_bits: int = 18,
        loss: str = LOSS_LOGISTIC,
        lr: float = 0.5,
        power_t: float = 0.5,
        l2: float = 0.0,
        adaptive: bool = True,
        batch: int = 64,
        num_passes: int = 1,
        features_col: str = "features",
        label_col: str = "label",
        weight_col: Optional[str] = None,
        text_col: Optional[str] = None,
        no_constant: bool = False,
        distributed: bool = False,
        quantile_tau: float = 0.5,
        seed: int = 0,
        initial_weights: Optional[np.ndarray] = None,
        device: Any = None,
    ):
        if loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}, got {loss!r}")
        self.device = resolve_device(device)
        self.num_bits = int(num_bits)
        self.loss = loss
        self.lr = lr
        self.power_t = power_t
        self.l2 = l2
        self.adaptive = adaptive
        self.batch = int(batch)
        self.num_passes = int(num_passes)
        self.features_col = features_col
        self.label_col = label_col
        self.weight_col = weight_col
        self.text_col = text_col
        self.no_constant = no_constant
        self.distributed = distributed
        self.quantile_tau = quantile_tau
        self.seed = seed
        self.state: SGDState = sgd_init(
            self.num_bits, initial_weights, device=self.device
        )
        self.examples = 0
        self.batches = 0
        self._featurizer: Any = None

    # -- featurization -------------------------------------------------------

    def _featurize(self, chunk: DataFrame) -> tuple:
        """Chunk -> (idx, val, y, wt) padded arrays, constant appended."""
        from mmlspark_tpu_torch.vw.estimators import _append_constant

        if self.text_col is not None and self.text_col in chunk.columns:
            if self._featurizer is None:
                from mmlspark_tpu_torch.vw.featurizer import VowpalWabbitFeaturizer

                self._featurizer = VowpalWabbitFeaturizer(
                    input_cols=[self.text_col],
                    string_split_input_cols=[self.text_col],
                    output_col=self.features_col,
                    num_bits=self.num_bits,
                    seed=self.seed,
                )
            chunk = self._featurizer.transform(chunk)
        if self.features_col in chunk.columns:
            rows = chunk[self.features_col]
            norm = np.empty(len(rows), dtype=object)
            for r, cell in enumerate(rows):
                # rows may be JSON dicts with list values; pad_sparse_batch
                # indexes/assigns them like arrays already, but a missing
                # key must fail loudly per row, not per chunk
                norm[r] = {"i": cell["i"], "v": cell["v"]}
        elif "i" in chunk.columns and "v" in chunk.columns:
            # the HTTP ingest wire shape: flat rows {"i": [...],
            # "v": [...], "label": y} become per-row sparse cells
            iv, vv = chunk["i"], chunk["v"]
            norm = np.empty(len(chunk), dtype=object)
            for r in range(len(chunk)):
                norm[r] = {"i": iv[r], "v": vv[r]}
        else:
            raise ValueError(
                f"micro-batch has no {self.features_col!r} column and no "
                f"i/v pair (columns: {chunk.columns})"
            )
        idx, val = pad_sparse_batch(norm)
        if not self.no_constant:
            idx, val = _append_constant(idx, val, self.num_bits)
        y = np.asarray(chunk[self.label_col], np.float64).astype(np.float32)
        if self.loss in (LOSS_LOGISTIC, LOSS_HINGE):
            y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
        wt = None
        if self.weight_col and self.weight_col in chunk.columns:
            wt = np.asarray(chunk[self.weight_col], np.float64).astype(
                np.float32
            )
        return idx, val, y, wt

    # -- training ------------------------------------------------------------

    def step(self, chunk: DataFrame) -> int:
        """Fold one micro-batch into the learner state; returns rows
        trained (0 for an empty chunk)."""
        n = len(chunk)
        if n == 0:
            return 0
        idx, val, y, wt = self._featurize(chunk)
        return self.step_arrays(idx, val, y, wt)

    def step_arrays(
        self,
        idx: np.ndarray,
        val: np.ndarray,
        y: np.ndarray,
        wt: Optional[np.ndarray] = None,
    ) -> int:
        t0 = time.perf_counter()
        # the learner returns new tensors (it updates a copy): the state
        # a concurrent snapshot holds is never written
        self.state = train_sparse_sgd_state(
            idx, val, y, wt, self.num_bits, self.state,
            loss=self.loss, num_passes=self.num_passes, batch=self.batch,
            lr=self.lr, power_t=self.power_t, l2=self.l2,
            adaptive=self.adaptive, distributed=self.distributed,
            quantile_tau=self.quantile_tau, device=self.device,
        )
        n = int(len(y))
        self.examples += n
        self.batches += 1
        _M_EXAMPLES.inc(n)
        _M_BATCHES.inc()
        _M_TRAIN_S.observe(time.perf_counter() - t0)
        return n

    # -- snapshots -----------------------------------------------------------

    def weights_host(self) -> np.ndarray:
        """A host copy of the current weights (the publish-time sync);
        never a view of a tensor a later step could write."""
        return self.state.w.detach().to("cpu", copy=True).numpy()

    def snapshot_meta(self) -> dict:
        """What a published artifact must carry to score identically."""
        return {
            "num_bits": self.num_bits,
            "loss": self.loss,
            "no_constant": self.no_constant,
            "quantile_tau": self.quantile_tau,
            "examples": self.examples,
        }

    def to_model(self) -> Any:
        """The current weights as a fitted ``VowpalWabbit*Model`` stage
        (classification for logistic/hinge, regression otherwise) on the
        trainer's device — the offline-scoring view of the online
        learner."""
        from mmlspark_tpu_torch.core.dataframe import DataFrame as DF
        from mmlspark_tpu_torch.vw.estimators import (
            VowpalWabbitClassificationModel,
            VowpalWabbitRegressionModel,
        )

        cls = (
            VowpalWabbitClassificationModel
            if self.loss in (LOSS_LOGISTIC, LOSS_HINGE)
            else VowpalWabbitRegressionModel
        )
        m = cls()
        m.set(
            weights=self.weights_host(),
            num_bits=self.num_bits,
            features_col=self.features_col,
            no_constant=self.no_constant,
            loss_function=self.loss,
            device=self.device.type,
            performance_statistics=DF.from_dict(
                {"rows": [self.examples], "batches": [self.batches]}
            ),
        )
        return m


__all__ = ["OnlineTrainer"]
