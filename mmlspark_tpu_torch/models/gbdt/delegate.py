"""Training-lifecycle callback interface — the LightGBMDelegate analogue.

The port's copy of ``mmlspark_tpu.models.gbdt.delegate``. LightGBM's Spark
package exposes a delegate trait whose hooks fire around batches and
iterations and can rewrite the learning rate mid-training
(lightgbm/LightGBMDelegate.scala, called from TrainUtils.scala:192-218).
Here the same surface, minus the Spark/JNI plumbing: hooks receive plain
Python state. Set it on the estimator (``delegate=...``) or on
``TrainConfig.delegate``.
"""

from __future__ import annotations

from typing import Any, Optional


class LightGBMDelegate:
    """Override any subset; defaults are no-ops (trait parity)."""

    def before_train_batch(
        self, batch_index: int, n_rows: int, previous_booster: Optional[Any]
    ) -> None:
        """numBatches mode: fires before each sequential batch segment."""

    def after_train_batch(self, batch_index: int, booster: Any) -> None:
        """numBatches mode: fires after each segment with its booster."""

    def before_train_iteration(self, iteration: int) -> None:
        """Fires before each boosting iteration."""

    def after_train_iteration(
        self,
        iteration: int,
        eval_result: Optional[tuple],
        is_finished: bool,
    ) -> None:
        """Fires after each iteration. ``eval_result`` is the
        (metric_name, value, higher_is_better) triple when validation ran
        this round, else None; ``is_finished`` is True on the final
        iteration (early stop or last round)."""

    def get_learning_rate(self, iteration: int, previous_rate: float) -> float:
        """Dynamic learning rate: the returned value drives this
        iteration's tree (dynamic-rate delegate semantics). The default
        keeps the configured rate."""
        return previous_rate
