"""Hyperparameter spaces: the port's part of ``mmlspark_tpu.automl``.

Only :mod:`~mmlspark_tpu_torch.automl.hyperparams` is ported (a copy of
the JAX package's pure-Python module): the experiment controller
(``experiments/``) samples its trials from it. ``TuneHyperparameters``
and ``FindBestModel`` (``automl/tune.py``) are queued in ROADMAP.md (A10).
"""

from mmlspark_tpu_torch.automl.hyperparams import (
    DefaultHyperparams,
    DiscreteHyperParam,
    GridSpace,
    HyperparamBuilder,
    RandomSpace,
    RangeHyperParam,
)

__all__ = [
    "HyperparamBuilder",
    "GridSpace",
    "RandomSpace",
    "DiscreteHyperParam",
    "RangeHyperParam",
    "DefaultHyperparams",
]
