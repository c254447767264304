"""Hyperparameter search: the port of ``mmlspark_tpu.automl``, with every
name of its ``__all__``.

:mod:`~mmlspark_tpu_torch.automl.hyperparams` is a copy of the JAX
package's pure-Python module (the experiment controller, ``experiments/``,
samples its trials from it); :mod:`~mmlspark_tpu_torch.automl.tune` holds
``TuneHyperparameters`` and ``FindBestModel``.
"""

from mmlspark_tpu_torch.automl.hyperparams import (
    DefaultHyperparams,
    DiscreteHyperParam,
    GridSpace,
    HyperparamBuilder,
    RandomSpace,
    RangeHyperParam,
)
from mmlspark_tpu_torch.automl.tune import (
    EvaluationUtils,
    FindBestModel,
    FindBestModelResult,
    TuneHyperparameters,
)

__all__ = [
    "TuneHyperparameters",
    "FindBestModel",
    "FindBestModelResult",
    "EvaluationUtils",
    "HyperparamBuilder",
    "GridSpace",
    "RandomSpace",
    "DiscreteHyperParam",
    "RangeHyperParam",
    "DefaultHyperparams",
]
