"""VW-equivalent online learning on the card: the port of ``mmlspark_tpu.vw``.

Hashed sparse features -> device SGD (AdaGrad) as hand-written CUDA
kernels (``ops/sgd.py``), replacing VW's native train loop
(vw/VowpalWabbitBase.scala). One device: the per-pass weight allreduce
comes with the port's ``parallel/`` (ROADMAP.md, A4).
"""

from mmlspark_tpu_torch.vw.contextual_bandit import (
    ContextualBanditMetrics,
    VowpalWabbitContextualBandit,
    VowpalWabbitContextualBanditModel,
)
from mmlspark_tpu_torch.vw.estimators import (
    VowpalWabbitClassificationModel,
    VowpalWabbitClassifier,
    VowpalWabbitRegressionModel,
    VowpalWabbitRegressor,
)
from mmlspark_tpu_torch.vw.featurizer import (
    VowpalWabbitFeaturizer,
    VowpalWabbitInteractions,
)
from mmlspark_tpu_torch.vw.sparse import concat_sparse, make_sparse, pad_sparse_batch

__all__ = [
    "ContextualBanditMetrics",
    "VowpalWabbitClassifier",
    "VowpalWabbitClassificationModel",
    "VowpalWabbitContextualBandit",
    "VowpalWabbitContextualBanditModel",
    "VowpalWabbitFeaturizer",
    "VowpalWabbitInteractions",
    "VowpalWabbitRegressor",
    "VowpalWabbitRegressionModel",
    "concat_sparse",
    "make_sparse",
    "pad_sparse_batch",
]
