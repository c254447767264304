"""CyberML — access-anomaly detection (reference: src/main/python/mmlspark/cyber/,
SURVEY.md §2.16, Python-only in the reference): the port of
``mmlspark_tpu.cyber``.

``AccessAnomaly``: per-tenant collaborative filtering over user→resource
access counts (reference: collaborative_filtering.py:1-988 on Spark ALS);
unusual accesses score high because the factor model assigns them low
predicted affinity. ALS runs on the card (``cyber.als``): each alternating
half-step is a batch of stacked (F, F) solves; complement sampling, the
scalers and the synthetic dataset are the JAX package's host code.
"""

from mmlspark_tpu_torch.cyber.als import als_train, als_predict
from mmlspark_tpu_torch.cyber.anomaly import AccessAnomaly, AccessAnomalyModel
from mmlspark_tpu_torch.cyber.complement import ComplementSampler, complement_sample
from mmlspark_tpu_torch.cyber.dataset import synthetic_access_df
from mmlspark_tpu_torch.cyber.scalers import LinearScalarScaler, StandardScalarScaler

__all__ = [
    "als_train",
    "als_predict",
    "AccessAnomaly",
    "AccessAnomalyModel",
    "ComplementSampler",
    "complement_sample",
    "synthetic_access_df",
    "StandardScalarScaler",
    "LinearScalarScaler",
]
