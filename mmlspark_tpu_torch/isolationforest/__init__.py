"""Isolation Forest anomaly detection (reference: isolationforest/, SURVEY.md
§2.15): the port of ``mmlspark_tpu.isolationforest``.

The reference wraps ``com.linkedin.isolation-forest``
(IsolationForest.scala:17-60). Trees are grown on the host (cheap: T x psi
subsamples, the JAX package's numpy), stored as dense perfect-binary-tree
arrays, and scored on the card: path traversal is a fixed number of gather
steps over every tree at once, with no per-row or per-tree Python.
"""

from mmlspark_tpu_torch.isolationforest.forest import IsolationForest, IsolationForestModel

__all__ = ["IsolationForest", "IsolationForestModel"]
