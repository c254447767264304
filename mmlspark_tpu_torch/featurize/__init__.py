"""Featurization: the port of ``mmlspark_tpu.featurize``.

Only ``featurize/featurize.py`` (``Featurize`` / ``FeaturizeModel``) is
ported so far; ``clean``, ``indexers`` and ``text`` follow (ROADMAP.md,
Queue A item 6), so this package exports its names only.
"""

from mmlspark_tpu_torch.featurize.featurize import Featurize, FeaturizeModel

__all__ = [
    "Featurize",
    "FeaturizeModel",
]
