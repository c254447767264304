"""Nearest-neighbour search (reference: nn/, SURVEY.md §2.13): the port of
``mmlspark_tpu.nn``.

The query path is a brute-force max-inner-product product + top-k on the
card (ties to the lower index row, as ``lax.top_k``); the serializable
host :class:`BallTree` / :class:`ConditionalBallTree` is kept for parity
with the reference's data structure (BallTree.scala:32-99) and for hosts
without a card.
"""

from mmlspark_tpu_torch.nn.balltree import BallTree, BestMatch, ConditionalBallTree
from mmlspark_tpu_torch.nn.knn import KNN, ConditionalKNN, ConditionalKNNModel, KNNModel

__all__ = [
    "BallTree",
    "ConditionalBallTree",
    "BestMatch",
    "KNN",
    "KNNModel",
    "ConditionalKNN",
    "ConditionalKNNModel",
]
