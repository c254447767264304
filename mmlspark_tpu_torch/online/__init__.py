"""Continuous learning: streaming feedback -> online training -> zero-drop
publication, on the card.

The PyTorch port of ``mmlspark_tpu.online``: a :class:`FeedbackStream`
source feeds labeled micro-batches into an :class:`OnlineTrainer` that
incrementally updates the device-resident VW learner (``vw/learner.py``:
weights AND AdaGrad state stay on the card between micro-batches, one
``vw_pass`` launch a pass), and a :class:`Publisher` snapshots the weights
into a versioned ``vw:`` ModelStore spec and drives the load -> warm ->
swap path, so a fresh version becomes servable with zero dropped requests
(the workers score it through ``vw_margin``). :class:`OnlineLearningLoop`
is the control loop tying the three together, exporting the **freshness
SLO** — the time from an example entering the system to its model being
servable — as burn rates through ``obs/slo.py``. :class:`Autoscaler` is
the SLO-driven scaling policy the fleet supervisor consults in
``supervise --autoscale`` mode. Everything but the trainer is host code,
with the JAX package's wire formats and metric names.
"""

from mmlspark_tpu_torch.online.autoscaler import Autoscaler, FleetSignals, ScaleSignals
from mmlspark_tpu_torch.online.feedback import FeedbackStream
from mmlspark_tpu_torch.online.loop import OnlineLearningLoop
from mmlspark_tpu_torch.online.publisher import PublishError, Publisher
from mmlspark_tpu_torch.online.trainer import OnlineTrainer

__all__ = [
    "Autoscaler",
    "FeedbackStream",
    "FleetSignals",
    "OnlineLearningLoop",
    "OnlineTrainer",
    "PublishError",
    "Publisher",
    "ScaleSignals",
]
