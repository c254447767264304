"""Fleet-scale experiment orchestration (docs/experiments.md).

ASHA successive halving driven across the fleet: an
:class:`~mmlspark_tpu_torch.experiments.controller.ExperimentController`
(``fleet tune``) samples a seeded search space, schedules each trial as
a supervisor charge running the ``fleet train`` machinery to a rung
boundary, checkpoints through the content-addressed artifact plane, and
promotes the top 1/eta per rung with write-once generation-CAS records
— so two controllers can never both promote, and a restarted controller
resumes the experiment from registry state alone. The winner is
auto-published into serving through the epoch-fenced Publisher path.

The PyTorch port of ``mmlspark_tpu.experiments``: the controller is host
code; its trials are the port's ``fleet trial`` processes, each training
through ``fleet train``'s GBDT member on the card (``--device``, the
histogram kernels) unless told ``--device cpu``.
"""

from mmlspark_tpu_torch.experiments.asha import (
    leaderboard,
    n_promote,
    promote,
    rung_boundaries,
)
from mmlspark_tpu_torch.experiments.records import (
    ExperimentState,
    cas_commit,
    read_state,
)

__all__ = [
    "ExperimentController",
    "ExperimentState",
    "cas_commit",
    "leaderboard",
    "n_promote",
    "promote",
    "read_state",
    "run_trial",
    "rung_boundaries",
]


def __getattr__(name: str):
    # the controller/trial entry points drag in the serving stack —
    # loaded lazily so `from mmlspark_tpu_torch.experiments import asha` stays
    # import-light for the pure-math consumers (lint tools, tests)
    if name == "ExperimentController":
        from mmlspark_tpu_torch.experiments.controller import ExperimentController

        return ExperimentController
    if name == "run_trial":
        from mmlspark_tpu_torch.experiments.trial import run_trial

        return run_trial
    raise AttributeError(name)
