"""Hostile-wire chaos engineering: the fabric itself as the adversary.

The PyTorch port of ``mmlspark_tpu.chaos``, three layers of host code:

- :mod:`mmlspark_tpu_torch.chaos.wire` — :class:`ChaosProxy`, a
  transparent seeded TCP proxy any fleet link can be pointed through,
  with per-link :class:`WireRule` fault schedules (latency/jitter,
  bandwidth throttle, byte-flip at offset, truncate-then-RST, slowloris
  drip, asymmetric blackhole). Same seed => byte-identical fault schedule.
- :mod:`mmlspark_tpu_torch.chaos.conductor` — :class:`ChaosConductor`, a
  timed scenario runner driving wire faults + process signals against a
  live fleet, journaling every action (``fleet chaos``).
- :mod:`mmlspark_tpu_torch.chaos.invariants` — :class:`InvariantChecker`,
  a conservation-law checker over every role's ``/metrics``: nothing the
  fleet accepted may go unaccounted, no matter what the wire did.
"""

from mmlspark_tpu_torch.chaos.conductor import ChaosConductor, Scenario
from mmlspark_tpu_torch.chaos.invariants import InvariantChecker, Violation
from mmlspark_tpu_torch.chaos.wire import RULE_KINDS, ChaosProxy, WireRule

__all__ = [
    "ChaosConductor",
    "ChaosProxy",
    "InvariantChecker",
    "RULE_KINDS",
    "Scenario",
    "Violation",
    "WireRule",
]
