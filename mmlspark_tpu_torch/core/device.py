"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a CUDA request on a machine without a card raises
instead of quietly running elsewhere.

``CAPTURE_LOCK`` serialises CUDA graph captures (and the release of a
captured graph) across the process: the pipeline compiler's segments and
the GBDT trainer's fused rounds take it, and capture in thread-local mode,
so another thread may keep launching, replaying and synchronising on the
card while a capture is under way, and one capture's device-wide
synchronize never lands inside another.
"""

from __future__ import annotations

import threading

import torch

from mmlspark_tpu_torch.core.params import Param, Params


# one CUDA graph capture (or graph release) at a time in the process
CAPTURE_LOCK = threading.Lock()


class HasDevice(Params):
    """The ``device`` param of the estimators and models that train or score
    on the card by default."""

    device = Param(
        "torch device to train/score on: 'cuda' (default; raises without a "
        "card) or 'cpu'", default="cuda", type_=str,
        validator=lambda v: v.split(":")[0] in ("cuda", "cpu"),
    )


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
