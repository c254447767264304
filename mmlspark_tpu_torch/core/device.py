"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a CUDA request on a machine without a card raises
instead of quietly running elsewhere.
"""

from __future__ import annotations

import torch

from mmlspark_tpu_torch.core.params import Param, Params


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
