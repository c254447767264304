"""ServingUDFs analogues (ServingUDFs.scala:16-50): turn typed data into
HTTP reply payloads and request rows into typed data.

The PyTorch port's copy of ``mmlspark_tpu.serving.udfs``."""

from __future__ import annotations

import json
from typing import Any, Optional, Union

import numpy as np

from mmlspark_tpu_torch.serving.server import CachedRequest


def make_reply(data: Any, code: int = 200) -> tuple:
    """Typed value -> (status, body, headers) reply triple (makeReplyUDF)."""
    if isinstance(data, (bytes, bytearray)):
        return code, bytes(data), {"Content-Type": "application/octet-stream"}
    if isinstance(data, str):
        return code, data.encode("utf-8"), {"Content-Type": "text/plain"}
    if isinstance(data, np.ndarray):
        data = data.tolist()
    if isinstance(data, np.generic):
        data = data.item()
    return code, json.dumps(data).encode("utf-8"), {"Content-Type": "application/json"}


def request_to_text(req: CachedRequest) -> str:
    return req.body.decode("utf-8", "replace")


def request_to_json(req: CachedRequest) -> Any:
    """parseRequest analogue for JSON bodies; None on empty/invalid."""
    if not req.body:
        return None
    try:
        return json.loads(req.body)
    except json.JSONDecodeError:
        return None
