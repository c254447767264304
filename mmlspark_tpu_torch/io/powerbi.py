"""PowerBI-style streaming-dataset writer.

PowerBIWriter analogue (io/powerbi/PowerBIWriter.scala:27-62): POST rows of
a DataFrame as JSON arrays to a push URL, in minibatches, with bounded
concurrency and retry on 429/5xx. Azure specifics don't matter — any
endpoint accepting ``[{col: val, ...}, ...]`` bodies works. This is the
PyTorch port's copy of ``mmlspark_tpu.io.powerbi``.
"""

from __future__ import annotations

import concurrent.futures as _futures
import json
from typing import Optional, Sequence

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.io.clients import AdvancedHandler
from mmlspark_tpu_torch.io.http_schema import HTTPRequestData
from mmlspark_tpu_torch.io.parsers import _to_jsonable


class PowerBIWriter:
    @staticmethod
    def write(
        df: DataFrame,
        url: str,
        minibatch_size: int = 100,
        concurrency: int = 4,
        headers: Optional[dict] = None,
        backoffs_ms: Sequence[int] = (100, 500, 1000),
        timeout: float = 30.0,
    ) -> list:
        """POST all rows; returns the list of response dicts (one per batch).
        Raises on any non-2xx final status."""
        rows = [dict(r) for r in df.collect()]
        batches = [
            rows[i: i + minibatch_size] for i in range(0, len(rows), minibatch_size)
        ]
        handler = AdvancedHandler(backoffs_ms=backoffs_ms, timeout=timeout)
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})

        def send(batch: list) -> dict:
            body = json.dumps([_to_jsonable(r) for r in batch])
            return handler(HTTPRequestData(url, "POST", hdrs, body))

        with _futures.ThreadPoolExecutor(max_workers=concurrency) as pool:
            resps = list(pool.map(send, batches))
        bad = [r for r in resps if r["status_code"] // 100 != 2]
        if bad:
            raise RuntimeError(
                f"PowerBIWriter: {len(bad)}/{len(resps)} batches failed, "
                f"first: {bad[0]['status_code']} {bad[0]['reason']}"
            )
        return resps
