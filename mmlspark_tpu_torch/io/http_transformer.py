"""HTTP-on-DataFrame transformers.

``HTTPTransformer`` (io/http/HTTPTransformer.scala:88-120 analogue): a
column of request rows is sent with bounded per-partition concurrency;
responses land in the output column. Partitions already run on the task
pool, so each partition fans its rows out over a small futures buffer —
the AsyncClient + ``AsyncUtils.bufferedAwait`` design.

``SimpleHTTPTransformer`` (io/http/SimpleHTTPTransformer.scala:111-154
analogue): assembles [optional minibatch] -> input parser -> HTTP ->
error split -> output parser -> [flatten] as one stage.

This is the PyTorch port's copy of ``mmlspark_tpu.io.http_transformer``:
host code over the port's ``io.clients``, with the same bounded
concurrency (a pool of ``concurrency`` threads per partition call) and
the same error split and flatten. A model behind the URL (a port
``WorkerServer``) runs on its own device.
"""

from __future__ import annotations

import concurrent.futures as _futures
from typing import Any, Optional

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import (
    ComplexParam,
    HasInputCol,
    HasOutputCol,
    Param,
    Params,
)
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.io.clients import AdvancedHandler, BasicHandler
from mmlspark_tpu_torch.io.parsers import JSONInputParser, JSONOutputParser
from mmlspark_tpu_torch.io.shared import SharedVariable


class _HasHandler(Params):
    """Shared handler/concurrency params (HasHandler analogue)."""

    concurrency = Param(
        "max in-flight requests per partition", default=8, type_=int,
        validator=lambda v: v > 0,
    )
    timeout = Param("per-request timeout seconds", default=60.0, type_=float)
    use_advanced_handler = Param("retry with backoff on 429/5xx", default=True, type_=bool)
    backoffs_ms = Param("retry backoff schedule (ms)", default=[100, 500, 1000], type_=list)
    custom_handler = ComplexParam("override handler fn request->response")

    def _make_handler(self) -> Any:
        if self.get("custom_handler") is not None:
            return self.get("custom_handler")
        if self.get("use_advanced_handler"):
            return AdvancedHandler(
                backoffs_ms=self.get("backoffs_ms"), timeout=self.get("timeout")
            )
        return BasicHandler(timeout=self.get("timeout"))


class HTTPTransformer(Transformer, _HasHandler, HasInputCol, HasOutputCol):
    """Request-row column -> response-row column, async per partition."""

    def pipeline_io(self) -> tuple:
        """Declared I/O for the pipeline compiler: host-bound (network),
        row-local, row-preserving — exactly the stage the critical-path
        scheduler can overlap with an independent branch."""
        return (self.get_or_fail("input_col"),), (self.get_or_fail("output_col"),)

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_fail("input_col")
        out_col = self.get_or_fail("output_col")
        concurrency = self.get("concurrency")
        # one handler per process; closures over it stay picklable
        handler_var = SharedVariable(self._make_handler)

        def col_fn(p: dict) -> np.ndarray:
            reqs = list(p[in_col])
            handler = handler_var.get()
            out = np.empty(len(reqs), dtype=object)
            if not reqs:
                return out
            # IO-bound: a private bounded pool per partition call overlaps
            # requests without starving the partition task pool
            with _futures.ThreadPoolExecutor(max_workers=concurrency) as pool:
                for i, resp in enumerate(pool.map(
                    lambda r: None if r is None else handler(r), reqs
                )):
                    out[i] = resp
            return out

        return df.with_column(out_col, col_fn)


class SimpleHTTPTransformer(Transformer, _HasHandler, HasInputCol, HasOutputCol):
    """One-stop data->request->send->parse stage."""

    url = Param("service URL", type_=str)
    method = Param("HTTP method", default="POST", type_=str)
    headers = Param("extra request headers", default={}, type_=dict)
    input_parser = ComplexParam("stage mapping data col -> request col (default JSON POST)")
    output_parser = ComplexParam("stage mapping response col -> output col (default JSON)")
    error_col = Param("column for failed-response rows", default="", type_=str)
    flatten_output = Param(
        "explode parsed list responses back to rows (after a minibatcher)",
        default=False, type_=bool,
    )
    mini_batcher = ComplexParam("optional minibatching transformer applied first")

    def _error_col(self) -> str:
        return self.get("error_col") or f"{self.get_or_fail('output_col')}_error"

    def pipeline_io(self) -> Any:
        """Declared I/O for the pipeline compiler: reads the data column,
        writes the error column then the output column (staged insertion
        order). Declines (None -> opaque barrier) when a minibatcher or
        ``flatten_output`` changes row structure."""
        if self.get("mini_batcher") is not None or self.get("flatten_output"):
            return None
        return (
            (self.get_or_fail("input_col"),),
            (self._error_col(), self.get_or_fail("output_col")),
        )

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_fail("input_col")
        out_col = self.get_or_fail("output_col")
        err_col = self._error_col()

        batcher = self.get("mini_batcher")
        if batcher is not None:
            df = batcher.transform(df)

        from mmlspark_tpu_torch.core.schema import find_unused_column

        req_col = find_unused_column("_request", df.columns)
        resp_col = find_unused_column("_response", df.columns + [req_col])

        parser_in = self.get("input_parser") or JSONInputParser(
            url=self.get_or_fail("url"),
            method=self.get("method"),
            headers=self.get("headers"),
        )
        parser_in = parser_in.copy(
            {"input_col": in_col, "output_col": req_col}
        )
        parser_out = self.get("output_parser") or JSONOutputParser()
        parser_out = parser_out.copy(
            {"input_col": resp_col, "output_col": out_col}
        )

        http = HTTPTransformer(
            input_col=req_col,
            output_col=resp_col,
            concurrency=self.get("concurrency"),
            timeout=self.get("timeout"),
            use_advanced_handler=self.get("use_advanced_handler"),
            backoffs_ms=self.get("backoffs_ms"),
        )
        if self.get("custom_handler") is not None:
            http.set(custom_handler=self.get("custom_handler"))

        out = http.transform(parser_in.transform(df))

        # error split (SimpleHTTPTransformer.scala:96-109): non-2xx responses
        # go to the error column; the parsed output is None for those rows
        def err_fn(p: dict) -> np.ndarray:
            vals = np.empty(len(p[resp_col]), dtype=object)
            for i, r in enumerate(p[resp_col]):
                vals[i] = r if (r is None or r["status_code"] // 100 != 2) else None
            return vals

        out = out.with_column(err_col, err_fn)

        def ok_fn(p: dict) -> np.ndarray:
            vals = np.empty(len(p[resp_col]), dtype=object)
            for i, r in enumerate(p[resp_col]):
                vals[i] = r if (r is not None and r["status_code"] // 100 == 2) else None
            return vals

        out = out.with_column(resp_col, ok_fn)
        out = parser_out.transform(out).drop(req_col, resp_col)

        if self.get("flatten_output"):
            from mmlspark_tpu_torch.stages.batching import FlattenBatch

            # per-batch scalars (the error column, or a None output for a
            # failed batch) must be expanded to per-row values before
            # FlattenBatch concatenates
            def expand(p: dict) -> dict:
                q = dict(p)
                lens = [
                    len(v) if hasattr(v, "__len__") else 1 for v in p[in_col]
                ]
                for col in (out_col, err_col):
                    vals = np.empty(len(lens), dtype=object)
                    for i, (v, n) in enumerate(zip(p[col], lens)):
                        is_rowwise = (
                            col == out_col
                            and isinstance(v, (list, np.ndarray))
                            and len(v) == n
                        )
                        vals[i] = v if is_rowwise else [v] * n
                    q[col] = vals
                return q

            out = FlattenBatch().transform(out.map_partitions(expand))
        return out
