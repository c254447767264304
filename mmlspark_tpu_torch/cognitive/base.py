"""Cognitive-service transformer base + ServiceParam.

CognitiveServicesBase analogue (cognitive/CognitiveServiceBase.scala:
258-330). A subclass declares ServiceParams and implements
``_build_request(vals) -> request dict | None`` (None rows are skipped —
the reference's ``shouldSkip``); the base transform resolves every
ServiceParam per row (literal or column), fans requests out with the io
layer's retrying handler, and parses JSON into the output column with
non-2xx responses in the error column.

The PyTorch port's copy of ``mmlspark_tpu.cognitive.base``: host code
over the port's ``io``, no device.
"""

from __future__ import annotations

import concurrent.futures as _futures
import json
from typing import Any, Optional

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import HasOutputCol, Param
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.io.clients import AdvancedHandler, BasicHandler
from mmlspark_tpu_torch.io.http_schema import response_to_json


class ServiceParam(Param):
    """Value-or-column param (HasServiceParams, CognitiveServiceBase.scala:
    29-150): holds either ``{"value": v}`` or ``{"col": name}``; resolved
    per row at transform time."""

    def validate(self, value: Any) -> Any:
        if isinstance(value, dict) and set(value) in ({"value"}, {"col"}):
            return value
        return {"value": super().validate(value)}


class _HasServiceParams:
    def set_col(self, name: str, col: str) -> "CognitiveServiceBase":
        """Bind ServiceParam ``name`` to a column instead of a literal."""
        p = self.param(name)
        if not isinstance(p, ServiceParam):
            raise TypeError(f"{name} is not a ServiceParam")
        self._paramMap[name] = {"col": col}
        return self

    def _resolve(self, name: str, row_vals: dict) -> Any:
        v = self.get(name)
        if isinstance(v, dict) and "col" in v:
            return row_vals.get(v["col"])
        if isinstance(v, dict) and "value" in v:
            return v["value"]
        return v

    def _service_cols(self) -> list:
        cols = []
        for pname in self.params():
            v = self.get(pname)
            if isinstance(v, dict) and "col" in v:
                cols.append(v["col"])
        return cols


class CognitiveServiceBase(Transformer, _HasServiceParams, HasOutputCol):
    url = Param("service endpoint URL", type_=str)
    subscription_key = ServiceParam("api key sent as Ocp-Apim-Subscription-Key")
    error_col = Param("column for failed responses", default="", type_=str)
    concurrency = Param("max in-flight requests per partition", default=8, type_=int)
    timeout = Param("per-request timeout seconds", default=60.0, type_=float)
    backoffs_ms = Param("retry backoff schedule (ms)", default=[100, 500, 1000], type_=list)
    use_advanced_handler = Param("retry 429/5xx with backoff", default=True, type_=bool)
    batch_size = Param(
        "documents per HTTP request for batchable services", default=1, type_=int
    )

    # -- subclass surface ----------------------------------------------------

    # subclasses returning non-JSON payloads (e.g. thumbnail bytes) set this
    _binary_response = False
    # typed response record (cognitive/schemas.py) — parsed outputs + column
    # metadata; None keeps raw-dict outputs
    _response_schema = None
    # services whose wire format carries many documents per request set this
    # and implement the _batch_* hooks (SimpleHTTPTransformer.scala:111-154
    # minibatch -> JSON -> flatten pipeline)
    _batchable = False

    def _build_request(self, vals: dict) -> Optional[dict]:
        """Row-resolved ServiceParam values -> request dict (None = skip)."""
        raise NotImplementedError

    def _build_requests(self, vals: dict) -> list:
        """Multi-request rows override this (e.g. windowed audio); default =
        the single ``_build_request`` wrapped in a list."""
        r = self._build_request(vals)
        return [] if r is None else [r]

    def _wrap_handler(self, handler_fn: Any) -> Any:
        """Hook: wrap the per-request handler (runs INSIDE the thread
        pool). Multi-step wire contracts (async operations that poll a
        follow-up URL) compose here so their waiting overlaps across
        rows; default identity."""
        return handler_fn

    def _project_response(self, obj: Any) -> Any:
        """Parsed JSON -> output value; default: the typed record when a
        response schema is declared, else the raw dict."""
        if self._response_schema is not None:
            from mmlspark_tpu_torch.cognitive import schemas as _S

            return _S.from_json(self._response_schema, obj)
        return obj

    # -- batching hooks (only consulted when _batchable) ---------------------

    def _batch_key(self, vals: dict) -> Optional[Any]:
        """Grouping key for one row (rows sharing a key may share a
        request); None = skip the row entirely."""
        raise NotImplementedError

    def _build_batch_request(self, vals_list: list) -> dict:
        """K rows' resolved values -> ONE request carrying K documents."""
        raise NotImplementedError

    def _split_batch_response(self, resp: Optional[dict], k: int) -> list:
        """One response -> K ordered (out, err) pairs."""
        raise NotImplementedError

    def _row_output(self, resps: list) -> tuple:
        """Ordered per-request responses for one row -> (out, err).

        Default: single-request semantics on the first response. Multi-
        request subclasses override to merge.
        """
        resp = resps[0] if resps else None
        if resp is None:
            return None, None
        if resp["status_code"] // 100 == 2:
            try:
                out = (
                    resp["entity"]
                    if self._binary_response
                    else self._project_response(response_to_json(resp))
                )
                return out, None
            except (ValueError, KeyError, TypeError) as e:
                return None, {
                    "status_code": resp["status_code"],
                    "reason": f"parse error: {e}",
                }
        return None, {
            "status_code": resp["status_code"],
            "reason": resp["reason"],
            "entity": resp["entity"],
        }

    # -- shared helpers ------------------------------------------------------

    def _headers(self, vals: dict, content_type: str = "application/json") -> dict:
        headers = {"Content-Type": content_type}
        key = self._resolve("subscription_key", vals)
        if key:
            headers["Ocp-Apim-Subscription-Key"] = key
        return headers

    def _post_json(self, vals: dict, body: Any, path: str = "", query: str = "") -> dict:
        from mmlspark_tpu_torch.io.http_schema import HTTPRequestData

        url = self.get_or_fail("url").rstrip("/") + path + (f"?{query}" if query else "")
        return HTTPRequestData(url, "POST", self._headers(vals), json.dumps(body))

    # -- pipeline-compiler declaration ---------------------------------------

    def pipeline_io(self) -> tuple:
        """Declared I/O for the pipeline compiler: reads the columns bound
        via ``set_col``, writes the output then error column (staged
        insertion order). Host-bound, row-local, row-preserving — the
        scheduler overlaps independent cognitive calls on separate
        branches."""
        out_col = self.get_or_fail("output_col")
        return (
            tuple(self._service_cols()),
            (out_col, self.get("error_col") or f"{out_col}_error"),
        )

    # -- transform -----------------------------------------------------------

    def transform(self, df: DataFrame) -> DataFrame:
        out_col = self.get_or_fail("output_col")
        err_col = self.get("error_col") or f"{out_col}_error"
        handler_fn = (
            AdvancedHandler(backoffs_ms=self.get("backoffs_ms"), timeout=self.get("timeout"))
            if self.get("use_advanced_handler")
            else BasicHandler(timeout=self.get("timeout"))
        )
        handler_fn = self._wrap_handler(handler_fn)
        concurrency = self.get("concurrency")
        param_names = list(self.params())

        bsz = max(1, int(self.get("batch_size") or 1))
        batched = self._batchable and bsz > 1

        def fn_batched(p: dict) -> dict:
            """Minibatch path: K documents per POST, flattened back to rows
            (SimpleHTTPTransformer.scala:111-154 assembles the same
            minibatch -> JSON -> HTTP -> flatten pipeline; TextAnalytics
            posts many documents per call). The practical win: K-fold fewer
            round-trips against rate-limited services."""
            n = len(next(iter(p.values()))) if p else 0
            outs = np.empty(n, dtype=object)
            errs = np.empty(n, dtype=object)
            vals_all: list = [None] * n
            chunks: list = []          # (row indices,)
            cur: list = []
            cur_key: Any = None
            for i in range(n):
                row_vals = {k: v[i] for k, v in p.items()}
                vals_all[i] = {
                    name: self._resolve(name, row_vals) for name in param_names
                }
                try:
                    key = self._batch_key(vals_all[i])
                except (ValueError, TypeError) as e:
                    errs[i] = {"status_code": 0, "reason": str(e)}
                    continue
                if key is None:
                    continue  # skipped row: None out, None err
                if cur and (key != cur_key or len(cur) >= bsz):
                    chunks.append(cur)
                    cur = []
                cur_key = key
                cur.append(i)
            if cur:
                chunks.append(cur)
            if chunks:
                with _futures.ThreadPoolExecutor(max_workers=concurrency) as pool:
                    resps = list(
                        pool.map(
                            lambda idxs: handler_fn(
                                self._build_batch_request(
                                    [vals_all[i] for i in idxs]
                                )
                            ),
                            chunks,
                        )
                    )
                for idxs, resp in zip(chunks, resps):
                    for i, (o, e) in zip(
                        idxs, self._split_batch_response(resp, len(idxs))
                    ):
                        outs[i], errs[i] = o, e
            q = dict(p)
            q[out_col] = outs
            q[err_col] = errs
            return q

        def fn(p: dict) -> dict:
            n = len(next(iter(p.values()))) if p else 0
            # each row may expand to several requests (windowed audio etc.):
            # flatten, fan out once, regroup in request order per row
            row_reqs: list = []
            jobs: list = []  # (row, idx_within_row, request)
            for i in range(n):
                row_vals = {k: v[i] for k, v in p.items()}
                vals = {
                    name: self._resolve(name, row_vals) for name in param_names
                }
                try:
                    reqs = self._build_requests(vals)
                except (ValueError, TypeError) as e:  # bad row input: error, not a crash
                    reqs = [{"__input_error__": str(e)}]
                row_reqs.append(reqs)
                for w, r in enumerate(reqs):
                    if "__input_error__" not in r:
                        jobs.append((i, w, r))
            results: dict = {}
            if jobs:
                with _futures.ThreadPoolExecutor(max_workers=concurrency) as pool:
                    for (i, w), resp in pool.map(
                        lambda j: ((j[0], j[1]), handler_fn(j[2])), jobs
                    ):
                        results[(i, w)] = resp
            outs = np.empty(n, dtype=object)
            errs = np.empty(n, dtype=object)
            row_out_ctx = getattr(self, "_row_output_ctx", None)
            for i, reqs in enumerate(row_reqs):
                if reqs and "__input_error__" in reqs[0]:
                    errs[i] = {"status_code": 0, "reason": reqs[0]["__input_error__"]}
                    continue
                resps = [results.get((i, w)) for w in range(len(reqs))]
                # _row_output_ctx also sees the REQUESTS (per-window
                # metadata like stream offsets rides on the request dicts)
                outs[i], errs[i] = (
                    row_out_ctx(resps, reqs) if row_out_ctx
                    else self._row_output(resps)
                )
            q = dict(p)
            q[out_col] = outs
            q[err_col] = errs
            return q

        out = df.map_partitions(fn_batched if batched else fn)
        if self._response_schema is not None:
            from mmlspark_tpu_torch.cognitive import schemas as _S

            out = out.with_column_metadata(
                out_col, _S.column_metadata(self._response_schema)
            )
        return out
