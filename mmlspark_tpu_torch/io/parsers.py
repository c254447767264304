"""Request/response parser stages (io/http/Parsers.scala analogue).

``JSONInputParser`` turns a data column into HTTP request rows for a fixed
URL; ``JSONOutputParser``/``StringOutputParser`` decode response rows;
``Custom*Parser`` lift arbitrary functions. All are ordinary transformers so
they compose inside SimpleHTTPTransformer's internal pipeline. This is
the PyTorch port's copy of ``mmlspark_tpu.io.parsers``, on the port's
``io.http_schema``: host code, no device.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Optional

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import ComplexParam, HasInputCol, HasOutputCol, Param
from mmlspark_tpu_torch.core.pipeline import Transformer


def _to_jsonable(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, (bytes, bytearray)):
        return v.decode("utf-8", "replace")
    return v


class _ObjectColumnTransformer(Transformer):
    """Maps input_col values through ``self._map_value`` into output_col."""

    def _map_value(self, v: Any) -> Any:
        raise NotImplementedError

    def transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_fail("input_col")
        out_col = self.get_or_fail("output_col")

        def col_fn(p: dict) -> np.ndarray:
            vals = [self._map_value(v) for v in p[in_col]]
            out = np.empty(len(vals), dtype=object)
            for i, v in enumerate(vals):
                out[i] = v
            return out

        return df.with_column(out_col, col_fn)


class JSONInputParser(_ObjectColumnTransformer, HasInputCol, HasOutputCol):
    """Data column -> POST request rows with JSON bodies
    (Parsers.scala JSONInputParser analogue)."""

    url = Param("target URL for generated requests", type_=str)
    method = Param("HTTP method", default="POST", type_=str)
    headers = Param("extra headers to attach", default={}, type_=dict)

    def _map_value(self, v: Any) -> Any:
        from mmlspark_tpu_torch.io.http_schema import HTTPRequestData

        headers = {"Content-Type": "application/json"}
        headers.update(self.get("headers") or {})
        return HTTPRequestData(
            self.get_or_fail("url"),
            self.get("method"),
            headers,
            json.dumps(_to_jsonable(v)),
        )


class JSONOutputParser(_ObjectColumnTransformer, HasInputCol, HasOutputCol):
    """Response rows -> parsed JSON values; optional ``data_type`` projects
    the given keys out of the top-level object."""

    data_type = Param("optional list of keys to project from the JSON object", type_=list)

    def _map_value(self, v: Any) -> Any:
        from mmlspark_tpu_torch.io.http_schema import response_to_json

        obj = response_to_json(v)
        keys = self.get("data_type")
        if keys and isinstance(obj, dict):
            return {k: obj.get(k) for k in keys}
        return obj


class StringOutputParser(_ObjectColumnTransformer, HasInputCol, HasOutputCol):
    """Response rows -> entity text (Parsers.scala StringOutputParser)."""

    def _map_value(self, v: Any) -> Any:
        from mmlspark_tpu_torch.io.http_schema import entity_to_string

        return entity_to_string(v)


class CustomInputParser(_ObjectColumnTransformer, HasInputCol, HasOutputCol):
    """UDF value -> request row (Parsers.scala CustomInputParser)."""

    udf = ComplexParam("function value -> request dict")

    def set_udf(self, fn: Callable[[Any], dict]) -> "CustomInputParser":
        return self.set(udf=fn)

    def _map_value(self, v: Any) -> Any:
        return self.get_or_fail("udf")(v)


class CustomOutputParser(_ObjectColumnTransformer, HasInputCol, HasOutputCol):
    """UDF response row -> value (Parsers.scala CustomOutputParser)."""

    udf = ComplexParam("function response dict -> value")

    def set_udf(self, fn: Callable[[dict], Any]) -> "CustomOutputParser":
        return self.set(udf=fn)

    def _map_value(self, v: Any) -> Any:
        return self.get_or_fail("udf")(v)
