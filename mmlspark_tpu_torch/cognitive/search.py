"""Search integrations: Bing-style image search + Azure-Search-style sink
(cognitive/BingImageSearch.scala, AzureSearch.scala analogues).

The PyTorch port's copy of ``mmlspark_tpu.cognitive.search``: host code
over the port's ``io``, no device.
"""

from __future__ import annotations

import concurrent.futures as _futures
import json
import urllib.parse
from typing import Any, List, Optional, Sequence

from mmlspark_tpu_torch.cognitive import schemas as S
from mmlspark_tpu_torch.cognitive.base import CognitiveServiceBase, ServiceParam
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.io.clients import AdvancedHandler
from mmlspark_tpu_torch.io.http_schema import HTTPRequestData
from mmlspark_tpu_torch.io.parsers import _to_jsonable


class BingImageSearch(CognitiveServiceBase):
    """Query column -> image-search results (GET /images/search?q=...)."""

    query = ServiceParam("search query (value or column)")
    count = ServiceParam("results per query", default={"value": 10})
    offset = ServiceParam("result offset", default={"value": 0})
    image_type = ServiceParam("imageType filter")

    def _build_request(self, vals: dict) -> Optional[dict]:
        q = vals.get("query")
        if q is None:
            return None
        parts = [
            "q=" + urllib.parse.quote(str(q)),
            f"count={int(vals.get('count') or 10)}",
            f"offset={int(vals.get('offset') or 0)}",
        ]
        if vals.get("image_type"):
            parts.append("imageType=" + vals["image_type"])
        url = self.get_or_fail("url").rstrip("/") + "/images/search?" + "&".join(parts)
        headers = {}
        key = self._resolve("subscription_key", vals)
        if key:
            headers["Ocp-Apim-Subscription-Key"] = key
        return HTTPRequestData(url, "GET", headers)

    _response_schema = List[S.BingImage]

    def _project_response(self, obj: Any) -> Any:
        from typing import List as _L

        return S.from_json(_L[S.BingImage], (obj or {}).get("value"))

    @staticmethod
    def downloadFromUrls(
        df: DataFrame, url_col: str, bytes_col: str = "bytes",
        concurrency: int = 8, timeout: float = 30.0,
    ) -> DataFrame:
        """Fetch each URL into a bytes column (the reference's
        BingImageSearch.downloadFromUrls helper)."""
        from mmlspark_tpu_torch.io.clients import send_request

        def fn(p: dict) -> dict:
            import numpy as np

            urls = list(p[url_col])
            out = np.empty(len(urls), dtype=object)
            with _futures.ThreadPoolExecutor(max_workers=concurrency) as pool:
                resps = pool.map(
                    lambda u: send_request(
                        {"url": u, "method": "GET", "headers": {}}, timeout=timeout
                    ) if u else None,
                    urls,
                )
                for i, r in enumerate(resps):
                    out[i] = r["entity"] if r and r["status_code"] // 100 == 2 else None
            q = dict(p)
            q[bytes_col] = out
            return q

        return df.map_partitions(fn)


class AzureSearchWriter:
    """Batch-upload DataFrame rows as documents to a search index
    (AzureSearch.scala AddDocuments analogue): POST
    ``{"value": [{"@search.action": ..., **doc}, ...]}`` to
    ``{url}/indexes/{index}/docs/index``."""

    @staticmethod
    def write(
        df: DataFrame,
        url: str,
        index_name: str,
        key: Optional[str] = None,
        action: str = "upload",
        action_col: Optional[str] = None,
        batch_size: int = 100,
        api_version: str = "2019-05-06",
        timeout: float = 30.0,
    ) -> list:
        rows = [dict(r) for r in df.collect()]
        endpoint = (
            url.rstrip("/") + f"/indexes/{index_name}/docs/index"
            f"?api-version={api_version}"
        )
        headers = {"Content-Type": "application/json"}
        if key:
            headers["api-key"] = key
        handler = AdvancedHandler(timeout=timeout)
        batches = [rows[i: i + batch_size] for i in range(0, len(rows), batch_size)]
        resps = []
        for batch in batches:
            docs = []
            for r in batch:
                doc = {k: _to_jsonable(v) for k, v in r.items() if k != action_col}
                doc["@search.action"] = (
                    str(r[action_col]) if action_col else action
                )
                docs.append(doc)
            resp = handler(
                HTTPRequestData(endpoint, "POST", headers, json.dumps({"value": docs}))
            )
            if resp["status_code"] // 100 != 2:
                raise RuntimeError(
                    f"AzureSearchWriter: batch failed "
                    f"{resp['status_code']} {resp['reason']}"
                )
            resps.append(resp)
        return resps


# -- index management (AzureSearchAPI.scala:16-150) ---------------------------

EDM_TYPES = (
    "Edm.String", "Collection(Edm.String)", "Edm.Boolean", "Edm.Int32",
    "Edm.Int64", "Edm.Double", "Edm.DateTimeOffset", "Edm.GeographyPoint",
    "Edm.ComplexType",
)


class SearchIndex:
    """Index lifecycle for the search sink (SearchIndex object in
    AzureSearchAPI.scala: ``getExisting`` lists index names,
    ``createIfNoneExists`` validates the index JSON field by field and
    creates the index only when absent). ``url`` is the service endpoint
    (the reference builds it from a service name; local mocks pass a full
    URL)."""

    DEFAULT_API_VERSION = "2019-05-06"

    @staticmethod
    def validate_index(index: dict) -> dict:
        """Field-by-field validation (validIndexJson/validIndexField):
        non-empty names, known EDM types, exactly one Edm.String key
        field, and the searchable/sortable/facetable type constraints."""
        if not index.get("name"):
            raise ValueError("index needs a non-empty 'name'")
        fields = index.get("fields") or []
        if not fields:
            raise ValueError("index needs at least one field")
        keys = 0
        for f in fields:
            name = f.get("name")
            if not name:
                raise ValueError("every field needs a non-empty 'name'")
            t = f.get("type")
            if t not in EDM_TYPES:
                raise ValueError(
                    f"field {name!r}: unknown EDM type {t!r} "
                    f"(expected one of {EDM_TYPES})"
                )
            if f.get("searchable") and t not in (
                "Edm.String", "Collection(Edm.String)"
            ):
                raise ValueError(
                    f"field {name!r}: only Edm.String and "
                    "Collection(Edm.String) fields can be searchable"
                )
            if f.get("sortable") and t == "Collection(Edm.String)":
                raise ValueError(
                    f"field {name!r}: Collection(Edm.String) fields "
                    "cannot be sortable"
                )
            if f.get("facetable") and t == "Edm.GeographyPoint":
                raise ValueError(
                    f"field {name!r}: Edm.GeographyPoint fields "
                    "cannot be facetable"
                )
            if f.get("key"):
                keys += 1
                if t != "Edm.String":
                    raise ValueError(
                        f"field {name!r}: the key field must be Edm.String"
                    )
        if keys != 1:
            raise ValueError(f"index needs exactly one key field, got {keys}")
        return index

    @classmethod
    def get_existing(
        cls, url: str, key: Optional[str] = None,
        api_version: str = DEFAULT_API_VERSION, timeout: float = 30.0,
    ) -> list:
        headers = {"api-key": key} if key else {}
        # same 429/5xx retry policy as the create POST below
        resp = AdvancedHandler(timeout=timeout)(
            HTTPRequestData(
                url.rstrip("/")
                + f"/indexes?api-version={api_version}&$select=name",
                "GET", headers,
            )
        )
        if resp["status_code"] // 100 != 2:
            raise RuntimeError(
                f"SearchIndex.get_existing: {resp['status_code']} {resp['reason']}"
            )
        body = json.loads(resp["entity"] or b"{}")
        return [i.get("name") for i in body.get("value") or []]

    @classmethod
    def create_if_none_exists(
        cls, url: str, index: Any, key: Optional[str] = None,
        api_version: str = DEFAULT_API_VERSION, timeout: float = 30.0,
    ) -> bool:
        """Create the (validated) index when absent; returns True when a
        create happened (createIfNoneExists asserts the 201 the same way)."""
        if isinstance(index, str):
            index = json.loads(index)
        cls.validate_index(index)
        if index["name"] in cls.get_existing(url, key, api_version, timeout):
            return False
        headers = {"Content-Type": "application/json"}
        if key:
            headers["api-key"] = key
        resp = AdvancedHandler(timeout=timeout)(
            HTTPRequestData(
                url.rstrip("/") + f"/indexes?api-version={api_version}",
                "POST", headers, json.dumps(index),
            )
        )
        if resp["status_code"] != 201:
            raise RuntimeError(
                f"SearchIndex.create_if_none_exists: "
                f"{resp['status_code']} {resp['reason']}"
            )
        return True
