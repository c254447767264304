"""Anomaly Detector transformers (cognitive/AnomalyDetection.scala analogue).

Wire format: Anomaly Detector v1.0 — POST ``{"series": [{"timestamp",
"value"}...], "granularity": ...}`` to ``/timeseries/last/detect`` (is the
latest point anomalous) or ``/timeseries/entire/detect`` (whole series).

The PyTorch port's copy of ``mmlspark_tpu.cognitive.anomaly``: host code
over the port's ``io``, no device.
"""

from __future__ import annotations

from typing import Any, Optional

from mmlspark_tpu_torch.cognitive import schemas as S
from mmlspark_tpu_torch.cognitive.base import CognitiveServiceBase, ServiceParam


class _AnomalyBase(CognitiveServiceBase):
    series = ServiceParam(
        "time series: list of {timestamp, value} dicts (value or column)"
    )
    granularity = ServiceParam("series granularity", default={"value": "daily"})
    max_anomaly_ratio = ServiceParam("max fraction of anomalies")
    sensitivity = ServiceParam("sensitivity 0-99")
    custom_interval = ServiceParam("interval for 'custom' granularity")

    _path = ""

    def _build_request(self, vals: dict) -> Optional[dict]:
        series = vals.get("series")
        if series is None:
            return None
        body: dict = {
            "series": [
                {"timestamp": str(pt["timestamp"]), "value": float(pt["value"])}
                for pt in series
            ],
            "granularity": vals.get("granularity") or "daily",
        }
        for k, wire in (
            ("max_anomaly_ratio", "maxAnomalyRatio"),
            ("sensitivity", "sensitivity"),
            ("custom_interval", "customInterval"),
        ):
            if vals.get(k) is not None:
                body[wire] = vals[k]
        return self._post_json(vals, body, path=self._path)


class DetectLastAnomaly(_AnomalyBase):
    """Is the most recent point anomalous (DetectLastAnomaly)."""

    _path = "/anomalydetector/v1.0/timeseries/last/detect"
    _response_schema = S.LastAnomalyResponse


class DetectAnomalies(_AnomalyBase):
    """Anomaly flags for the whole series (DetectAnomalies)."""

    _path = "/anomalydetector/v1.0/timeseries/entire/detect"
    _response_schema = S.AnomalyDetectResponse
