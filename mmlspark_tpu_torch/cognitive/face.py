"""Face-API transformers (cognitive/Face.scala analogue).

Wire format: Face v1.0 — detect posts an image URL; verify/identify/group/
findsimilars post face-id JSON bodies.

The PyTorch port's copy of ``mmlspark_tpu.cognitive.face``: host code
over the port's ``io``, no device.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from typing import List

from mmlspark_tpu_torch.cognitive import schemas as S
from mmlspark_tpu_torch.cognitive.base import CognitiveServiceBase, ServiceParam
from mmlspark_tpu_torch.io.http_schema import HTTPRequestData


class DetectFace(CognitiveServiceBase):
    """Face detection (/face/v1.0/detect)."""

    _response_schema = List[S.DetectedFace]

    image_url = ServiceParam("image URL (value or column)")
    return_face_id = ServiceParam("return face ids", default={"value": True})
    return_face_landmarks = ServiceParam("return landmarks", default={"value": False})
    return_face_attributes = ServiceParam("attribute list (age,gender,...)")

    def _build_request(self, vals: dict) -> Optional[dict]:
        img = vals.get("image_url")
        if img is None:
            return None
        parts = [
            f"returnFaceId={str(bool(vals.get('return_face_id'))).lower()}",
            f"returnFaceLandmarks={str(bool(vals.get('return_face_landmarks'))).lower()}",
        ]
        if vals.get("return_face_attributes"):
            parts.append(
                "returnFaceAttributes=" + ",".join(vals["return_face_attributes"])
            )
        return self._post_json(
            vals, {"url": str(img)}, path="/face/v1.0/detect", query="&".join(parts)
        )


class VerifyFaces(CognitiveServiceBase):
    """Same-person verification of two face ids (/face/v1.0/verify)."""

    _response_schema = S.VerifyResponse

    face_id1 = ServiceParam("first face id")
    face_id2 = ServiceParam("second face id")

    def _build_request(self, vals: dict) -> Optional[dict]:
        a, b = vals.get("face_id1"), vals.get("face_id2")
        if a is None or b is None:
            return None
        return self._post_json(
            vals, {"faceId1": str(a), "faceId2": str(b)}, path="/face/v1.0/verify"
        )


class IdentifyFaces(CognitiveServiceBase):
    """Identify face ids against a person group (/face/v1.0/identify)."""

    _response_schema = List[S.IdentifiedFace]

    face_ids = ServiceParam("face ids to identify")
    person_group_id = ServiceParam("person group id")
    max_num_of_candidates = ServiceParam("max candidates", default={"value": 1})
    confidence_threshold = ServiceParam("confidence threshold")

    def _build_request(self, vals: dict) -> Optional[dict]:
        ids = vals.get("face_ids")
        if ids is None:
            return None
        body = {
            "faceIds": [str(i) for i in ids],
            "personGroupId": str(vals.get("person_group_id")),
            "maxNumOfCandidatesReturned": int(vals.get("max_num_of_candidates") or 1),
        }
        if vals.get("confidence_threshold") is not None:
            body["confidenceThreshold"] = float(vals["confidence_threshold"])
        return self._post_json(vals, body, path="/face/v1.0/identify")


class GroupFaces(CognitiveServiceBase):
    """Group face ids by similarity (/face/v1.0/group)."""

    _response_schema = S.GroupResponse

    face_ids = ServiceParam("face ids to group")

    def _build_request(self, vals: dict) -> Optional[dict]:
        ids = vals.get("face_ids")
        if ids is None:
            return None
        return self._post_json(
            vals, {"faceIds": [str(i) for i in ids]}, path="/face/v1.0/group"
        )


class FindSimilarFace(CognitiveServiceBase):
    """Find similar faces to a query face id (/face/v1.0/findsimilars)."""

    _response_schema = List[S.SimilarFace]

    face_id = ServiceParam("query face id")
    face_ids = ServiceParam("candidate face ids")
    face_list_id = ServiceParam("or: a stored face list id")
    max_num_of_candidates = ServiceParam("max results", default={"value": 20})

    def _build_request(self, vals: dict) -> Optional[dict]:
        fid = vals.get("face_id")
        if fid is None:
            return None
        body: dict = {
            "faceId": str(fid),
            "maxNumOfCandidatesReturned": int(vals.get("max_num_of_candidates") or 20),
        }
        if vals.get("face_list_id") is not None:
            body["faceListId"] = str(vals["face_list_id"])
        elif vals.get("face_ids") is not None:
            body["faceIds"] = [str(i) for i in vals["face_ids"]]
        return self._post_json(vals, body, path="/face/v1.0/findsimilars")
