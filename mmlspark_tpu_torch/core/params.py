"""Typed parameter system for pipeline stages.

Rebuilds the capability of the reference's SparkML ``Params`` layer —
shared column-name traits (core/contracts/Params.scala:15-217), the typed
param zoo (org/apache/spark/ml/param/*.scala) and ``ComplexParam``
persistence for non-JSON payloads (core/serialize/ComplexParam.scala:13-34)
— as Python descriptors on pipeline stages.

A copy of ``mmlspark_tpu.core.params`` kept inside the PyTorch port.

Design notes:
- Params are class-level descriptors; values live per-instance, split into
  user-set vs default, mirroring SparkML semantics so ``explain_params`` and
  persistence behave the same way.
- ``ComplexParam`` values (model weights, tensors, DataFrames, callables)
  are serialized to their own subdirectory by the machinery in
  ``mmlspark_tpu_torch.core.serialize`` instead of JSON metadata.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Generic, Iterator, Optional, TypeVar

T = TypeVar("T")

_NO_DEFAULT = object()


class Param(Generic[T]):
    """A named, documented, validated parameter (descriptor).

    JSON-serializable values only; use :class:`ComplexParam` for payloads.
    """

    is_complex = False

    def __init__(
        self,
        doc: str = "",
        default: Any = _NO_DEFAULT,
        validator: Optional[Callable[[Any], bool]] = None,
        type_: Optional[type] = None,
    ):
        self.doc = doc
        self.default = default
        self.validator = validator
        self.type_ = type_
        self.name: str = ""  # filled by __set_name__

    def __set_name__(self, owner: type, name: str) -> None:
        self.name = name

    def __get__(self, obj: Any, objtype: Optional[type] = None) -> Any:
        if obj is None:
            return self
        return obj.get(self.name)

    def __set__(self, obj: Any, value: Any) -> None:
        obj.set(self.name, value)

    def has_default(self) -> bool:
        return self.default is not _NO_DEFAULT

    def validate(self, value: Any) -> Any:
        import numpy as _np

        if isinstance(value, _np.generic):  # numpy scalars from df columns
            value = value.item()
        if self.type_ is not None and value is not None:
            if self.type_ in (int, float) and isinstance(value, bool):
                raise TypeError(
                    f"param {self.name}: expected {self.type_.__name__}, got bool"
                )
            if self.type_ is float and isinstance(value, int):
                value = float(value)
            if not isinstance(value, self.type_):
                raise TypeError(
                    f"param {self.name}: expected {self.type_.__name__}, "
                    f"got {type(value).__name__}"
                )
        if self.validator is not None and value is not None:
            if not self.validator(value):
                raise ValueError(f"param {self.name}: invalid value {value!r}")
        return value


class ComplexParam(Param):
    """A param whose value is a structured payload (arrays, pytrees,
    DataFrames, fitted models, callables) persisted outside JSON metadata.

    Mirrors the role of the reference's ``ComplexParam``
    (core/serialize/ComplexParam.scala:13-34) + its typed zoo
    (TransformerParam, UDFParam, DataFrameParam, ByteArrayParam, ...).
    The concrete codec is chosen at save time by
    ``mmlspark_tpu_torch.core.serialize.write_complex_value``.
    """

    is_complex = True


class Params:
    """Base for anything with params. Subclasses declare ``Param`` class
    attributes; instances carry user-set values and defaults separately."""

    def __init__(self, **kwargs: Any):
        self._paramMap: dict[str, Any] = {}
        self.set(**kwargs)

    # -- declaration helpers -------------------------------------------------

    @classmethod
    def params(cls) -> dict[str, Param]:
        out: dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    out[k] = v
        return out

    @classmethod
    def param(cls, name: str) -> Param:
        p = cls.params().get(name)
        if p is None:
            raise KeyError(f"{cls.__name__} has no param {name!r}")
        return p

    # -- get/set -------------------------------------------------------------

    def set(self, *args: Any, **kwargs: Any) -> "Params":
        if args:
            if len(args) != 2:
                raise TypeError("set() positional form is set(name, value)")
            kwargs = {args[0]: args[1], **kwargs}
        for name, value in kwargs.items():
            p = self.param(name)
            self._paramMap[name] = p.validate(value)
        return self

    def get(self, name: str, default: Any = _NO_DEFAULT) -> Any:
        p = self.param(name)
        if name in self._paramMap:
            return self._paramMap[name]
        if p.has_default():
            # copy mutable defaults so instances don't share state
            d = p.default
            return copy.copy(d) if isinstance(d, (list, dict, set)) else d
        if default is not _NO_DEFAULT:
            return default
        return None

    def is_set(self, name: str) -> bool:
        self.param(name)
        return name in self._paramMap

    def is_defined(self, name: str) -> bool:
        return self.is_set(name) or self.param(name).has_default()

    def get_or_fail(self, name: str) -> Any:
        if not self.is_defined(name):
            raise ValueError(
                f"{type(self).__name__}: required param {name!r} is not set"
            )
        return self.get(name)

    def clear(self, name: str) -> "Params":
        self._paramMap.pop(name, None)
        return self

    def copy(self, extra: Optional[dict[str, Any]] = None) -> "Params":
        other = copy.copy(self)
        other._paramMap = dict(self._paramMap)
        if extra:
            other.set(**extra)
        return other

    def explain_params(self) -> str:
        lines = []
        for name, p in sorted(self.params().items()):
            cur = self._paramMap.get(name, "undefined" if not p.has_default() else p.default)
            lines.append(f"{name}: {p.doc} (current: {cur!r})")
        return "\n".join(lines)

    def iter_set_params(self) -> Iterator[tuple[str, Param, Any]]:
        for name, value in self._paramMap.items():
            yield name, self.param(name), value

    def __repr__(self) -> str:
        simple = {
            k: v for k, v in self._paramMap.items() if not self.param(k).is_complex
        }
        return f"{type(self).__name__}({', '.join(f'{k}={v!r}' for k, v in simple.items())})"


# --------------------------------------------------------------------------
# Shared column traits (HasInputCol / HasOutputCol / ... of
# core/contracts/Params.scala:15-217)
# --------------------------------------------------------------------------


class HasInputCol(Params):
    input_col = Param("name of the input column", type_=str)


class HasOutputCol(Params):
    output_col = Param("name of the output column", type_=str)


class HasInputCols(Params):
    input_cols = Param("names of the input columns", type_=list)


class HasOutputCols(Params):
    output_cols = Param("names of the output columns", type_=list)


class HasLabelCol(Params):
    label_col = Param("name of the label column", default="label", type_=str)


class HasFeaturesCol(Params):
    features_col = Param("name of the features column", default="features", type_=str)


class HasPredictionCol(Params):
    prediction_col = Param("name of the prediction column", default="prediction", type_=str)


class HasProbabilityCol(Params):
    probability_col = Param(
        "name of the predicted class-probability column", default="probability", type_=str
    )


class HasRawPredictionCol(Params):
    raw_prediction_col = Param(
        "name of the raw prediction (margin) column", default="raw_prediction", type_=str
    )


class HasWeightCol(Params):
    weight_col = Param("name of the instance-weight column", type_=str)


class HasValidationIndicatorCol(Params):
    validation_indicator_col = Param(
        "boolean column marking validation rows", type_=str
    )


class HasInitScoreCol(Params):
    init_score_col = Param("name of the initial-score (margin) column", type_=str)


class HasGroupCol(Params):
    group_col = Param("name of the query/group column (ranking)", type_=str)


class HasBatchSize(Params):
    batch_size = Param(
        "fixed minibatch size (static shapes keep XLA from recompiling)",
        default=64,
        type_=int,
        validator=lambda v: v > 0,
    )


class HasSeed(Params):
    seed = Param("random seed", default=0, type_=int)
