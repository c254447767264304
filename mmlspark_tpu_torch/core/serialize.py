"""Persistence machinery for stages, params and DataFrames.

Rebuilds the reference's ``ComplexParamsWritable``/``Serializer`` capability
(core/serialize/ComplexParam.scala:13-34, org/apache/spark/ml/Serializer.scala:53-60):
every stage — including ones holding native payloads (model weights/pytrees,
inner DataFrames, fitted sub-stages, callables) — must round-trip
``save(path)`` / ``load(path)``, including when nested inside a Pipeline.
SerializationFuzzing (tests/fuzzing.py) is the forcing function, as in the
reference. This is the PyTorch port's copy of ``mmlspark_tpu.core.serialize``:
the JAX-array and flax-msgpack codecs become a ``torch.Tensor`` codec and a
pickled pytree.

On-disk layout of a saved stage::

    path/
      metadata.json          # {class, version, params: {...simple json...}}
      complex/<param>/       # one dir per set ComplexParam
        kind.txt             # codec name
        value.*              # codec-specific payload

Codec dispatch (the ``Serializer.typeToSerializer`` analogue):
ndarray -> .npy | torch.Tensor -> .pt (saved from the CPU) | pytree of
arrays/tensors -> pickle of numpy leaves |
DataFrame -> partition npz + pickled object columns | stage / list of
stages -> nested dirs | bytes -> raw | everything else (UDFs, lambdas) ->
cloudpickle (so inline lambdas persist, the UDFParam analogue).
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame

FORMAT_VERSION = 1


def _full_class_name(obj: Any) -> str:
    cls = type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


def _import_class(name: str) -> type:
    module, _, cls = name.rpartition(".")
    return getattr(importlib.import_module(module), cls)


def _is_pytree_of_arrays(v: Any) -> bool:
    if isinstance(v, dict):
        # only str-keyed dicts count as pytrees (the JAX package's rule);
        # other key types take the generic pickle path
        return all(
            isinstance(k, str) and _is_pytree_of_arrays(x) for k, x in v.items()
        )
    if isinstance(v, (list, tuple)):
        return all(_is_pytree_of_arrays(x) for x in v)
    return isinstance(v, (np.ndarray, float, int, torch.Tensor))


# -- DataFrame codec --------------------------------------------------------


def write_dataframe(df: DataFrame, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    meta = {"num_partitions": df.num_partitions, "metadata": {}}
    for name, md in ((n, df.column_metadata(n)) for n in df.columns):
        if md:
            meta["metadata"][name] = _jsonable(md)
    for i, p in enumerate(df.partitions):
        dense = {k: v for k, v in p.items() if v.dtype != object}
        objs = {k: list(v) for k, v in p.items() if v.dtype == object}
        np.savez(os.path.join(path, f"part_{i}.npz"), **dense)
        if objs:
            with open(os.path.join(path, f"part_{i}.objs.pkl"), "wb") as f:
                pickle.dump(objs, f)
        meta.setdefault("columns", list(p.keys()))
    with open(os.path.join(path, "dataframe.json"), "w") as f:
        json.dump(meta, f)


def read_dataframe(path: str) -> DataFrame:
    with open(os.path.join(path, "dataframe.json")) as f:
        meta = json.load(f)
    parts = []
    for i in range(meta["num_partitions"]):
        with np.load(os.path.join(path, f"part_{i}.npz"), allow_pickle=False) as z:
            p = {k: z[k] for k in z.files}
        objp = os.path.join(path, f"part_{i}.objs.pkl")
        if os.path.exists(objp):
            with open(objp, "rb") as f:
                for k, v in pickle.load(f).items():
                    arr = np.empty(len(v), dtype=object)
                    for j, x in enumerate(v):
                        arr[j] = x
                    p[k] = arr
        cols = meta.get("columns")
        if cols:
            p = {k: p[k] for k in cols if k in p}
        parts.append(p)
    return DataFrame(parts, metadata=meta.get("metadata") or None)


# -- complex value dispatch -------------------------------------------------


def write_complex_value(value: Any, path: str) -> None:
    from mmlspark_tpu_torch.core.pipeline import PipelineStage  # cycle-free at call time

    os.makedirs(path, exist_ok=True)

    def mark(kind: str) -> None:
        with open(os.path.join(path, "kind.txt"), "w") as f:
            f.write(kind)

    if isinstance(value, PipelineStage):
        mark("stage")
        save_stage(value, os.path.join(path, "value.stage"))
    elif (
        isinstance(value, (list, tuple))
        and value
        and all(isinstance(s, PipelineStage) for s in value)
    ):
        mark("stage_list")
        sl = os.path.join(path, "value.stages")
        os.makedirs(sl, exist_ok=True)
        with open(os.path.join(sl, "n.json"), "w") as f:
            json.dump(len(value), f)
        for i, s in enumerate(value):
            save_stage(s, os.path.join(sl, f"stage_{i}"))
    elif isinstance(value, DataFrame):
        mark("dataframe")
        write_dataframe(value, os.path.join(path, "value.df"))
    elif isinstance(value, bytes):
        mark("bytes")
        with open(os.path.join(path, "value.bin"), "wb") as f:
            f.write(value)
    elif isinstance(value, np.ndarray) and value.dtype != object:
        mark("ndarray")
        np.save(os.path.join(path, "value.npy"), value)
    elif isinstance(value, torch.Tensor):
        mark("tensor")
        torch.save(value.detach().cpu(), os.path.join(path, "value.pt"))
    elif isinstance(value, (dict, list, tuple)) and _is_pytree_of_arrays(value):
        mark("pytree")
        with open(os.path.join(path, "value.pkl"), "wb") as f:
            pickle.dump(_np_tree(value), f)
    else:
        mark("pickle")
        with open(os.path.join(path, "value.pkl"), "wb") as f:
            _pickler().dump(value, f)


def _pickler() -> Any:
    """cloudpickle where installed (inline lambdas persist), else the
    standard pickle (module-level callables only)."""
    try:
        import cloudpickle
    except ImportError:
        return pickle
    return cloudpickle


def _np_tree(v: Any) -> Any:
    if isinstance(v, dict):
        # numpy scalar keys become python scalars, as in the JAX package
        return {
            (k.item() if isinstance(k, np.generic) else k): _np_tree(x)
            for k, x in v.items()
        }
    if isinstance(v, (list, tuple)):
        return [_np_tree(x) for x in v]
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def read_complex_value(path: str) -> Any:
    with open(os.path.join(path, "kind.txt")) as f:
        kind = f.read().strip()
    if kind == "stage":
        return load_stage(os.path.join(path, "value.stage"))
    if kind == "stage_list":
        sl = os.path.join(path, "value.stages")
        with open(os.path.join(sl, "n.json")) as f:
            n = json.load(f)
        return [load_stage(os.path.join(sl, f"stage_{i}")) for i in range(n)]
    if kind == "dataframe":
        return read_dataframe(os.path.join(path, "value.df"))
    if kind == "bytes":
        with open(os.path.join(path, "value.bin"), "rb") as f:
            return f.read()
    if kind == "ndarray":
        return np.load(os.path.join(path, "value.npy"))
    if kind == "tensor":
        return torch.load(os.path.join(path, "value.pt"), weights_only=True)
    if kind == "pytree":
        with open(os.path.join(path, "value.pkl"), "rb") as f:
            return pickle.load(f)
    if kind == "pickle":
        with open(os.path.join(path, "value.pkl"), "rb") as f:
            return pickle.load(f)
    raise ValueError(f"unknown complex param kind {kind!r} at {path}")


# -- stage save/load --------------------------------------------------------


def save_stage(stage: Any, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    simple, complexes = {}, {}
    for name, p, value in stage.iter_set_params():
        if p.is_complex:
            complexes[name] = value
        else:
            simple[name] = _jsonable(value)
    meta = {
        "class": _full_class_name(stage),
        "format_version": FORMAT_VERSION,
        "params": simple,
        "complex_params": sorted(complexes.keys()),
    }
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1)
    for name, value in complexes.items():
        write_complex_value(value, os.path.join(path, "complex", name))
    # allow stages to persist extra payloads (e.g. PipelineModel stages)
    extra = getattr(stage, "_save_extra", None)
    if extra is not None:
        extra(path)


def _jsonable(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return v


def load_stage(path: str) -> Any:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cls = _import_class(meta["class"])
    stage = cls()  # stages are constructible with no args (SparkML convention)
    stage.set(**meta["params"])
    for name in meta.get("complex_params", []):
        stage.set(name, read_complex_value(os.path.join(path, "complex", name)))
    extra = getattr(stage, "_load_extra", None)
    if extra is not None:
        extra(path)
    return stage
