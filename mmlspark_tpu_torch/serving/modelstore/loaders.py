"""Spec -> :class:`LoadedModel` resolution for the ModelStore.

The PyTorch port of ``mmlspark_tpu.serving.modelstore.loaders``. It
understands the same model specs (``echo`` / ``zoo:<name>`` /
``pipeline:<dir>`` / ``vw:<snapshot.npz>`` / ``gbdt:<model.json>`` /
``module:pkg.fn``) and adds what the store needs beyond a bare handler:
the device bytes the model will hold, a warm-up, a measure of what it
holds after it, and a release hook for eviction.

Every loader follows one rule. It reads its model on the host, records the
store's device (resolved to an explicit index: handlers run on the
dispatcher's threads, whose current CUDA device is not the loading
thread's) and reports ``nbytes``, the bytes the model will place there, so
the budget is checked before anything is allocated. Its ``warmup`` places
the model on that device, every tensor explicitly, and runs one bucket
through the real handler before the version turns ``ready``; ``measure``
then counts what the version really holds on the device
(:func:`tensor_nbytes`: weights as placed, cached device copies, and for a
compiled pipeline its CUDA graphs' memory pool), and ``release`` drops it.

Errors: only a request the handler cannot read gets a 400 (bad JSON, a
missing field, a shape, index or value out of range: ``INPUT_ERRORS``
raised while decoding and validating it, before the model is called). An
error of the model call itself, whatever its type — a stage's ValueError, a
failed kernel launch, a CUDA error, memory — propagates to the dispatcher,
which answers the batch 500 and counts it; it is never turned into a 400,
so a broken model or card cannot keep serving quietly.

A ``module:`` factory may return either a plain handler or a
:class:`LoadedModel` directly — the latter is how custom models report
their true byte footprint and warmup shape.
"""

from __future__ import annotations

import functools
import json
import os
import re
import threading
import types
from collections import deque
from concurrent.futures import Executor
from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.serving.modelstore.store import LoadedModel
from mmlspark_tpu_torch.serving.query import INPUT_ERRORS, SplitHandler
from mmlspark_tpu_torch.serving.server import CachedRequest

_ARTIFACTS_TODO = (
    "artifact: specs need serving/artifacts.py, which the port does not have "
    "yet (ROADMAP.md, Queue A item 7, step 2)"
)


def model_name_from_spec(spec: str) -> str:
    """The model name a spec serves under (per-model routing): ``echo`` ->
    ``echo``, ``zoo:ResNet8`` -> ``ResNet8``, ``module:pkg.make`` ->
    ``make``, ``pipeline:/m/churn`` -> ``churn``,
    ``vw:/s/vw-online-v000007.npz`` -> ``vw-online`` (exactly the
    Publisher's ``-v%06d`` suffix strips so every snapshot of one online
    model registers under one stable name; a hand-named
    ``vw:/s/fraud-v2.npz`` keeps its full ``fraud-v2`` name)."""
    if spec.startswith("zoo:"):
        return spec[len("zoo:"):]
    if spec.startswith("module:"):
        return spec.rsplit(".", 1)[-1]
    if spec.startswith("pipeline:"):
        return os.path.basename(spec[len("pipeline:"):].rstrip("/")) or "pipeline"
    if spec.startswith("vw:"):
        stem = os.path.basename(spec[len("vw:"):])
        stem = stem[: -len(".npz")] if stem.endswith(".npz") else stem
        # exactly the Publisher's -v%06d suffix: a looser \d+ would
        # mangle user-named snapshots like fraud-v2.npz -> "fraud"
        return re.sub(r"-v\d{6}$", "", stem) or "vw"
    if spec.startswith("gbdt:"):
        stem = os.path.basename(spec[len("gbdt:"):])
        for ext in (".gbdt.json", ".json"):
            if stem.endswith(ext):
                stem = stem[: -len(ext)]
                break
        # the experiment controller's -r<rung> suffix: every rung model
        # of one trial serves under the trial's stable name
        return re.sub(r"-r\d+$", "", stem) or "gbdt"
    if spec.startswith("artifact:"):
        raise NotImplementedError(_ARTIFACTS_TODO)
    return spec


def _dummy_request(body: bytes) -> CachedRequest:
    return CachedRequest(
        id="__warmup__", epoch=0, method="POST", path="/", headers={},
        body=body,
    )


def _bad(e: Exception) -> tuple:
    return (400, json.dumps({"error": str(e)[:300]}).encode(), {})


def _placement(device: Any) -> torch.device:
    """The store's device with an explicit index: the handler threads'
    current CUDA device is not consulted."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# objects whose insides hold no model tensors: the walk stops at them
_LEAVES = (str, bytes, bytearray, int, float, complex, bool, type(None), np.ndarray,
           np.generic, type, types.ModuleType, torch.dtype, torch.device,
           threading.Thread, Executor)


def tensor_nbytes(obj: Any, device: Any = None) -> int:
    """Bytes of the distinct tensor storages reachable from ``obj`` (on
    ``device`` when given): through containers, object attributes and
    slots, bound methods, partials and closures — a model's parameters and
    buffers, and the device copies its code caches. A storage shared by
    several views counts once."""
    dev = None if device is None else torch.device(device)
    seen: set = set()
    storages: set = set()
    total = 0
    stack = [obj]
    while stack:
        o = stack.pop()
        if isinstance(o, _LEAVES) or id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            if dev is None or o.device == dev:
                st = o.untyped_storage()
                key = (str(o.device), st.data_ptr())
                if key not in storages:
                    storages.add(key)
                    total += st.nbytes()
            continue
        if isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset, deque)):
            stack.extend(o)
        elif isinstance(o, types.FunctionType):
            for cell in o.__closure__ or ():
                try:
                    stack.append(cell.cell_contents)
                except ValueError:  # an empty cell
                    pass
        elif isinstance(o, types.MethodType):
            stack += [o.__self__, o.__func__]
        elif isinstance(o, functools.partial):
            stack += [o.func, o.args, o.keywords]
        else:
            d = getattr(o, "__dict__", None)
            if isinstance(d, dict):
                stack.extend(d.values())
            for cls in type(o).__mro__:
                slots = getattr(cls, "__slots__", ())
                for slot in (slots,) if isinstance(slots, str) else slots:
                    if hasattr(o, slot):
                        stack.append(getattr(o, slot))
    return total


def graph_pool_bytes(pools: list, device: torch.device) -> int:
    """Bytes the CUDA caching allocator has reserved for the given graph
    memory pools on ``device`` (0 off the card): what a compiled
    pipeline's captured graphs hold beyond their live tensors."""
    if device.type != "cuda" or not pools:
        return 0
    ids = {tuple(p) for p in pools}
    return int(sum(
        seg["total_size"] for seg in torch.cuda.memory_snapshot()
        if seg.get("device") == device.index
        and tuple(seg.get("segment_pool_id", ())) in ids
    ))


def _echo_loaded() -> LoadedModel:
    def handler(reqs: list) -> dict:
        out = {}
        for r in reqs:
            try:
                body = json.loads(r.body) if r.body else {}
                out[r.id] = (200, json.dumps({"echo": body}).encode(), {})
            except ValueError as e:
                out[r.id] = (400, json.dumps({"error": str(e)}).encode(), {})
        return out

    def warmup() -> None:
        handler([_dummy_request(b'{"x": 0}')])

    return LoadedModel(handler=handler, nbytes=0, warmup=warmup,
                       meta={"spec": "echo"})


def _zoo_loaded(name: str, dev: torch.device, zoo_dir: Optional[str]) -> LoadedModel:
    """``zoo:<name>`` — ImageFeaturizer on the named zoo backbone (pooled
    features, ``cut_output_layers`` 1). Wire contract: POST body
    ``{"image": [[[r, g, b], ...], ...]}``, an (H, W, C) array of ints
    0..255; the reply is ``{"features": [...]}``. Requests of one batch run
    as one ``TorchModel.apply_batch`` per image shape, which pads the batch
    to the featurizer's ``batch_size``, as the JAX package's does.

    A split handler: ``prepare`` decodes the JSON pixels on the batcher
    thread while ``execute`` runs the previous batch on the device."""
    from mmlspark_tpu_torch.models import ImageFeaturizer

    feat = ImageFeaturizer(
        input_col="image", output_col="features", model_name=name,
        device="cpu", **({"repo_dir": zoo_dir} if zoo_dir else {}),
    )
    inner = feat._build()  # the backbone on the host
    inner.set(device=str(dev))
    size = feat.get("image_size") or (
        feat._schema.image_size if feat._schema is not None else 224
    )
    nbytes = tensor_nbytes(inner.get("module"))

    def prepare(reqs: list) -> tuple:
        out: dict = {}
        groups: dict = {}
        for r in reqs:
            try:
                img = np.asarray(json.loads(r.body)["image"], np.uint8)
                if img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape:
                    raise ValueError(f"image must be (H, W, 3), got shape {img.shape}")
            except (*INPUT_ERRORS, OverflowError) as e:
                out[r.id] = _bad(e)
                continue
            groups.setdefault(img.shape, []).append((r.id, img))
        return out, list(groups.values())

    def execute(staged: tuple) -> dict:
        out, groups = staged
        for items in groups:
            feats = inner.apply_batch(np.stack([img for _, img in items]))
            for (rid, _), f in zip(items, feats):
                out[rid] = (200, json.dumps({"features": f.tolist()}).encode(), {})
        return out

    def warmup() -> None:
        # places the backbone (TorchModel._runner) and runs the 1-row
        # bucket, padded to batch_size, before the version turns ready
        inner.apply_batch(np.zeros((1, size, size, 3), np.uint8))

    def release() -> None:
        # drop the backbone's device copy; the reload path is the spec itself
        inner._placed = None
        inner._placed_key = None

    return LoadedModel(
        handler=SplitHandler(prepare, execute), nbytes=nbytes, warmup=warmup,
        release=release, measure=lambda: tensor_nbytes(inner._placed, dev),
        meta={"spec": f"zoo:{name}", "image_size": size, "device": str(dev),
              "batch_size": inner.get("batch_size")},
    )


def _host_nbytes(obj: Any) -> int:
    """Bytes of the numpy arrays and tensors in a stage's params: a
    pipeline's estimate before it is placed."""
    if isinstance(obj, dict):
        return sum(_host_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_host_nbytes(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, np.ndarray) and obj.dtype != object:
        return int(obj.nbytes)
    return 0


def _pipeline_loaded(path: str, dev: torch.device) -> LoadedModel:
    """``pipeline:<saved-model-dir>`` — serve a compiled pipeline.

    Load: ``core.serialize.load_stage`` on the dir (a saved
    ``PipelineModel``, ``CompiledPipeline`` or any fitted Transformer);
    every stage with a ``device`` param is set to the store's device.
    Compile: PipelineModels go through ``.compile(device=...)``; other
    transformers are wrapped in a one-stage CompiledPipeline so the
    fusable case still fuses. Warmup: plan+fuse+partition always; if the
    dir carries a ``warmup.json`` ({column: [values...]}) its first 1, 2,
    4, ... rows and then all of them run through the compiled transform,
    so every bucket up to its row count has its CUDA graph captured (and
    the weights placed) before the version turns ready. ``measure``: the
    tensors the compiled pipeline holds on the device (placed weights, the
    graphs' static buffers) plus its graphs' memory pools; ``release``
    drops the graphs and their pools.

    Wire contract (docs/modelstore.md): POST body is one JSON row
    ({column: value}), {"rows": [{column: value}, ...]}, or the columnar
    fast path {"cols": {column: [value, ...]}} — column-major arrays
    decoded ONCE per batch instead of dict-per-row; the reply carries only
    the pipeline's *output* columns per row. An optional ``"select":
    [column, ...]`` narrows the reply further.

    The handler implements the serving/query.py SplitHandler protocol:
    ``prepare`` (JSON decode, validation, column stacking across the
    whole dispatcher batch) runs on the batcher thread while ``execute``
    (ONE fused transform at the bucket shape, split back per request)
    still runs the previous batch. Validation is all in ``prepare``: a
    request that lacks a column the plan reads, or whose numeric column's
    rows have another shape than ``warmup.json``'s, is answered 400
    there; anything the fused transform raises is the batch's 500.
    """
    from mmlspark_tpu_torch.compiler import CompiledPipeline
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.core.pipeline import PipelineModel, load_stage

    stage = load_stage(path)
    stages = (stage.get("stages") if isinstance(stage, (CompiledPipeline, PipelineModel))
              else [stage])
    for s in stages:
        if "device" in type(s).params():
            s.set(device=str(dev))
    if isinstance(stage, CompiledPipeline):
        compiled = stage.set(device=str(dev))
    elif isinstance(stage, PipelineModel):
        compiled = stage.compile(device=str(dev))
    else:
        compiled = CompiledPipeline(stages=[stage], device=str(dev))
    compiled.build()
    nbytes = _host_nbytes([
        {name: s.get(name) for name in type(s).params()}
        for s in compiled.get("stages")
    ])
    out_cols = tuple(dict.fromkeys(
        c for n in compiled.plan.nodes for c in n.writes
    ))
    # an opaque stage (RenameColumn, Explode, Lambda) may produce columns
    # the plan cannot name — declared writes would silently drop them
    has_opaque = any(n.opaque for n in compiled.plan.nodes)
    # the columns a request must carry: what the plan reads before a
    # stage writes it, up to the first opaque stage (its I/O is unknown)
    required: list = []
    produced: set = set()
    for node in compiled.plan.nodes:
        if node.opaque:
            break
        required.extend(c for c in node.reads if c not in produced)
        produced.update(node.writes)
    required = list(dict.fromkeys(required))
    state = {"compiled": compiled}

    def _dense(values: list) -> Any:
        """Stack uniform numeric-list columns to dense float64 arrays.
        JSON rows arrive as python lists, which ``_as_column`` keeps as an
        object column — and the fused segments' guards rightly refuse
        object dtype, so without this every serving request (and the
        warmup) would fall back to staged execution. float64 is JSON's
        own number precision; the staged and fused paths round it to f32
        identically. Ragged/non-numeric columns pass through untouched."""
        if values and all(isinstance(v, (list, tuple)) for v in values):
            try:
                return np.stack([np.asarray(v, dtype=np.float64) for v in values])
            except INPUT_ERRORS:  # ragged/non-numeric: object path
                pass
        return values

    def _dense_col(values: Any) -> Any:
        """Decode one column-major JSON column in ONE numpy call: numeric
        scalar columns become f64 vectors, uniform list cells a stacked
        f64 matrix (same precision contract as ``_dense``); anything
        else stays a python list (object column)."""
        if not isinstance(values, list) or not values:
            raise ValueError("each cols entry must be a non-empty list")
        try:
            arr = np.asarray(values, dtype=np.float64)
        except (TypeError, ValueError):
            return values
        if arr.ndim >= 1 and arr.shape[0] == len(values):
            return arr
        return values

    def _row_shape(values: Any) -> Any:
        """The per-row shape of a numeric column, None if it is ragged or
        not numeric."""
        if isinstance(values, np.ndarray) and values.dtype != object:
            return values.shape[1:]
        try:
            arr = np.asarray(values, dtype=np.float64)
        except (TypeError, ValueError):
            return None
        return arr.shape[1:] if arr.ndim >= 1 and arr.shape[0] == len(values) else None

    def _score_cols(cols: dict, n_rows: int,
                    select: Any = None) -> list:
        """ONE fused transform over pre-stacked columns, split back into
        row dicts. Every wire form funnels here, so the fused program
        always runs at a dispatcher-batch bucket shape. ``select``
        narrows the reply columns BEFORE the per-row dict/JSON build —
        the encode cost is proportional to what the client asked for."""
        df = DataFrame.from_dict(cols)
        res = state["compiled"].transform(df)
        if has_opaque or not out_cols:
            keep = [c for c in res.columns if c not in cols]
        else:
            keep = [c for c in out_cols if c in res.columns]
        if select is not None:
            keep = [c for c in keep if c in select]
        mats = {c: res[c] for c in keep}
        n = res.count()
        if n != n_rows:
            # a row-dropping stage (drop_na) broke the 1:1 reply
            # correspondence: the model's fault, a 500 beats silently
            # mis-attributed scores
            raise RuntimeError(
                f"pipeline dropped {n_rows - n} of {n_rows} rows; "
                "per-row replies would misalign"
            )
        return [
            {
                c: (v[i].tolist() if hasattr(v[i], "tolist") else v[i])
                for c, v in mats.items()
            }
            for i in range(n)
        ]

    def _rows_to_cols(rows: list) -> dict:
        # union of keys: first-row keys would silently drop a column only
        # later rows carry; a row missing a key raises, a 400
        names = list(dict.fromkeys(k for r in rows for k in r.keys()))
        return {k: _dense([r[k] for r in rows]) for k in names}

    def _select_of(body: Any) -> Any:
        if not isinstance(body, dict) or "select" not in body:
            return None
        sel = body["select"]
        if not isinstance(sel, list) or not all(
            isinstance(c, str) for c in sel
        ):
            raise ValueError("select must be a list of column names")
        return frozenset(sel)

    def _parse_one(r: Any) -> tuple:
        """-> (body, cols, n_rows, select). ``cols``: column name ->
        stacked array or python list, decoded once — the array fast path
        decodes the columnar body straight to f64 arrays with zero row
        dicts."""
        body = json.loads(r.body) if r.body else {}
        sel = _select_of(body)
        if isinstance(body, dict) and "cols" in body:
            raw = body["cols"]
            if not isinstance(raw, dict) or not raw:
                raise ValueError("cols must be a non-empty object")
            cols = {k: _dense_col(v) for k, v in raw.items()}
            lens = {len(v) for v in cols.values()}
            if len(lens) != 1:
                raise ValueError(f"ragged cols lengths {sorted(lens)}")
            n = lens.pop()
        else:
            rows = (
                body["rows"]
                if isinstance(body, dict) and "rows" in body else [body]
            )
            if (
                not isinstance(rows, list)
                or not rows
                or not all(isinstance(x, dict) for x in rows)
            ):
                raise ValueError("rows must be a non-empty list of objects")
            cols, n = _rows_to_cols(rows), len(rows)
        _validate(cols)
        return body, cols, n, sel

    def _validate(cols: dict) -> None:
        """What the model will read is there, in the shape it was warmed
        for: a request that fails this is the client's 400."""
        missing = [c for c in required if c not in cols]
        if missing:
            raise KeyError(f"missing column(s) {missing}")
        for c, want in row_shapes.items():
            if c in cols and (got := _row_shape(cols[c])) != want:
                raise ValueError(
                    f"column {c!r} rows are {got or 'ragged or non-numeric'}, "
                    f"the model takes {want}"
                )

    def _signature(cols: dict) -> tuple:
        """Requests of one signature stack into one batch column set."""
        return tuple(
            (k, v.shape[1:], v.dtype.kind) if isinstance(v, np.ndarray) else (k,)
            for k, v in sorted(cols.items())
        )

    def _merge(parsed: list) -> dict:
        """Stack the columns of requests of one signature into one batch
        column set."""
        merged: dict = {}
        for k in parsed[0][2]:
            parts = [cols[k] for _, _, cols, _, _ in parsed]
            if all(isinstance(p, np.ndarray) for p in parts):
                merged[k] = np.concatenate(parts, axis=0)
            else:
                flat: list = []
                for p in parts:
                    flat.extend(p.tolist() if isinstance(p, np.ndarray) else p)
                merged[k] = flat
        return merged

    def _reply(body: Any, scored: list, sel: Any = None) -> tuple:
        if sel is not None:
            scored = [
                {k: v for k, v in row.items() if k in sel}
                for row in scored
            ]
        payload = (
            {"rows": scored}
            if isinstance(body, dict) and ("rows" in body or "cols" in body)
            else scored[0]
        )
        return (200, json.dumps(payload).encode(), {})

    def prepare(reqs: list) -> tuple:
        """Host half (overlaps the previous batch's fused transform):
        parse and validate every request, decode columns once, stack the
        dispatcher batch into one column set per signature (one, unless
        clients send different column sets or kinds)."""
        out: dict = {}
        groups: dict = {}  # signature -> [(request, body, cols, n_rows, select)]
        for r in reqs:
            try:
                body, cols, n, sel = _parse_one(r)
            except INPUT_ERRORS as e:  # a bad request 400s alone
                out[r.id] = _bad(e)
                continue
            groups.setdefault(_signature(cols), []).append((r, body, cols, n, sel))
        return out, [(parsed, _merge(parsed)) for parsed in groups.values()]

    def execute(staged: tuple) -> dict:
        """One fused transform per column set, split back by row spans.
        Nothing is caught: an error here is the model's, the batch's 500."""
        out, groups = staged
        for parsed, merged in groups:
            # batch-level select: only when EVERY request narrowed its
            # reply can the expensive row-dict build skip the unselected
            # columns; mixed batches build the union and filter per request
            sels = [sel for *_, sel in parsed]
            batch_sel = (
                frozenset().union(*sels) if all(s is not None for s in sels)
                else None
            )
            scored = _score_cols(merged, sum(n for _, _, _, n, _ in parsed), batch_sel)
            pos = 0
            for r, body, _cols, n, sel in parsed:
                out[r.id] = _reply(body, scored[pos:pos + n], sel)
                pos += n
        return out

    warmup_path = os.path.join(path, "warmup.json")
    warm_cols: dict = {}
    if os.path.exists(warmup_path):
        with open(warmup_path) as f:
            warm_cols = {k: _dense(v) for k, v in json.load(f).items()}
    # the per-row shape of each numeric column the model was warmed with
    row_shapes = {k: sh for k, v in warm_cols.items() if (sh := _row_shape(v)) is not None}

    def warmup() -> None:
        comp = state["compiled"]
        comp.build()
        cols = warm_cols
        if not cols:
            return
        n = len(next(iter(cols.values())))
        sizes = sorted({min(1 << i, n) for i in range(max(n, 1).bit_length() + 1)} - {0})
        for k in sizes:
            comp.transform(DataFrame.from_dict({c: v[:k] for c, v in cols.items()}))

    def pools() -> list:
        return [s._pool for s in state["compiled"].fused_segments if s._pool is not None]

    def measure() -> int:
        return tensor_nbytes(state["compiled"], dev) + graph_pool_bytes(pools(), dev)

    def release() -> None:
        # drop the segments' graphs and their pools, then the pipeline;
        # the reload path is the spec itself
        comp = state.pop("compiled", None)
        if comp is not None:
            for seg in comp.fused_segments:
                seg.release()

    return LoadedModel(
        handler=SplitHandler(prepare, execute), nbytes=nbytes, warmup=warmup,
        release=release, measure=measure,
        meta={
            "spec": f"pipeline:{path}",
            "stages": [type(s).__name__ for s in compiled.get("stages")],
            "fused_stages": compiled.num_fused_stages,
            "output_columns": list(out_cols),
            "device": str(dev),
        },
    )


def _vw_loaded(path: str, dev: torch.device) -> LoadedModel:
    """``vw:<snapshot.npz>`` — serve a VW linear model from device memory.

    The npz carries ``weights`` (2^num_bits f32) and ``meta`` (JSON:
    num_bits, loss, no_constant, quantile_tau). Wire contract
    (docs/online-learning.md): POST body is one sparse row
    ``{"i": [...], "v": [...]}`` or ``{"rows": [...]}`` of them; the
    reply carries ``margin`` plus ``prediction`` (and ``probability``
    for logistic). ``w`` is placed on the device once (warmup) and every
    call scores against that tensor through ``ops.sgd.margins``: the
    ``vw_margin`` kernel on the card, its plain version on the CPU.
    Batches pad to 8-row/8-nnz buckets, as the JAX package's do (each
    row's margin is its own serial chain, so padding changes no bit)."""
    from mmlspark_tpu_torch.vw.estimators import _append_constant
    from mmlspark_tpu_torch.vw.learner import (
        LOSS_HINGE,
        LOSS_LOGISTIC,
        LOSS_POISSON,
        predict_margin,
    )
    from mmlspark_tpu_torch.vw.sparse import pad_sparse_batch

    with np.load(path, allow_pickle=False) as z:
        weights = np.asarray(z["weights"], np.float32)
        meta = json.loads(bytes(z["meta"]))
    num_bits = int(meta["num_bits"])
    loss = meta.get("loss", "logistic")
    no_constant = bool(meta.get("no_constant", False))
    if weights.shape != (1 << num_bits,):
        raise ValueError(
            f"vw snapshot {path}: weights shape {weights.shape} != "
            f"({1 << num_bits},)"
        )
    state: dict = {"host": weights, "w": None}

    def _rows(body: Any) -> list:
        """The request's sparse rows as padded (idx, val), validated: every
        index must address the weight vector (the kernel does not check)."""
        rows = (
            body["rows"]
            if isinstance(body, dict) and "rows" in body else [body]
        )
        if not rows or not all(
            isinstance(x, dict) and "i" in x and "v" in x for x in rows
        ):
            raise ValueError(
                'rows must be sparse objects {"i": [...], "v": [...]}'
            )
        for x in rows:
            if len(x["i"]) != len(x["v"]):
                raise ValueError("each row needs as many values as indices")
        idx, val = pad_sparse_batch([{"i": x["i"], "v": x["v"]} for x in rows])
        if idx.size and (idx.min() < 0 or idx.max() >= 1 << num_bits):
            raise ValueError(f"feature index out of range [0, {1 << num_bits})")
        return idx, val

    def _score(idx: np.ndarray, val: np.ndarray) -> list:
        n = len(idx)
        if not no_constant:
            idx, val = _append_constant(idx, val, num_bits)
        pad = -n % 8  # 8-row bucket: bounded shape set
        if pad:
            idx = np.pad(idx, ((0, pad), (0, 0)))
            val = np.pad(val, ((0, pad), (0, 0)))
        margins = predict_margin(idx, val, state["w"], device=dev)[:n].astype(np.float64)
        out = []
        for m in margins:
            row = {"margin": float(m)}
            if loss in (LOSS_LOGISTIC, LOSS_HINGE):
                row["prediction"] = float(m > 0)
                if loss == LOSS_LOGISTIC:
                    row["probability"] = float(1.0 / (1.0 + np.exp(-m)))
            elif loss == LOSS_POISSON:
                row["prediction"] = float(np.exp(np.clip(m, -30.0, 30.0)))
            else:
                row["prediction"] = float(m)
            out.append(row)
        return out

    def handler(reqs: list) -> dict:
        out = {}
        for r in reqs:
            try:
                body = json.loads(r.body) if r.body else {}
                idx, val = _rows(body)
            except INPUT_ERRORS as e:  # a bad row 400s alone
                out[r.id] = _bad(e)
                continue
            scored = _score(idx, val)
            payload = (
                {"rows": scored}
                if isinstance(body, dict) and "rows" in body
                else scored[0]
            )
            out[r.id] = (200, json.dumps(payload).encode(), {})
        return out

    def warmup() -> None:
        state["w"] = torch.from_numpy(state["host"]).to(dev)
        _score(*_rows({"i": [0], "v": [0.0]}))

    def release() -> None:
        state["w"] = None

    return LoadedModel(
        handler=handler, nbytes=int(weights.nbytes), warmup=warmup,
        release=release, measure=lambda: tensor_nbytes(state["w"], dev),
        meta={"spec": f"vw:{path}", **meta, "device": str(dev)},
    )


def _gbdt_loaded(path: str, dev: torch.device) -> LoadedModel:
    """``gbdt:<model.json>`` — serve a trained GBDT booster from its
    portable model string (``Booster.to_model_string``, or LightGBM's
    text). Wire contract: POST body is one dense row ``{"features":
    [...]}`` or ``{"rows": [[...], ...]}``; each reply row carries the
    raw ``margin`` plus ``prediction`` (and, for the binary objective,
    ``probability``). The trees replay on the device
    (``treegrow.predict_leaves`` and the pairwise tree sum, bitwise the
    JAX package's host ``predict``); warmup stacks them there."""
    from mmlspark_tpu_torch.models.gbdt.booster import Booster, _stack_trees

    with open(path) as f:
        text = f.read()
    booster = Booster.from_model_string(text)
    objective = booster.objective
    n_features = int(booster.num_features or 0)
    trees = booster._trees(None)
    nbytes = sum(a.nbytes for a in _stack_trees(trees) if a is not None) if trees else 0
    state = {"b": booster}

    def _rows(body: Any) -> np.ndarray:
        if isinstance(body, dict) and "rows" in body:
            x = np.asarray(body["rows"], dtype=np.float32)
        elif isinstance(body, dict) and "features" in body:
            x = np.asarray([body["features"]], dtype=np.float32)
        else:
            raise ValueError(
                'body must be {"features": [...]} or {"rows": [[...], ...]}'
            )
        if x.ndim != 2 or x.shape[0] == 0:
            raise ValueError("rows must be dense feature vectors")
        if x.shape[1] < n_features:
            raise ValueError(f"rows have {x.shape[1]} features, the model reads {n_features}")
        return x

    def _score(x: np.ndarray) -> list:
        margins = np.asarray(state["b"].predict(x, device=dev), dtype=np.float64)
        out = []
        for m in margins:
            if getattr(m, "ndim", 0):  # multiclass: argmax over scores
                row = {
                    "margin": [float(v) for v in m],
                    "prediction": float(int(np.argmax(m))),
                }
            else:
                row = {"margin": float(m)}
                if objective == "binary":
                    row["prediction"] = float(m > 0)
                    row["probability"] = float(1.0 / (1.0 + np.exp(-m)))
                else:
                    row["prediction"] = float(m)
            out.append(row)
        return out

    def handler(reqs: list) -> dict:
        out = {}
        for r in reqs:
            try:
                body = json.loads(r.body) if r.body else {}
                x = _rows(body)
            except INPUT_ERRORS as e:  # a bad row 400s alone
                out[r.id] = _bad(e)
                continue
            scored = _score(x)
            payload = {"rows": scored} if "rows" in body else scored[0]
            out[r.id] = (200, json.dumps(payload).encode(), {})
        return out

    def warmup() -> None:
        _score(np.zeros((1, max(1, n_features)), np.float32))

    def release() -> None:
        state["b"] = None

    return LoadedModel(
        handler=handler, nbytes=nbytes, warmup=warmup, release=release,
        measure=lambda: tensor_nbytes(state["b"]._stacked, dev),
        meta={"spec": f"gbdt:{path}", "objective": objective, "device": str(dev)},
    )


def build_loaded_model(spec: Any, device: Any = None,
                       zoo_dir: Optional[str] = None) -> LoadedModel:
    """Resolve a model spec, placing the model on ``device`` (None = the
    card, which raises without one):

    - :class:`LoadedModel` — passed through unchanged;
    - callable            — treated as a bare batch handler;
    - ``"echo"``          — JSON echo (smoke tests / drills);
    - ``"zoo:<name>"``    — ImageFeaturizer on the named zoo backbone
      (the zoo under ``zoo_dir``, else the default one);
    - ``"module:pkg.fn"`` — ``pkg.fn()`` returning a handler OR a
      :class:`LoadedModel`;
    - ``"pipeline:<dir>"`` — a saved PipelineModel/CompiledPipeline dir,
      compiled, its buckets' CUDA graphs captured before ready;
    - ``"vw:<snapshot.npz>"`` — a VW linear model, scored by
      ``vw_margin``;
    - ``"gbdt:<model.json>"`` — a trained GBDT booster model string;
    - ``"artifact:..."`` — not ported yet (raises NotImplementedError).
    """
    if isinstance(spec, LoadedModel):
        return spec
    if callable(spec):
        return LoadedModel(handler=spec)
    if not isinstance(spec, str):
        raise ValueError(f"unsupported model spec {spec!r}")
    if spec == "echo":
        return _echo_loaded()
    if spec.startswith("zoo:"):
        return _zoo_loaded(spec[len("zoo:"):], _placement(device), zoo_dir)
    if spec.startswith("pipeline:"):
        return _pipeline_loaded(spec[len("pipeline:"):], _placement(device))
    if spec.startswith("vw:"):
        return _vw_loaded(spec[len("vw:"):], _placement(device))
    if spec.startswith("gbdt:"):
        return _gbdt_loaded(spec[len("gbdt:"):], _placement(device))
    if spec.startswith("artifact:"):
        raise NotImplementedError(_ARTIFACTS_TODO)
    if spec.startswith("module:"):
        import importlib

        mod_name, _, fn_name = spec[len("module:"):].rpartition(".")
        obj = getattr(importlib.import_module(mod_name), fn_name)()
        if isinstance(obj, LoadedModel):
            return obj
        return LoadedModel(handler=obj, meta={"spec": spec})
    raise ValueError(f"unknown model spec {spec!r}")
