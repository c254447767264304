"""The port's ``core/profiling.py`` (``trace``, ``annotate``,
``ProfiledRun``, ``device_phase``) against the JAX package's.

``ProfiledRun`` gives the same stage names, in the same order, as the JAX
one on the same pipeline, and the same outputs; each stage's span lands in
the metrics registry under the JAX package's name; ``trace`` writes a
non-empty Chrome trace holding the annotated spans.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from mmlspark_tpu import DataFrame as JDataFrame
from mmlspark_tpu import Pipeline as JPipeline
from mmlspark_tpu.core.profiling import ProfiledRun as JProfiledRun
from mmlspark_tpu.stages import DropColumns as JDropColumns
from mmlspark_tpu.stages import RenameColumn as JRenameColumn
from mmlspark_tpu_torch import DataFrame, Pipeline, obs
from mmlspark_tpu_torch.core import profiling as P
from mmlspark_tpu_torch.stages import DropColumns, RenameColumn


def _pipelines():
    cols = {"a": np.arange(5), "b": np.arange(5)}
    jdf, df = JDataFrame.from_dict(cols), DataFrame.from_dict(cols)
    jpm = JPipeline([JRenameColumn(input_col="a", output_col="x"),
                     JDropColumns(cols=["b"])]).fit(jdf)
    pm = Pipeline([RenameColumn(input_col="a", output_col="x"), DropColumns(cols=["b"])]).fit(df)
    return (jpm, jdf), (pm, df)


def test_profiled_run_stage_names_equal_jax():
    (jpm, jdf), (pm, df) = _pipelines()
    jprof, prof = JProfiledRun(), P.ProfiledRun()
    jout, out = jprof.transform(jpm, jdf), prof.transform(pm, df)
    assert out.columns == jout.columns == ["x"]
    np.testing.assert_array_equal(out["x"], jout["x"])
    stats, jstats = prof.stats(), jprof.stats()
    assert stats.columns == jstats.columns == ["stage", "seconds"]
    assert stats["stage"].tolist() == jstats["stage"].tolist() == ["RenameColumn", "DropColumns"]
    assert (stats["seconds"] >= 0).all()


def test_stage_spans_land_in_the_registry():
    _, (pm, df) = _pipelines()
    parsed0 = obs.parse_text(obs.render())
    P.ProfiledRun().transform(pm, df)
    parsed = obs.parse_text(obs.render())
    for stage in ("RenameColumn", "DropColumns"):
        key = ("mmlspark_trace_span_seconds_count", {"span": f"pipeline.{stage}"})
        assert obs.sum_samples(parsed, *key) - obs.sum_samples(parsed0, *key) == 1.0
        key = ("mmlspark_device_seconds_total", {"phase": "execute", "stage": stage})
        assert obs.sum_samples(parsed, *key) >= obs.sum_samples(parsed0, *key)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_plain_transformer_profiles_as_one_stage(pkg):
    class Plain:  # no params()/get(): a duck-typed stage
        def transform(self, df):
            return df

    prof = JProfiledRun() if pkg == "jax" else P.ProfiledRun()
    df = (JDataFrame if pkg == "jax" else DataFrame).from_dict({"a": np.arange(3)})
    assert prof.transform(Plain(), df).columns == ["a"]
    assert prof.stats()["stage"].tolist() == ["Plain"]


def test_pipeline_stages_fallbacks_as_jax():
    from mmlspark_tpu.core.profiling import _pipeline_stages as j_stages

    (jpm, _), (pm, _) = _pipelines()
    assert [type(s).__name__ for s in P._pipeline_stages(pm)] == [
        type(s).__name__ for s in j_stages(jpm)]
    stage = RenameColumn(input_col="a", output_col="x")
    assert P._pipeline_stages(stage) == [stage]  # declares no "stages"
    assert P._stage_device(stage) is None
    assert P._stage_device(object()) is None


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    _, (pm, df) = _pipelines()
    log_dir = str(tmp_path / "trace")
    with P.trace(log_dir) as prof:
        with P.annotate("port.span"):
            P.ProfiledRun().transform(pm, df)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    path = os.path.join(log_dir, files[0])
    assert os.path.getsize(path) > 0
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"port.span", "pipeline.RenameColumn", "pipeline.DropColumns"} <= names
    assert any(e.key == "port.span" for e in prof.key_averages())
    with P.trace(log_dir):
        pass
    assert len(os.listdir(log_dir)) == 2  # a second capture does not overwrite the first
