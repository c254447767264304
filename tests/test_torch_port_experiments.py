"""The port's experiment orchestration (``mmlspark_tpu_torch/experiments/``,
``automl/hyperparams.py`` and ``fleet tune`` / ``fleet trial``) against the
JAX package's, on the CPU.

The rung math, the search spaces and the registry records are host code
and must agree exactly: the same seeded reports give both packages the
same boundaries, promotion sets and leaderboard bytes; the same seed
draws the same param maps; records either package commits read back in
the other, on either package's registry. The controller's trials are the
port's own fleet (``-m mmlspark_tpu_torch.serving.fleet trial --device
...``); end to end, ``fleet tune --device cpu`` runs its trials as
processes, each training through ``fleet train``'s member, and the
winner's model is byte-identical to a fresh fit to ``max_iters`` with its
params (its digest is the committed one), served bitwise by a worker.

Processes spawned here get one intra-op thread each.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from mmlspark_tpu.automl import hyperparams as JH
from mmlspark_tpu.experiments import asha as JA
from mmlspark_tpu.experiments import controller as JC
from mmlspark_tpu.experiments import records as JR

from mmlspark_tpu_torch.automl import hyperparams as PH
from mmlspark_tpu_torch.experiments import asha as PA
from mmlspark_tpu_torch.experiments import controller as PC
from mmlspark_tpu_torch.experiments import records as PR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEAD_REGISTRY = "http://127.0.0.1:9"   # connection refused, at once


@pytest.fixture(autouse=True)
def _children_env(monkeypatch):
    """Spawned trials import torch (one thread each) and find the port."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    pp = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", ROOT + (os.pathsep + pp if pp else ""))


# -- ASHA math ----------------------------------------------------------------------


@pytest.mark.parametrize("budget", [(2, 8, 2), (2, 20, 3), (1, 1, 2), (1, 100, 3),
                                    (3, 50, 4), (5, 6, 2)])
def test_rung_boundaries_match_jax(budget):
    assert PA.rung_boundaries(*budget) == JA.rung_boundaries(*budget)


@pytest.mark.parametrize("budget", [(0, 8, 2), (4, 2, 2), (2, 8, 1)])
def test_bad_budgets_raise_in_both(budget):
    with pytest.raises(ValueError) as jerr:
        JA.rung_boundaries(*budget)
    with pytest.raises(ValueError) as perr:
        PA.rung_boundaries(*budget)
    assert str(perr.value) == str(jerr.value)


def _reports(seed: int, n: int = 9) -> dict:
    """{trial: metric} with ties: metrics on a grid of 0.05."""
    rng = np.random.default_rng(seed)
    return {f"t{i:03d}": float(np.round(rng.random() * 20) / 20) for i in range(n)}


@pytest.mark.parametrize("higher", [True, False])
@pytest.mark.parametrize("eta", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_promotions_and_leaderboard_bytes_match_jax(seed, eta, higher):
    """Three rungs of seeded reports, each rung's survivors the last
    rung's promoted: promotion sets, boards, records and the canonical
    leaderboard bytes equal the JAX package's."""
    survivors = sorted(_reports(seed))
    rungs_p, rungs_j = {}, {}
    for rung in range(3):
        metrics = {t: m for t, m in _reports(seed * 10 + rung).items() if t in survivors}
        got = PA.promote(metrics, eta, seed, higher)
        want = JA.promote(metrics, eta, seed, higher)
        assert got == want
        assert PA.n_promote(len(metrics), eta) == JA.n_promote(len(metrics), eta)
        rungs_p[rung] = PA.rung_record(rung, *got, eta, seed)
        rungs_j[rung] = JA.rung_record(rung, *want, eta, seed)
        survivors = got[0]
    assert rungs_p == rungs_j
    assert PA.leaderboard_bytes(rungs_p) == JA.leaderboard_bytes(rungs_j)
    bounds = [2, 4, 8]
    reports = {(t, r): {} for t in _reports(seed) for r in range(2) if t < "t004"}
    for t in _reports(seed):
        assert PA.next_rung(t, reports, bounds) == JA.next_rung(t, reports, bounds)
        for r in range(4):
            assert PA.is_demoted(t, r, rungs_p) == JA.is_demoted(t, r, rungs_j)


# -- search spaces ------------------------------------------------------------------


SPACE_JSON = {"num_leaves": [7, 15, 31, 63], "min_data_in_leaf": {"low": 5, "high": 40,
              "int": True}, "learning_rate": {"low": 0.02, "high": 0.5, "log": True}}


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_space_draws_match_jax(seed):
    assert PC.sample_trials(PC.default_space(), 6, seed) == JC.sample_trials(
        JC.default_space(), 6, seed)
    assert PC.sample_trials(PC.space_from_json(SPACE_JSON), 5, seed) == JC.sample_trials(
        JC.space_from_json(SPACE_JSON), 5, seed)
    for name in ("gbdt", "logistic_regression"):
        p = list(PH.RandomSpace(getattr(PH.DefaultHyperparams, name)(), seed).param_maps(4))
        j = list(JH.RandomSpace(getattr(JH.DefaultHyperparams, name)(), seed).param_maps(4))
        assert p == j
    grid = [("a", PH.DiscreteHyperParam([1, 2])), ("b", PH.RangeHyperParam(0, 1, is_int=False))]
    jgrid = [("a", JH.DiscreteHyperParam([1, 2])), ("b", JH.RangeHyperParam(0, 1, is_int=False))]
    assert list(PH.GridSpace(grid).param_maps()) == list(JH.GridSpace(jgrid).param_maps())


def test_space_json_refuses_what_jax_refuses():
    for mod in (PC, JC):
        with pytest.raises(ValueError, match="space entry"):
            mod.space_from_json({"num_leaves": 7})


# -- records ------------------------------------------------------------------------


def _registry(pkg: str):
    if pkg == "jax":
        from mmlspark_tpu.serving import fleet as jfleet

        return jfleet.run_registry(host="127.0.0.1", port=0, ttl_s=5.0)
    from mmlspark_tpu_torch.serving import fleet

    return fleet.run_registry(host="127.0.0.1", port=0, ttl_s=5.0)


@pytest.mark.parametrize("registry_pkg", ["jax", "torch"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_records_written_by_one_package_read_back_in_the_other(writer, registry_pkg):
    W, R = (JR, PR) if writer == "jax" else (PR, JR)
    WA = JA if writer == "jax" else PA
    reg = _registry(registry_pkg)
    try:
        rec = W.report_trial(reg.url, "ex", "t000", 0, 0.75, "ck0", "md0", 2,
                             {"num_leaves": 7})
        W.report_trial(reg.url, "ex", "t001", 0, 0.5, "ck1", "md1", 2,
                       {"num_leaves": 15, "learning_rate": 0.1})
        promoted, board = WA.promote({"t000": 0.75, "t001": 0.5}, 2, 3)
        rung = WA.rung_record(0, promoted, board, 2, 3)
        assert W.cas_commit(reg.url, W.rung_record_name("ex", 0), rung) == (True, None)
        W.cas_commit(reg.url, W.winner_record_name("ex"), {"trial": "t000", "model": "md0"})
        W.register(reg.url, {"name": W.live_service_name("ex"), "host": "t001", "port": 1})
        st = R.read_state(reg.url, "ex")
        assert st.reports[("t000", 0)]["ckpt"] == rec["ckpt"] == "ck0"
        assert st.reports[("t001", 0)]["params"] == {"num_leaves": 15, "learning_rate": 0.1}
        assert st.rung_metrics(["t000", "t001"], 0) == {"t000": 0.75, "t001": 0.5}
        assert st.rungs[0]["promoted"] == ["t000"]
        assert st.rungs[0]["leaderboard"] == [["t000", 0.75], ["t001", 0.5]]
        assert st.winner["trial"] == "t000"
        assert list(st.live) == ["t001"]
        # the reader adopts the writer's incumbents: first writer wins
        again = R.report_trial(reg.url, "ex", "t000", 0, 0.75, "ckX", "mdX", 2, {})
        assert again["ckpt"] == "ck0"
        committed, current = R.cas_commit(reg.url, R.rung_record_name("ex", 0),
                                          {"promoted": ["t001"]})
        assert not committed and current["promoted"] == ["t000"]
        jst, pst = JR.read_state(reg.url, "ex"), PR.read_state(reg.url, "ex")
        assert (pst.reports, pst.rungs, pst.winner) == (jst.reports, jst.rungs, jst.winner)
    finally:
        reg.stop()


def test_state_from_roster_matches_jax():
    rep = {"trial": "t000", "rung": 0, "metric": 0.8, "ckpt": "c0", "model": "m0",
           "iters": 2, "params": {"num_leaves": 7}}
    roster = {
        PR.trial_record_name("e", "t000", 0): [rep],
        PR.rung_record_name("e", 0): [PA.rung_record(0, ["t000"], [["t000", 0.8]], 2, 7)],
        PR.winner_record_name("e"): [{"trial": "t000"}],
        PR.live_service_name("e"): [{"host": "t000", "port": 1, "ts": 1.0}],
        PR.trial_record_name("e2", "t000", 0): [rep],
        "serving": [{"host": "127.0.0.1", "port": 80}],
    }
    p, j = PR.state_from_roster("e", roster), JR.state_from_roster("e", roster)
    assert (p.reports, p.rungs, p.winner, p.live) == (j.reports, j.rungs, j.winner, j.live)
    with pytest.raises(PR.ExperimentWireError):
        PR.cas_commit(DEAD_REGISTRY, "x-gen", {"a": 1})


# -- the controller and its trials --------------------------------------------------


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_trial_argv_names_the_port_fleet(device, tmp_path):
    kw = dict(n_trials=2, workdir=str(tmp_path), seed=5)
    port = PC.ExperimentController(DEAD_REGISTRY, "ex", device=device, **kw)
    ref = JC.ExperimentController(DEAD_REGISTRY, "ex", **kw)
    try:
        got, want = port._trial_argv("t000", 1), ref._trial_argv("t000", 1)
        assert got[1:5] == ["-m", "mmlspark_tpu_torch.serving.fleet", "trial", "--device"]
        assert got[5] == device
        assert want[1:4] == ["-m", "mmlspark_tpu.serving.fleet", "trial"]
        # every other argument as the JAX controller's, then the trial's status file
        assert got[6:-2] == want[4:]
        assert got[-2:] == ["--status-file",
                            os.path.join(str(tmp_path), "t000", "i01", "status.json")]
    finally:
        port.close()
        ref.close()
    assert PC.ExperimentController(DEAD_REGISTRY, "ex", **kw).device == "cuda"


def test_controller_status_obeys_conservation_law(tmp_path):
    from mmlspark_tpu_torch.chaos.invariants import InvariantChecker

    ctrl = PC.ExperimentController(DEAD_REGISTRY, "expC", n_trials=3, workdir=str(tmp_path),
                                   spawn_cmd="true {argv}",
                                   status_file=str(tmp_path / "st.json"))
    try:
        for t in ctrl.trials:
            ctrl._spawn(t)
        ctrl._reap_and_respawn(PR.ExperimentState())
        ctrl._write_status(None)
        st = json.loads((tmp_path / "st.json").read_text())
        assert st["trials_spawned"] == (st["completed"] + st["demoted"] + st["rescheduled"]
                                        + st["running"])
        assert InvariantChecker(
            experiment_status_files=[str(tmp_path / "st.json")]).check(final=True) == []
    finally:
        ctrl.close()


def test_trial_refuses_unknown_params_and_a_missing_card(tmp_path):
    from mmlspark_tpu_torch.experiments.trial import run_trial

    with pytest.raises(ValueError, match="bogus"):
        run_trial(DEAD_REGISTRY, "expV", "t000", {"bogus": 1}, "synth:64x4:1",
                  "synth:32x4:2", str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_trial(DEAD_REGISTRY, "expV", "t000", {}, "synth:64x4:1", "synth:32x4:2",
                  str(tmp_path))


TUNE = dict(trials=4, data="synth:512x8:1", valid="synth:256x8:99", seed=3,
            min_iters=2, max_iters=8, eta=2)


def test_fleet_tune_and_trial_end_to_end_on_the_cpu(tmp_path):
    """``fleet tune --device cpu`` (a process) runs four ``fleet trial
    --device cpu`` charges to a published winner: the rung records are
    asha.promote of the reports, the winner's model is byte-identical to a
    fresh fit to max_iters (its digest is the committed one), and the
    worker serves it bitwise as the in-process booster."""
    from mmlspark_tpu_torch.chaos.invariants import InvariantChecker
    from mmlspark_tpu_torch.models.gbdt import Booster
    from mmlspark_tpu_torch.parallel.elastic import load_training_data
    from mmlspark_tpu_torch.serving import fleet

    reg = fleet.run_registry(host="127.0.0.1", port=0, ttl_s=5.0)
    srv, q, wstop = fleet.run_worker(reg.url, model="echo", host="127.0.0.1",
                                     heartbeat_s=0.2, device="cpu",
                                     artifact_dir=str(tmp_path / "worker_art"))
    status = tmp_path / "tune.json"
    try:
        argv = [sys.executable, "-m", "mmlspark_tpu_torch.serving.fleet", "tune",
                "--registry", reg.url, "--experiment", "ex", "--device", "cpu",
                "--workdir", str(tmp_path / "wd"), "--status-file", str(status),
                "--publish-model", "champion", "--deadline-s", "240"]
        for k, v in TUNE.items():
            argv += [f"--{k.replace('_', '-')}", str(v)]
        r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        out = json.loads(status.read_text())
        assert out["published"] is True and out["running"] == 0
        assert out["trials_spawned"] == out["completed"] + out["demoted"] + out["rescheduled"]
        assert InvariantChecker(experiment_status_files=[str(status)]).check(final=True) == []
        st = PR.read_state(reg.url, "ex")
        survivors = sorted(PC.sample_trials(PC.default_space(), TUNE["trials"], TUNE["seed"]))
        for rung in range(len(out["boundaries"])):
            promoted, board = PA.promote(st.rung_metrics(survivors, rung), TUNE["eta"],
                                         TUNE["seed"])
            assert out["rungs"][str(rung)] == promoted == st.rungs[rung]["promoted"]
            assert st.rungs[rung]["leaderboard"] == board
            survivors = promoted
        winner = out["winner"]
        assert [winner["trial"]] == out["rungs"][str(len(out["boundaries"]) - 1)]
        # the committed digest, re-derived by a fresh fit to max_iters
        booster = fleet.run_train(reg.url, "fresh", TUNE["data"], str(tmp_path / "fresh"),
                                  partitions=4, world_size=1, service_name="fresh-fit",
                                  num_iterations=TUNE["max_iters"], checkpoint_every=1,
                                  heartbeat_s=0.5, seed=TUNE["seed"], allow_growback=False,
                                  device="cpu", **winner["params"])
        model = booster.to_model_string()
        assert hashlib.sha256(model.encode()).hexdigest() == winner["model"]
        # served by the worker, bitwise the in-process booster
        xv, _ = load_training_data(TUNE["valid"])
        want = Booster.from_model_string(model).predict(xv[:16], device="cpu")
        got = []
        for row in xv[:16]:
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
            c.request("POST", "/models/champion", body=json.dumps({"features": row.tolist()}),
                      headers={"Content-Type": "application/json"})
            resp = c.getresponse()
            assert resp.status == 200
            got.append(json.loads(resp.read())["margin"])
            c.close()
        assert got == [float(m) for m in want]
    finally:
        wstop.stop()
        q.stop()
        srv.stop()
        reg.stop()


def test_stranded_winner_retrain_rederives_committed_digest(tmp_path):
    """No replica survives controller A: successor B respawns the winner's
    trial, whose retrain lands the byte-identical model under the
    committed digest."""
    from mmlspark_tpu_torch.serving import fleet

    args = dict(n_trials=2, data="synth:128x6:1", valid="synth:64x6:99", min_iters=2,
                max_iters=2, eta=2, seed=11, deadline_s=240.0, heartbeat_s=0.5,
                tick_s=0.25, poll_s=0.25, decision_timeout_s=10.0, device="cpu")
    reg = fleet.run_registry(host="127.0.0.1", port=0, ttl_s=2.0)
    a = b = None
    try:
        a = PC.ExperimentController(reg.url, "retrain", workdir=str(tmp_path / "a"), **args)
        deadline = time.monotonic() + 120.0
        while True:
            state = a.tick()
            if state is not None and state.winner is not None:
                committed = dict(state.winner)
                break
            assert time.monotonic() < deadline, "no winner committed"
            time.sleep(0.25)
        for ch in a.charges.values():
            if ch.alive():
                os.kill(ch.proc.pid, signal.SIGKILL)
        a.close()
        b = PC.ExperimentController(reg.url, "retrain", workdir=str(tmp_path / "b"), **args)
        out = b.run()
        assert b.spawned >= 1
        assert out["winner"]["model"] == committed["model"]
        assert b._store.has(committed["model"])
    finally:
        for ctrl in (b, a):
            if ctrl is not None:
                ctrl.close()
        reg.stop()
