"""The recluster cell at a test size on the CPU: sound runs come out
correct; the control, and runs with the timed path broken underneath or
the stored chains altered, do not; its metrics by name; and the tau
cell reads the metrics it read before the recluster cell came."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rtabench import control, control_recluster, harness
from rtabench.jobs import recluster
from rtabench.tests.tiny import TAU_CONFIG, TAU_TRAFFIC, run_tiny

CELL = "w313.recluster"
TRAFFIC = {"check": {**TAU_TRAFFIC["check"], "judged_max": 32}}
KW = {"config_override": TAU_CONFIG, "traffic_override": TRAFFIC}


def _run(tmp_path, seed=5, seconds=1.0, trace=False):
    return harness.run_cell(CELL, seed, seconds, trace, device="cpu",
                            workdir=str(tmp_path / "work"), **KW)


def _bench():
    return harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11])
def test_sound_runs_are_correct(tmp_path, seed):
    result, checks = _run(tmp_path, seed)
    assert result["correct"], checks
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert set(checks) == {"split_off", "chains_off", "loglik_gap",
                           "gmm_gap", "tau_gap"}
    assert set(result["metrics"]) == {"recluster_job_s", "setup_s"}


def test_traced_line_on_the_cpu_has_the_reload_span(tmp_path):
    result, _ = _run(tmp_path, trace=True)
    # no device trace on the CPU: only the outside span's metric
    assert set(result["metrics"]) == {"reload_s.recluster"}
    assert result["metrics"]["reload_s.recluster"]["value"] > 0
    assert "breakdown" not in result


def test_cell_metrics_of_the_recluster_cell():
    b = _bench()
    assert harness.cell_metrics(b, CELL, False) == ["recluster_job_s",
                                                    "setup_s"]
    assert harness.cell_metrics(b, CELL, True) == [
        "device_idle_pct.recluster", "post_s.recluster",
        "gmm_host_reads.recluster", "post_idle_s.recluster",
        "reload_s.recluster"]


def test_the_tau_cell_reads_what_it_read(tmp_path):
    b = _bench()
    assert harness.cell_metrics(b, "w313.tau", True) == [
        "sampling_s.residue", "segment_roofline", "device_idle_pct.residue",
        "checkpoint_s.residue", "checkpoint_mb.residue", "post_s.residue",
        "gmm_host_reads.residue", "post_idle_s.residue",
        "checkpoint_behind.residue"]
    result, _ = run_tiny("w313.tau", tmp_path)
    assert list(result["metrics"]) == ["residue_tau_s", "setup_s"]


def test_clusters_altered_where_labelled(tmp_path):
    """Every other pair's GMM label set to the first cluster's."""
    result, checks = control.readings(CELL, 5, 0.0, device="cpu",
                                      fault="relabel",
                                      workdir=str(tmp_path / "f"), **KW)
    assert not result["correct"]
    assert checks["gmm_gap"][0] > checks["gmm_gap"][1]


def test_the_check_judges_chains_drawn_from_the_seed(tmp_path,
                                                    monkeypatch):
    """Besides the window's jobs on set-up's fixed chains, the check
    judges one job on chains that the run's seed draws."""
    from rtabench.jobs import tau
    real, seen = tau.judge_cluster, []

    def judge(z, times, run, seed, dev):
        seen.append((run.seed, z["mcweights"].tobytes()))
        return real(z, times, run, seed, dev)

    monkeypatch.setattr(tau, "judge_cluster", judge)
    for seed in (5, 6):
        result, _ = _run(tmp_path, seed)
        assert result["correct"]
    chains = {s: {w for t, w in seen if t == s} for s in (5, 6)}
    # set-up's chains in both runs, and a second set of each seed's own
    assert len(chains[5]) == len(chains[6]) == 2
    assert len(chains[5] & chains[6]) == 1


def test_chains_altered_on_disk(tmp_path, monkeypatch):
    """The stored chains rewritten between set-up and the window."""
    real = recluster.setup

    def altered(run):
        state = real(run)
        for path in state["paths"].values():
            with np.load(path) as z:
                arrays = dict(z)
            arrays["mcrates"] = arrays["mcrates"] * np.float32(1.5)
            np.savez(path, **arrays)
        return state

    monkeypatch.setattr(recluster, "setup", altered)
    result, checks = _run(tmp_path)
    assert not result["correct"]
    assert checks["chains_off"][0] > checks["chains_off"][1]


def test_reprocess_that_saves_nothing(tmp_path, monkeypatch):
    """A job that leaves the earlier result in place."""
    from basicrta_torch.protein.driver import ProcessProtein
    monkeypatch.setattr(ProcessProtein, "reprocess", lambda self: None)
    result, checks = _run(tmp_path)
    assert not result["correct"]
    # every window job, and the check's job on the second chain set
    assert result["failed"] == result["attempted"] + 1


def test_half_the_times_reloaded(tmp_path, monkeypatch):
    from basicrta_torch.sampler.gibbs import Gibbs
    real = Gibbs.load

    def half(cls, path):
        g = real(path)
        h = Gibbs(g.times[: len(g.times) // 2], residue=g.residue,
                  cutoff=g.cutoff, cfg=g.cfg, root=g.root)
        h.mcweights, h.mcrates = g.mcweights, g.mcrates
        return h

    monkeypatch.setattr(Gibbs, "load", classmethod(half))
    result, checks = _run(tmp_path)
    assert not result["correct"]
    assert checks["split_off"][0] > checks["split_off"][1]


def test_tau_altered_where_written(tmp_path, monkeypatch):
    from basicrta_torch.protein.driver import ProcessProtein
    real = ProcessProtein.get_taus

    def altered(self):
        taus, bars = real(self)
        return taus * 1.01, bars

    monkeypatch.setattr(ProcessProtein, "get_taus", altered)
    result, checks = _run(tmp_path)
    assert not result["correct"]
    assert checks["tau_gap"][0] > checks["tau_gap"][1]


@pytest.mark.parametrize("kind", control_recluster.KINDS)
def test_the_control_is_not_correct(tmp_path, kind):
    """The reference's cluster in bfloat16 in ``reprocess``'s place,
    through the harness's own comparison."""
    result, checks = control_recluster.readings(
        CELL, 5, 0.0, device="cpu", kind=kind, workdir=str(tmp_path / "c"),
        **KW)
    assert result["attempted"] == 1 and result["failed"] == 0
    assert checks["chains_off"][0] == 0 and checks["split_off"][0] == 0
    assert not result["correct"]
    assert checks["tau_gap"][0] > checks["tau_gap"][1]


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, "-m", "rtabench", "--workload",
                        CELL, "--seed", "3", "--seconds", "1",
                        "--trace", "1"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert set(line["metrics"]) == set(harness.cell_metrics(_bench(), CELL,
                                                            True))
