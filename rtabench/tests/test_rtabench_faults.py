"""Runs with the timed path broken underneath, and the control in the
program's place, come out not correct: at a test size, on the CPU."""

import numpy as np

from rtabench.control import readings
from rtabench.tests.tiny import TAU_CONFIG, TAU_TRAFFIC, run_tiny


def test_sound_runs_are_correct(tmp_path):
    for seed in (5, 2 ** 31 + 11):
        result, checks = run_tiny("w313.tau", tmp_path / str(seed), seed)
        assert result["correct"], checks


def test_stuck_chains(tmp_path, monkeypatch):
    """A sampler step that returns its state unchanged."""
    from basicrta_torch.protein import driver
    from basicrta_torch.sampler.kernels import init_mixture_params
    real = driver.run_residues

    def stuck(times, cfg, n_chains=1, **kw):
        out = real(times, cfg, n_chains=n_chains, **kw)
        st = init_mixture_params(cfg.ncomp)
        w, r = st.weights.numpy(), st.rates.numpy()
        return {k: (np.broadcast_to(w, W.shape).copy(),
                    np.broadcast_to(r, R.shape).copy())
                for k, (W, R) in out.items()}

    monkeypatch.setattr(driver, "run_residues", stuck)
    result, checks = run_tiny("w313.tau", tmp_path)
    assert not result["correct"]
    assert checks["loglik_gap"][0] > checks["loglik_gap"][1]


def test_half_the_events_left_out(tmp_path, monkeypatch):
    from basicrta_torch.contacts.records import ContactEvents
    real = ContactEvents.split_by_residue

    def half(self, resids=None):
        return {k: v[: (len(v) + 1) // 2]
                for k, v in real(self, resids).items()}

    monkeypatch.setattr(ContactEvents, "split_by_residue", half)
    result, checks = run_tiny("w313.tau", tmp_path)
    assert not result["correct"]
    assert checks["split_off"][0] > checks["split_off"][1]


def test_tau_altered_where_written(tmp_path, monkeypatch):
    from basicrta_torch.protein.driver import ProcessProtein
    real = ProcessProtein.get_taus

    def altered(self):
        taus, bars = real(self)
        return taus * 1.01, bars

    monkeypatch.setattr(ProcessProtein, "get_taus", altered)
    result, checks = run_tiny("w313.tau", tmp_path)
    assert not result["correct"]
    assert checks["tau_gap"][0] > checks["tau_gap"][1]


def test_clusters_altered_where_labelled(tmp_path):
    """Every other pair's GMM label set to the first cluster's."""
    result, checks = readings("w313.tau", 5, 0.0, device="cpu",
                              fault="relabel", config_override=TAU_CONFIG,
                              traffic_override=TAU_TRAFFIC,
                              workdir=str(tmp_path / "f"))
    assert not result["correct"]
    assert checks["gmm_gap"][0] > checks["gmm_gap"][1]


def test_the_control_is_not_correct(tmp_path):
    """The reference in bfloat16 in the program's place, through the
    harness's own comparison."""
    result, checks = readings("w313.tau", 5, 0.0, device="cpu",
                              config_override=TAU_CONFIG,
                              traffic_override=TAU_TRAFFIC,
                              workdir=str(tmp_path / "c"))
    assert result["attempted"] == 1 and result["failed"] == 0
    assert not result["correct"]
    # at this size the bfloat16 sampler still follows the posterior; its
    # tau, worked out in bfloat16, does not
    assert checks["tau_gap"][0] > checks["tau_gap"][1]
    program, _ = readings("w313.tau", 5, 0.0, program=True, device="cpu",
                          config_override=TAU_CONFIG,
                          traffic_override=TAU_TRAFFIC,
                          workdir=str(tmp_path / "p"))
    assert program["correct"]
