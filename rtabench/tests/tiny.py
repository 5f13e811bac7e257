"""Tiny sizes of the cells for CPU runs."""

from rtabench import harness

TAU_CONFIG = {"dataset": {"n_events": 2000, "timestep_ns": 0.1, "seed": 0,
                          "weights": [0.87, 0.09, 0.03, 0.009, 0.001],
                          "rates_per_ns": [4.7, 1.3, 0.33, 0.06, 0.009]},
              "gibbs": {"ncomp": 4, "niter": 300, "g": 10, "burnin": 100,
                        "n_chains": 2, "gamma_shape": 1.0, "gamma_rate": 3.0,
                        "noise_cutoff": 0.4, "gmm_n_init": 3,
                        "gmm_max_iter": 100, "gmm_tol": 0.001,
                        "weight_cut_events": 10.0}}
TAU_TRAFFIC = {"warm_niter": 60,
               "check": {"ref_sweeps": 800, "ref_burnin": 200,
                         "ref_thin": 2, "noise_doubt": 0.15}}


def run_tiny(cell, tmp_path, seed=5, trace=False, **kw):
    """One CPU run of ``cell`` at a test size: (result, checks)."""
    kw.setdefault("config_override", TAU_CONFIG)
    kw.setdefault("traffic_override", TAU_TRAFFIC)
    return harness.run_cell(cell, seed, 0.0, trace, device="cpu",
                            workdir=str(tmp_path / "work"), **kw)
