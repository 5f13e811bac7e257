"""Simulation-based calibration of the port's samplers on the CPU
(``basicrta_torch.scripts.sbc``): ranks of identifiable functionals of
prior-drawn truths among posterior draws must be uniform. The full-size
runs are phase 10a of ``chip_smoke.py``, on the card."""

import pytest
import torch

from basicrta_torch.scripts import sbc


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Chains are many small eager steps: with torch's intra-op threads,
    each step waits for threads that the suite's other workers keep busy
    (a 2 s test took minutes). One thread here, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sbc_collapsed_engine_reduced():
    """64 replicates of 300 events, K = 3, 1,000 sweeps thinned every 5,
    seed 11: fixed seed, so the p-values are fixed; each above 0.001."""
    pvals, ranks = sbc.run_sbc(M=64, n_events=300, ncomp=3, niter=1000,
                               g=5, burnin=200, seed=11, engine="collapsed",
                               device="cpu", progress=lambda *_: None)
    assert ranks.shape == (64, 4)
    assert all(p > 0.001 for p in pvals.values()), pvals


def test_sbc_cli_refuses_without_a_card_and_runs_on_the_cpu(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            sbc.main(["--replicates", "8"])
    rc = sbc.main(["--replicates", "16", "--events", "100", "--ncomp", "2",
                   "--niter", "300", "--engine", "collapsed", "--device",
                   "cpu"])
    out = capsys.readouterr().out
    assert "SBC:" in out and rc in (0, 1)


@pytest.mark.slow
def test_sbc_ranks_uniform_torch_engine():
    """``tests/test_sbc.py``'s sizes on the plain versions of the fused
    kernels (the 'torch' engine)."""
    pvals, ranks = sbc.run_sbc(M=32, n_events=400, ncomp=3, niter=3000,
                               g=50, burnin=500, seed=11, engine="torch",
                               progress=lambda *_: None)
    assert all(p > 0.01 for p in pvals.values()), pvals
    assert ranks.shape == (32, 4)
