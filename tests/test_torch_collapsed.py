"""The collapsed engine (``run_batch(engine='collapsed')``, the counterpart
of the JAX package's ``xla`` engine) and the reference modes of
``Gibbs.run`` on the CPU: against the JAX package in law, exact resume,
its own checkpoint tag, lanes independent of their mates in law, the pow2
ladder, and the refusals without a card."""

import os

import numpy as np
import pytest
import torch
from scipy import stats

from basicrta_torch import cli
from basicrta_torch.config import GibbsConfig
from basicrta_torch.contacts.records import ContactEvents, ContactMeta
from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp
from basicrta_torch.sampler import batch
from basicrta_torch.sampler.gibbs import Gibbs
from basicrta_tpu.config import GibbsConfig as JConfig
from basicrta_tpu.sampler import batch as jbatch


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Chains are many small eager steps: with torch's intra-op threads,
    each step waits for threads that the suite's other workers keep busy
    (a 2 s test took minutes). One thread here, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _times(n, seed, w=(0.8, 0.2), r=(2.0, 0.1)):
    return discretize_times(simulate_hyperexp(
        n, list(w), list(r), np.random.default_rng(seed)), 0.1)


def _dominant(W, R, burn):
    """Post-burn-in samples of each chain's heaviest component, pooled
    over the chains (W, R: (chains, S, K))."""
    Wp, Rp = W[:, burn:], R[:, burn:]
    k = Wp.mean(axis=1).argmax(axis=1)
    rows = np.arange(len(k))
    return Wp[rows, :, k].ravel(), Rp[rows, :, k].ravel()


def _same_law(a, b, burn):
    """The dominant component's posterior means within 8 standard errors
    (+ 1e-4) and a two-sample KS on its rate at p > 1e-4
    (``tests/test_equivalence.py``'s rules), over 8 chains each."""
    (wa, ra), (wb, rb) = _dominant(*a, burn), _dominant(*b, burn)
    for x, y in ((wa, wb), (ra, rb)):
        se = x.std() * np.sqrt(2.0 / len(x))
        assert abs(x.mean() - y.mean()) < 8 * se + 1e-4, (x.mean(), y.mean())
    assert stats.ks_2samp(ra, rb).pvalue > 1e-4


def _chains(x, name="A", n=8):
    return {f"{name}#{ch}": x for ch in range(n)}


def test_collapsed_engine_matches_jax_xla_in_law():
    x = _times(3000, 1)
    kw = dict(ncomp=3, niter=500, g=10, burnin=100, seed=4)
    got = batch.run_batch(batch.bucket_residues(_chains(x),
                                                ladder="pow2")[0],
                          GibbsConfig(**kw), engine="collapsed",
                          device="cpu")
    ref = jbatch.run_batch(jbatch.bucket_residues(_chains(x),
                                                  ladder="pow2")[0],
                           JConfig(**kw), engine="xla")
    burn = GibbsConfig(**kw).burnin_samples
    _same_law((ref.mcweights, ref.mcrates), (got.mcweights, got.mcrates),
              burn)


def test_collapsed_engine_resumes_bitwise(tmp_path):
    b = batch.bucket_residues({"A1": _times(1500, 9), "B2": _times(400, 3)},
                              ladder="pow2")[-1]
    cfg = GibbsConfig(ncomp=4, niter=60, g=10, seed=9)
    full = batch.run_batch(b, cfg, segment_blocks=2, engine="collapsed",
                           device="cpu")
    ckpt = str(tmp_path / "ck.npz")

    class Stop(Exception):
        pass

    def bomb(seg_idx, state, _):
        if seg_idx == 2:
            raise Stop

    with pytest.raises(Stop):
        batch.run_batch(b, cfg, segment_blocks=2, checkpoint_path=ckpt,
                        checkpoint_cb=bomb, engine="collapsed", device="cpu")
    assert batch.load_checkpoint(ckpt, b, cfg,
                                 "basicrta_torch-collapsed")[0] == 4
    resumed = batch.run_batch(b, cfg, segment_blocks=2, checkpoint_path=ckpt,
                              engine="collapsed", device="cpu")
    np.testing.assert_array_equal(resumed.mcweights, full.mcweights)
    np.testing.assert_array_equal(resumed.mcrates, full.mcrates)
    assert not os.path.exists(ckpt)


def test_collapsed_engine_has_a_checkpoint_tag_of_its_own(tmp_path):
    b = batch.bucket_residues({"A1": _times(800, 2)}, ladder="pow2")[0]
    cfg = GibbsConfig(ncomp=3, niter=40, g=10, seed=1)

    class Stop(Exception):
        pass

    def bomb(seg_idx, state, _):
        raise Stop

    paths = {}
    for engine in ("collapsed", "torch"):
        paths[engine] = str(tmp_path / f"{engine}.npz")
        with pytest.raises(Stop):
            batch.run_batch(b, cfg, segment_blocks=1, engine=engine,
                            device="cpu", checkpoint_path=paths[engine],
                            checkpoint_cb=bomb)
    tags = ("basicrta_torch-collapsed", "basicrta_torch-torch", "xla")
    for engine, path in paths.items():
        found = [batch.load_checkpoint(path, b, cfg, t) is not None
                 for t in tags]
        assert found == [t == f"basicrta_torch-{engine}" for t in tags]


def test_lane_alone_and_among_mates_agree_in_law():
    """A lane's chain does not depend on its bucket mates in law (the
    lanes share one generator a segment)."""
    x = _times(2500, 5)
    cfg = GibbsConfig(ncomp=3, niter=500, g=10, burnin=100, seed=2)
    alone = batch.run_batch(batch.bucket_residues(_chains(x),
                                                  ladder="pow2")[0],
                            cfg, engine="collapsed", device="cpu")
    mates = {**_chains(x), "B": _times(2000, 6, r=(1.0, 0.05)),
             "C": _times(1200, 7, w=(0.5, 0.5))}
    (b,) = batch.bucket_residues(mates, floor=512)
    among = batch.run_batch(b, cfg, engine="collapsed", device="cpu")
    rows = [among.names.index(f"A#{ch}") for ch in range(8)]
    _same_law((alone.mcweights, alone.mcrates),
              (among.mcweights[rows], among.mcrates[rows]),
              cfg.burnin_samples)


@pytest.mark.parametrize("engine,ladder", [("collapsed", "pow2"),
                                           ("torch", "pow2")])
def test_run_residues_takes_the_pow2_ladder(monkeypatch, engine, ladder):
    seen = []
    original = batch.bucket_residues

    def spy(times, **kw):
        seen.append(kw.get("ladder"))
        return original(times, **kw)

    monkeypatch.setattr(batch, "bucket_residues", spy)
    out = batch.run_residues({"A": _times(300, 1), "B": _times(900, 2)},
                             GibbsConfig(ncomp=3, niter=20, g=10),
                             n_chains=2, engine=engine, device="cpu")
    assert seen == [ladder]
    assert out["A"][0].shape == (2, 2, 3)


def test_collapsed_engine_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        batch.resolve_engine("collapsed")
    with pytest.raises(RuntimeError, match="CUDA device"):
        batch.resolve_engine("collapsed", "cuda")
    assert batch.resolve_engine("collapsed", "cpu") == (
        "collapsed", torch.device("cpu"))
    b = batch.bucket_residues({"A1": _times(300, 1)}, ladder="pow2")[0]
    with pytest.raises(RuntimeError, match="CUDA device"):
        batch.run_batch(b, GibbsConfig(ncomp=3, niter=20, g=10),
                        engine="collapsed")
    with pytest.raises(RuntimeError, match="CUDA device"):
        Gibbs(_times(300, 1), residue="A1", cutoff=7.0).run(mode="dense")


@pytest.mark.parametrize("mode", ["collapsed", "dense"])
def test_gibbs_reference_modes_on_the_cpu(mode, tmp_path):
    x = _times(1500, 3)
    cfg = GibbsConfig(ncomp=3, niter=300, g=10, burnin=50, n_chains=2,
                      gmm_n_init=4)
    g = Gibbs(x, residue="A1", cutoff=7.0, cfg=cfg, root=str(tmp_path))
    g.run(mode=mode, device="cpu")
    assert g.device == torch.device("cpu")
    assert g.mcweights.shape == g.mcrates.shape == (2, 30, 3)
    assert not np.allclose(g.mcweights[0], g.mcweights[1])
    g.process_gibbs()
    lo, tau, hi = g.estimate_tau()
    assert np.isfinite([lo, tau, hi]).all() and lo <= hi
    assert Gibbs.load(g.save()).mcweights.shape == (2, 30, 3)


def test_gibbs_mode_refusals():
    g = Gibbs(_times(300, 1), residue="A1", cutoff=7.0)
    with pytest.raises(ValueError, match="unknown mode 'colapsed'"):
        g.run(mode="colapsed", device="cpu")
    with pytest.raises(ValueError, match="takes no engine"):
        g.run(mode="collapsed", engine="torch", device="cpu")


@pytest.fixture
def table(tmp_path):
    sizes = {10: 1500, 20: 600}
    resids = np.concatenate([np.full(n, r, np.int32)
                             for r, n in sizes.items()])
    dur = np.concatenate([_times(n, r) for r, n in sizes.items()])
    path = str(tmp_path / "contacts_7.0.npz")
    ContactEvents(resids, np.zeros_like(resids), np.zeros_like(dur), dur,
                  ContactMeta(cutoff=7.0)).save(path)
    return tmp_path, path


def test_cli_gibbs_collapsed_on_the_cpu(table, monkeypatch):
    d, path = table
    monkeypatch.chdir(d)
    cli.main(["gibbs", "--contacts", path, "--niter", "200", "--g", "10",
              "--ncomp", "3", "--nchains", "2", "--engine", "collapsed",
              "--device", "cpu"])
    for lab in ("X10", "X20"):
        g = Gibbs.load(str(d / "basicrta-7.0" / lab / "gibbs_200.npz"))
        assert g.mcweights.shape == (2, 20, 3)
        assert g.tau is not None and np.isfinite(g.tau).all()


def test_cli_gibbs_collapsed_refuses_without_a_card(table, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, path = table
    monkeypatch.chdir(d)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["gibbs", "--contacts", path, "--niter", "20", "--g", "10",
                  "--ncomp", "3", "--engine", "collapsed"])
    with pytest.raises(SystemExit):
        cli.main(["gibbs", "--contacts", path, "--engine", "xla"])
