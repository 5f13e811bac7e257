"""basicrta_torch's public surface against basicrta_tpu's: every name of
every ``__all__`` of the JAX package imports from the port's counterpart,
``chain_report`` and ``DensityConfig`` equal the JAX package's, the
deferred ``run_batch`` is bitwise the eager one (the JAX package's
``tests/test_aux.py`` cases), and ``process_residues_batched(timings=)``
fills the JAX package's four stage keys and changes no output."""

import ast
import glob
import importlib
import os

import numpy as np
import pytest

from basicrta_torch.config import GibbsConfig
from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small eager steps (the plain sweep): with torch's intra-op
    threads, each step waits for threads that the suite's other workers
    keep busy. One thread here, restored afterwards."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_all():
    """(module, names) of every ``__all__`` in basicrta_tpu, read from the
    source."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "basicrta_tpu", "**",
                                              "*.py"), recursive=True)):
        tree = ast.parse(open(path).read())
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "__all__"
                    for t in node.targets):
                rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
                out.append((rel.removesuffix(".__init__"),
                            ast.literal_eval(node.value)))
    return out


JAX_ALL = _jax_all()


def test_the_jax_package_has_these_lists():
    mods = dict(JAX_ALL)
    assert len(mods["basicrta_tpu.ops"]) == 12
    assert len(mods["basicrta_tpu.postprocess"]) == 11
    assert len(mods["basicrta_tpu.protein"]) == 2


@pytest.mark.parametrize("module,names", JAX_ALL,
                         ids=[m for m, _ in JAX_ALL])
def test_every_jax_name_imports_from_the_port(module, names):
    port = importlib.import_module(
        module.replace("basicrta_tpu", "basicrta_torch", 1))
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
    assert set(names) <= set(getattr(port, "__all__", names))


def test_frame_batch_from_the_mapper():
    from basicrta_torch.contacts.mapper import FrameBatch
    from basicrta_torch.contacts.records import FrameBatch as Records
    assert FrameBatch is Records


def test_chain_report_equals_jax():
    from basicrta_tpu.ops.diagnostics import chain_report as jreport
    from basicrta_torch.ops.diagnostics import chain_report
    rng = np.random.default_rng(6)
    W = rng.dirichlet(np.ones(5), (3, 50))
    R = rng.gamma(2.0, 1.0, (3, 50, 5))
    for burn in (0, 7):
        a, b = chain_report(W, R, burn), jreport(W, R, burn)
        assert a.keys() == b.keys() == {"rhat_weights", "rhat_rates",
                                        "ess_weights", "ess_rates"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", [{}, dict(xdim=30.0, delta=0.5, padding=1.0)])
def test_density_config_json_across_packages(kw):
    import dataclasses

    from basicrta_tpu.config import DensityConfig as JDensity
    from basicrta_torch.config import DensityConfig
    a, b = DensityConfig(**kw), JDensity(**kw)
    assert a.to_json() == b.to_json()
    assert DensityConfig.from_json(b.to_json()) == a
    assert JDensity.from_json(a.to_json()) == b
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# --------------------------------------------------- deferred transfers
def _x(n, w, r, ts, seed):
    return discretize_times(simulate_hyperexp(
        n, w, r, np.random.default_rng(seed)), ts)


def test_deferred_equals_eager():
    from basicrta_torch.sampler.batch import (_DeferredBatch, BatchResult,
                                              bucket_residues,
                                              finalize_batch, run_batch)
    x = _x(1200, [0.8, 0.2], [2.0, 0.1], 0.1, 1)
    batch = bucket_residues({"A1": x, "B2": x[:300]}, floor=256)[0]
    cfg = GibbsConfig(ncomp=4, niter=100, g=10, seed=3)
    eager = run_batch(batch, cfg, device="cpu")
    handle = run_batch(batch, cfg, device="cpu", defer_transfer=True)
    assert isinstance(handle, _DeferredBatch)
    assert handle.events == []               # no card, nothing to wait on
    deferred = finalize_batch(handle)
    assert isinstance(deferred, BatchResult)
    np.testing.assert_array_equal(eager.mcweights, deferred.mcweights)
    np.testing.assert_array_equal(eager.mcrates, deferred.mcrates)
    assert eager.names == deferred.names
    # finalize of an already-final result is the identity
    assert finalize_batch(eager) is eager


def test_run_residues_multibucket_deferred():
    """Residues in several buckets through run_residues: each residue's
    result is its own bucket's, run alone and deferred."""
    from basicrta_torch.sampler.batch import (bucket_residues,
                                              finalize_batch, run_batch,
                                              run_residues)
    times = {"A1": _x(400, [0.8, 0.2], [2.0, 0.1], 0.1, 2),
             "B2": _x(2000, [0.7, 0.3], [3.0, 0.2], 0.02, 3)}
    cfg = GibbsConfig(ncomp=4, niter=100, g=10, seed=5)
    out = run_residues(times, cfg, device="cpu")
    assert set(out) == {"A1", "B2"}
    assert len(bucket_residues({f"{n}#0": t for n, t in times.items()},
                               ladder="pow2")) == 2
    for name in out:
        W, R = out[name]
        assert W.shape == (1, 10, 4) and np.isfinite(W).all()
        solo = finalize_batch(run_batch(
            bucket_residues({f"{name}#0": times[name]}, ladder="pow2")[0],
            cfg, device="cpu", defer_transfer=True))
        np.testing.assert_array_equal(solo.mcweights[0], W[0])
        np.testing.assert_array_equal(solo.mcrates[0], R[0])


def test_run_residues_absorbs_the_defer_kwarg():
    from basicrta_torch.sampler.batch import run_residues
    x = _x(300, [0.8, 0.2], [2.0, 0.1], 0.1, 4)
    cfg = GibbsConfig(ncomp=3, niter=100, g=10)
    a = run_residues({"A1": x}, cfg, device="cpu", defer_transfer=False)
    b = run_residues({"A1": x}, cfg, device="cpu")
    np.testing.assert_array_equal(a["A1"][0], b["A1"][0])


# -------------------------------------------------------------- timings
def _items(n=6, seed=8):
    from basicrta_torch.sampler.kernels import dedup_times
    rng = np.random.default_rng(seed)
    K, S = 5, 40
    items = {}
    for i in range(n):
        x = discretize_times(simulate_hyperexp(
            int(rng.integers(200, 2000)), [0.7, 0.3],
            [rng.uniform(1, 3), rng.uniform(0.05, 0.3)], rng), 0.1)
        v, c = dedup_times(x)
        W = rng.dirichlet([6.0, 3.0, 0.5, 0.5, 0.5], (1, S))
        R = np.sort(rng.gamma(2.0, 1.0, (1, S, K)), -1)[..., ::-1]
        items[f"R{i}"] = (W, R, v, c)
    return items


def test_timings_fill_the_four_keys_and_change_nothing():
    from basicrta_torch.postprocess.batched import process_residues_batched
    from basicrta_torch.scripts.postbench import same_results
    cfg = GibbsConfig(ncomp=5, niter=400, g=10, burnin=50, gmm_n_init=6)
    items = _items()
    plain = process_residues_batched(items, cfg, device="cpu")
    t = {}
    timed = process_residues_batched(items, cfg, device="cpu", timings=t)
    assert set(t) == {"host_prep_s", "gmm_s", "votes_s", "finish_s"}
    assert all(v >= 0 for v in t.values())
    assert same_results(plain, timed)
    # a second call sums into the same dict
    before = dict(t)
    process_residues_batched(items, cfg, device="cpu", timings=t)
    assert all(t[k] >= before[k] for k in t)
    np.testing.assert_array_equal(plain["R0"].pindicator_values,
                                  timed["R0"].pindicator_values)


def test_timings_key_names_are_the_jax_packages():
    import inspect

    from basicrta_tpu.postprocess import batched as jb
    src = inspect.getsource(jb.process_residues_batched)
    for key in ("host_prep_s", "gmm_s", "votes_s", "finish_s"):
        assert f'"{key}"' in src
