"""basicrta_torch stands alone: every module imports with the JAX package,
JAX, matplotlib and scikit-learn blocked (the card's machine has none of
them), and its own GibbsConfig writes the JAX package's JSON, so artifacts
of either package load in the other."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

import basicrta_torch
from basicrta_tpu.config import GibbsConfig as JConfig
from basicrta_torch.config import GibbsConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        basicrta_torch.__path__, "basicrta_torch."))


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "basicrta_torch.scripts.abench" in mods
    assert "basicrta_torch.ops.diagnostics" in mods
    for new in ("contacts.distances", "contacts.events", "contacts.mapper",
                "contacts.quantize", "contacts.__main__", "io.amber",
                "io.gmxdump", "io.native", "io.topology", "io.universe",
                "scripts.contacts_reference", "scripts.workload",
                "io.dx", "kinetics.density", "kinetics.mapper",
                "kinetics.__main__", "plots", "protein.homologues", "gibbs",
                "cluster", "datafiles", "scripts.sbc", "scripts.validate",
                "scripts.reference_sampler", "parallel", "parallel.mesh",
                "parallel.distributed"):
        assert f"basicrta_torch.{new}" in mods
    code = ("import sys, importlib\n"
            "sys.modules['basicrta_tpu'] = None\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['matplotlib'] = None\n"
            "sys.modules['sklearn'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'basicrta_tpu', 'matplotlib', 'sklearn') "
            "and sys.modules[m]]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.parametrize("kw", [
    {}, dict(ncomp=10, niter=11000, g=100, burnin=1000, gmm_n_init=32),
    dict(ncomp=4, alpha=0.3, gamma_rate=2.5, n_chains=2, seed=7,
         weight_cut_events=5.0, gmm_tol=1e-4)])
def test_gibbs_config_json_equals_jax(kw):
    a, b = GibbsConfig(**kw), JConfig(**kw)
    assert a.to_json() == b.to_json()
    assert GibbsConfig.from_json(b.to_json()) == a
    assert JConfig.from_json(a.to_json()) == b
    for prop in ("n_samples", "burnin_samples", "alpha_eff"):
        assert getattr(a, prop) == getattr(b, prop)
    assert a.wcutoff(12345) == b.wcutoff(12345)
    assert list(json.loads(a.to_json())) == list(json.loads(b.to_json()))


def test_own_copies_equal_the_jax_package():
    """ops.surv and ops.diagnostics: the port's copies give the JAX
    package's numbers."""
    import numpy as np
    from basicrta_tpu.ops import diagnostics as jd
    from basicrta_tpu.ops import surv as js
    from basicrta_torch.ops import diagnostics as td
    from basicrta_torch.ops import surv as ts
    rng = np.random.default_rng(3)
    x = np.round(rng.exponential(2.0, 500), 1) + 0.1
    assert ts.infer_timestep(x) == js.infer_timestep(x)
    assert ts.infer_timestep(np.full(4, 0.3)) == js.infer_timestep(
        np.full(4, 0.3))
    assert ts.empirical_ci(x) == js.empirical_ci(x)
    tau = rng.uniform(1, 5, (6, 3))
    np.testing.assert_array_equal(ts.ci_bars(tau), js.ci_bars(tau))
    W = rng.dirichlet(np.ones(4), (2, 40))
    R = rng.uniform(0.1, 3.0, (2, 40, 4))
    a = td.convergence_report(W, R, burnin_samples=4, wcutoff=0.05)
    b = jd.convergence_report(W, R, burnin_samples=4, wcutoff=0.05)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="draws"):
        td.split_rhat(W[:, :3])


@pytest.mark.parametrize("kw", [{}, dict(map_cutoff=12.0, prefilter=False,
                                         upload_dtype="u16")])
def test_contact_config_fields_equal_jax(kw):
    import dataclasses
    from basicrta_tpu.config import ContactConfig as JContact
    from basicrta_torch.config import ContactConfig
    a, b = ContactConfig(**kw), JContact(**kw)
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_surv_helpers_equal_jax():
    import numpy as np
    from basicrta_tpu.ops import surv as js
    from basicrta_torch.ops import surv as ts
    for dt in (0.1, 0.25, 1.0, 10.0, 2e-3, 5):
        assert ts.decimals_of(dt) == js.decimals_of(dt)
    a = ts.simulate_hyperexp(500, [0.8, 0.2], [3.0, 0.1],
                             np.random.default_rng(4))
    b = js.simulate_hyperexp(500, [0.8, 0.2], [3.0, 0.1],
                             np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ts.discretize_times(a, 0.1),
                                  js.discretize_times(b, 0.1))
