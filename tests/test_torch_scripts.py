"""The port's scripts (``basicrta_torch.scripts``) against the JAX
package's root scripts, at toy sizes on the CPU (``--device cpu`` or
``device="cpu"``): ``calibrate_layout``'s refit on the same rows,
``layout_sweep``'s modelled cost of every variant, ``postbench`` and
``cbench`` on a few residues and frames, ``e2e_demo``'s planted system
byte for byte and its four stages, ``logerr_sim``'s output, and
``cpu_contacts_baseline``'s rows against ``MapContacts``. Each script
raises without a card unless asked for the CPU."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from basicrta_torch.ops.surv import discretize_times, simulate_hyperexp
from basicrta_torch.scripts import (calibrate_layout, cbench,
                                    cpu_contacts_baseline, e2e_demo,
                                    layout_sweep, postbench)
from basicrta_torch.scripts.workload import _membrane

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


def _jax_script(name):
    """The JAX package's root script ``scripts/<name>.py`` as a module."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _residues(n=12, seed=0):
    """A protein of ``n`` small residues (no 446,605-event flagship: the
    plain sweep on the CPU is slow), keyed 'R{i}'."""
    rng = np.random.default_rng(seed)
    sizes = (10 ** rng.uniform(1.7, 3.0, n)).astype(int)
    return {f"R{i}": discretize_times(simulate_hyperexp(
        int(s), [0.8, 0.2], [3.0 * rng.uniform(0.7, 1.5), 0.2], rng), 0.1)
        for i, s in enumerate(sizes)}


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


# ------------------------------------------------------- calibrate_layout
def _rows(seed=3):
    """Bucket rows of several layouts of a 60-residue protein, with
    per-sweep times from a known cost model plus noise."""
    from basicrta_torch.sampler import batch as bt
    rng = np.random.default_rng(seed)
    residues = _residues(60, seed)
    truth = np.array([20.0, 0.05, 0.9, 0.2, 0.3])
    rows = []
    for lay in ("mixed", "kmax4", "uniform", "pow2", "greedy"):
        for bi, b in enumerate(calibrate_layout._layout_batches(residues,
                                                                 lay)):
            Bph, SL, head, small, pack = calibrate_layout._bucket_geometry(b)
            NG, G = bt._phys_groups(Bph, SL, pack)
            lanes = NG * G
            feats = np.array([NG, lanes * SL, lanes * head,
                              lanes * (small - head), lanes * pack])
            rows.append({"layout": lay, "bucket": bi, "Bph": int(Bph),
                         "SL": int(SL), "head": int(head),
                         "small": int(small), "pack": int(pack),
                         "us_per_sweep": float(feats @ truth
                                               * rng.uniform(0.9, 1.1))})
    return rows


def test_calibrate_fit_only_equals_the_jax_script(tmp_path, capsys):
    rows = _rows()
    path = str(tmp_path / "rows.json")
    with open(path, "w") as f:
        json.dump(rows, f)
    jax_out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "calibrate_layout.py"),
         "--fit-only", "--json", path], capture_output=True, text=True,
        env=_env(), cwd=str(tmp_path), timeout=300)
    assert jax_out.returncode == 0, jax_out.stderr[-3000:]
    coef, r2 = calibrate_layout.main(["--fit-only", "--json", path])
    ours = capsys.readouterr().out
    assert ours.strip() == jax_out.stdout.strip()
    # to 1e-9 relative: the JAX package's features, the same NNLS
    from scipy.optimize import nnls

    from basicrta_tpu.sampler import batch as jbt
    A, y = [], []
    for r in rows:
        NG, G = jbt._phys_groups(r["Bph"], r["SL"], r["pack"])
        lanes = NG * G
        A.append([NG, lanes * r["SL"], lanes * r["head"],
                  lanes * (r["small"] - r["head"]), lanes * r["pack"]])
        y.append(r["us_per_sweep"])
    jcoef, _ = nnls(np.asarray(A, float), np.asarray(y))
    np.testing.assert_allclose(coef, jcoef, rtol=1e-9, atol=0)
    assert 0.9 < r2 <= 1.0
    # the constants themselves are untouched
    for name in calibrate_layout.COEF_NAMES:
        from basicrta_torch.sampler import batch as bt
        assert getattr(bt, name) == getattr(jbt, name)


def test_calibrate_geometry_equals_the_jax_script():
    """Every bucket's (Bph, SL, head, small, pack) is the JAX script's
    where its packed buckets are full (the port pads a partial last
    physical lane; the JAX script floors it)."""
    jcal = _jax_script("calibrate_layout")
    residues = _residues(40, 5)
    n = 0
    for lay in ("mixed", "uniform", "pow2", "greedy"):
        ours = calibrate_layout._layout_batches(residues, lay)
        theirs = jcal._layout_batches(residues, lay)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            if a.bounds is None and a.size % a.pack:
                continue
            assert calibrate_layout._bucket_geometry(a) == \
                jcal._bucket_geometry(b)
            n += 1
    assert n >= 4


def test_calibrate_measured_run_on_the_cpu(capsys):
    import torch
    rows = calibrate_layout.measure(_residues(12), ["mixed", "pow2"], 10,
                                    20, 1, torch.device("cpu"), g=10)
    assert {r["layout"] for r in rows} == {"mixed", "pow2"}
    assert all(np.isfinite(r["us_per_sweep"]) for r in rows)
    assert all(r["Bph"] >= 1 for r in rows)
    coef, r2 = calibrate_layout.report(rows)
    assert coef.shape == (5,) and np.all(coef >= 0)
    out = capsys.readouterr().out
    assert "bucket timings, R^2" in out and "_COST_LANE_LOG" in out


def test_every_script_raises_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for main, argv in ((calibrate_layout.main, ["--residues", "2"]),
                       (layout_sweep.main, []),
                       (postbench.main, []),
                       (cbench.main, ["--frames", "2"]),
                       (e2e_demo.main, ["--frames", "2", "--workdir",
                                        os.devnull + "_e2e"]),
                       (cpu_contacts_baseline.main, ["--parity"])):
        with pytest.raises(RuntimeError, match="CUDA device"):
            main(argv)


# ---------------------------------------------------------- layout_sweep
def test_layout_sweep_modeled_cost_equals_the_jax_script():
    jls = _jax_script("layout_sweep")
    residues = _residues(60, 9)
    for v in layout_sweep.VARIANTS:
        ours = layout_sweep.make_batches(residues, v)
        theirs = jls.make_batches(residues, v)
        assert [(b.names, b.pack) for b in ours] == \
            [(b.names, b.pack) for b in theirs], v
        assert layout_sweep.modeled_cost(ours) == pytest.approx(
            jls.modeled_cost(theirs), rel=1e-12), v
    # the swap of _dp_configs is undone
    from basicrta_torch.sampler import batch as bt
    assert bt._dp_configs is layout_sweep._ORIG_CFGS


def test_ext_classes_reaches_bucket_residues_through_the_global(
        monkeypatch):
    from basicrta_torch.sampler import batch as bt
    seen = []
    real = layout_sweep.ext_configs

    def spy(Vm):
        seen.append(Vm)
        return real(Vm)

    monkeypatch.setattr(layout_sweep, "ext_configs", spy)
    layout_sweep.make_batches(_residues(8), "ext_classes")
    assert seen and bt._dp_configs is layout_sweep._ORIG_CFGS


# ------------------------------------------------------------- postbench
def test_postbench_stage_split_on_the_cpu():
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.sampler.batch import bucket_residues, run_batch
    residues = _residues(5, 2)
    cfg = GibbsConfig(ncomp=5, niter=200, g=10)
    items = {}
    for b in bucket_residues(residues, ladder="pow2"):
        res = run_batch(b, cfg, device="cpu")
        for i, name in enumerate(b.names):
            live = b.counts[i] > 0
            items[name] = (res.mcweights[i][None], res.mcrates[i][None],
                           b.values[i][live], b.counts[i][live])
    pcfg = GibbsConfig(ncomp=5, niter=200, g=10, burnin=20, gmm_n_init=4)
    total, stages, same = postbench.bench(items, pcfg, 1, "cpu")
    assert same and total > 0
    assert set(stages) == {"host_prep_s", "gmm_s", "votes_s", "finish_s"}


# ---------------------------------------------------------------- cbench
def test_cbench_variants_agree_on_the_cpu():
    batches, r1, r2, A1 = _membrane(8, 4, 7, 20, 4, 12, 6,
                                    (30.0, 30.0, 30.0), 1000)
    lines = []
    fps = cbench.bench(batches, r1, r2, A1, 1, "cpu", out=lines.append)
    assert set(fps) == set(cbench.VARIANTS)
    assert all(x > 0 for xs in fps.values() for x in xs)
    assert lines[0].startswith("all variants agree")


# -------------------------------------------------------------- e2e_demo
def test_e2e_system_files_equal_the_jax_scripts(tmp_path):
    """The same seed writes the same .pdb and .xtc bytes, and the same
    .gro but its title line (the package's name)."""
    je2e = _jax_script("e2e_demo")
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    e2e_demo.make_system(str(ours), 9, 5, 60, 0.1,
                         np.random.default_rng(7))
    je2e.make_system(str(theirs), 9, 5, 60, 0.1, np.random.default_rng(7))
    import gc
    gc.collect()          # the JAX script leaves its writer to be closed
    for name in ("struct.pdb", "traj.xtc"):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    a = (ours / "top.gro").read_text().splitlines()
    b = (theirs / "top.gro").read_text().splitlines()
    assert a[0] == "basicrta_torch" and b[0] == "basicrta_tpu"
    assert a[1:] == b[1:]


def test_e2e_four_stages_on_the_cpu(tmp_path):
    lines = []
    seconds, planted, median = e2e_demo.run(
        str(tmp_path), frames=400, nprot=6, nlip=4, niter=1000,
        device="cpu", out=lines.append)
    assert set(seconds) == {"gen", "contacts", "gibbs", "cluster",
                            "kinetics"}
    assert planted == 5.0 and np.isfinite(median) and median > 0
    assert (tmp_path / "basicrta-7.0" / "W1" / "wcomp0_all.dx").exists()
    assert lines[-1].startswith("planted slowest tau 5.00 ns")


# ------------------------------------------------------------ logerr_sim
def test_logerr_sim_prints_the_jax_scripts_output():
    env = dict(_env(), PYTHONHASHSEED="123")
    args = ["--draws", "20000", "--n", "500"]
    jax_out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "logerr_sim.py")]
        + args, capture_output=True, text=True, env=env, timeout=300)
    ours = subprocess.run(
        [sys.executable, "-m", "basicrta_torch.scripts.logerr_sim"] + args,
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert ours.returncode == jax_out.returncode, ours.stderr[-2000:]
    assert ours.stdout == jax_out.stdout
    assert "[btrd+precise  ]" in ours.stdout


# ------------------------------------------------- cpu_contacts_baseline
def test_cpu_contacts_baseline_rows_equal_map_contacts():
    from basicrta_torch.config import ContactConfig
    from basicrta_torch.contacts.mapper import MapContacts
    from basicrta_torch.contacts.records import ContactMeta
    batches, r1, r2, A1 = _membrane(6, 3, 11, 15, 4, 10, 6,
                                    (30.0, 30.0, 30.0), 1000)
    rows = cpu_contacts_baseline.cpu_contacts(batches, r1, r2, A1)
    rec = MapContacts(indices1=np.arange(A1), resids1=r1,
                      indices2=np.arange(A1, A1 + len(r2)), resids2=r2,
                      cfg=ContactConfig(), meta=ContactMeta(ts=0.1),
                      device="cpu").run(batches)
    shared, lone, err = cpu_contacts_baseline.check_parity(rows, rec)
    assert shared == len(rec.frames) and lone == 0 and err < 1e-4
    np.testing.assert_array_equal(rows["frames"], rec.frames)
    np.testing.assert_array_equal(rows["s1"], rec.sel1_resids)
    np.testing.assert_array_equal(rows["s2"], rec.sel2_resids)
