"""The sweep kernels' logic on the host: ``csrc/sweep.cu`` compiled with
g++ against ``tests/cuda_stub/cuda_runtime.h`` (a block as std::threads,
``__syncthreads`` a barrier, warp shuffles through a shared array), and
the emulated K2 and K3 held against their plain versions at a tiny size
with the card run's agreement rule (every lane allclose at rtol 1e-4
after 2 sweeps) and bitwise resume.

The emulation runs the kernels' control flow, indexing, reduction order
and barriers; it says nothing about the card's compiler or its timing.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.sampler import batch, cuda_sweep as cs
from basicrta_torch.sampler.kernels import MixtureState, init_mixture_params

HERE = os.path.dirname(os.path.abspath(__file__))
K = 4


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The g++ build of sweep.cu, bound like the card's library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    out = str(tmp_path_factory.mktemp("emu") / "libsweep_emu.so")
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off",
           "-DBASICRTA_HOST_EMULATION", "-x", "c++",
           "-I", os.path.join(HERE, "cuda_stub"), "-I", cs._CSRC,
           "-shared", "-fPIC", "-pthread", "-o", out,
           os.path.join(cs._CSRC, "sweep.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return cs._bind(out)


def _lanes(B, V, tiers, seed):
    """(state, values, counts) of B lanes: head, small and singleton rows
    by ``tiers``, some padding at each lane's end."""
    rng = np.random.default_rng(seed)
    h, s = tiers
    vals = rng.uniform(0.1, 30.0, (B, V))
    cnts = np.concatenate([rng.integers(17, 4000, (B, 128 * h)),
                           rng.integers(2, 17, (B, 128 * (s - h))),
                           rng.integers(0, 2, (B, V - 128 * s))], 1)
    cnts[:, V - 40:] = 0
    vals[:, V - 40:] = 1.0
    st = init_mixture_params(K)
    return (MixtureState(st.weights.repeat(B, 1), st.rates.repeat(B, 1)),
            torch.tensor(vals, dtype=torch.float32),
            torch.tensor(cnts, dtype=torch.float32))


def _same(W, R, W2, R2):
    return (torch.isclose(W, W2, rtol=1e-4).flatten(1).all(1)
            & torch.isclose(R, R2, rtol=1e-4).flatten(1).all(1))


@pytest.mark.parametrize("tree", [False, True])
def test_emulated_segment_matches_plain_and_resumes(emulated, tree):
    tiers = (1, 2)
    st, v, c = _lanes(3, 384, tiers, 5)
    cfg = GibbsConfig(ncomp=K, niter=2, g=1)
    run = lambda off, s, nb: cs._launch_segment(  # noqa: E731
        emulated, None, 11, off, s.weights, s.rates, v, c, cfg, nb, tiers,
        tree)
    s2, W, R = run(0, st, 2)
    _, W2, R2 = cs.segment_torch(11, 0, st, v, c, cfg, 2, tiers, tree)
    assert _same(W, R, W2, R2).all()
    s1, Wa, Ra = run(0, st, 1)
    s1, Wb, Rb = run(1, s1, 1)
    assert torch.equal(torch.cat([Wa, Wb], 1), W)
    assert torch.equal(torch.cat([Ra, Rb], 1), R)
    assert torch.equal(s1.weights, s2.weights)
    assert torch.equal(s1.rates, s2.rates)


def _mixed_pack3():
    """A mixed-width pack-3 bucket as the kernel takes it: two physical
    lanes of 3 rows, slot widths (50, 40, 30) and (60, -, 45), the second
    lane's middle slot empty; (values, counts, row tiers, slot tile)."""
    rng = np.random.default_rng(3)
    widths = np.array([[50, 40, 30], [60, 0, 45]])
    SL, V = 3, 180
    vals = np.ones((5, V), np.float32)
    cnts = np.zeros((5, V), np.float32)
    for i, w in enumerate(widths[widths > 0]):
        n = SL * w - rng.integers(0, 20)
        vals[i, :n] = rng.uniform(0.1, 30.0, n)
        cnts[i, :n] = np.sort(np.concatenate([
            rng.integers(17, 4000, w // 2), rng.integers(2, 17, w),
            rng.integers(1, 2, n - w - w // 2)]))[::-1]
    v_ph, c_ph, seg_id, _ = batch._pack_mixed(vals, cnts, widths, SL)
    return (v_ph.reshape(2, -1), c_ph.reshape(2, -1),
            batch._mixed_row_tiers(c_ph), seg_id)


@pytest.mark.parametrize("tree", [False, True])
def test_emulated_packed_matches_plain_and_resumes(emulated, tree):
    vals, cnts, tiers, seg_id = _mixed_pack3()
    assert tiers[0] >= 1 and tiers[1] > tiers[0]
    st0 = init_mixture_params(K)
    st = MixtureState(st0.weights.repeat(6, 1), st0.rates.repeat(6, 1))
    cfg = GibbsConfig(ncomp=K, niter=2, g=1)
    seg = torch.tensor(seg_id)
    v, c, slot = cs._packed_operands(st, torch.tensor(vals),
                                     torch.tensor(cnts), K, tiers, 3, seg)
    run = lambda off, s, nb: cs._launch_packed(  # noqa: E731
        emulated, None, 11, off, s.weights, s.rates, v, c,
        cs.checked_ranges(slot, c, 3), cfg, nb, tiers, 3, tree)
    s2, W, R = run(0, st, 2)
    _, W2, R2 = cs.segment_packed_torch(11, 0, st, v, c, cfg, 2, tiers, 3,
                                        seg, tree)
    assert _same(W, R, W2, R2).all()     # empty slots too
    s1, Wa, Ra = run(0, st, 1)
    s1, Wb, Rb = run(1, s1, 1)
    assert torch.equal(torch.cat([Wa, Wb], 1), W)
    assert torch.equal(torch.cat([Ra, Rb], 1), R)
    assert torch.equal(s1.weights, s2.weights)


def test_emulated_uniform_pack2_two_turns(emulated):
    """Uniform pack 2 over 11 physical rows on 1,024 threads: a second
    turn, backwards, for the last three block rows."""
    tiers = (1, 2)
    st, v, c = _lanes(2, 11 * 64, (0, 0), 8)
    rng = np.random.default_rng(12)
    c[:, :64] = torch.tensor(rng.integers(17, 900, (2, 64))).float()
    c[:, 64:128] = torch.tensor(rng.integers(2, 17, (2, 64))).float()
    cfg = GibbsConfig(ncomp=K, niter=2, g=1)
    pv, pc, slot = cs._packed_operands(st, v, c, K, tiers, 2, None)
    assert cs.block_threads(11) == 1024
    _, W, R = cs._launch_packed(emulated, None, 7, 0, st.weights, st.rates,
                                pv, pc, cs.checked_ranges(slot, pc, 2), cfg,
                                2, tiers, 2, False)
    _, W2, R2 = cs.segment_packed_torch(7, 0, st, v, c, cfg, 2, tiers, 2)
    assert _same(W, R, W2, R2).all()


def test_emulated_sweep_stats_exact_totals(emulated):
    tiers = (1, 2)
    st, v, c = _lanes(2, 384, tiers, 6)
    ns = torch.empty((2, K))
    ts = torch.empty((2, K))
    for tree in (False, True):
        rc = emulated.basicrta_sweep_stats(
            st.weights.data_ptr(), st.rates.data_ptr(), v.data_ptr(),
            c.data_ptr(), ns.data_ptr(), ts.data_ptr(), 2, 384, K, *tiers,
            cs.group_size(2, 384, K + 3), 11, int(tree),
            cs.block_threads(3, tree), None)
        assert rc == 0
        pn, pt = cs.sweep_stats_torch(11, st, v, c, K, tiers, tree)
        assert torch.equal(ns.sum(1), c.sum(1))
        assert torch.equal(ns, pn)
        torch.testing.assert_close(ts, pt, rtol=1e-5, atol=1e-3)
