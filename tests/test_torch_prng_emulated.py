"""The device-PRNG probe's kernel logic on the host: ``csrc/prng.cu``
compiled with g++ against ``tests/cuda_stub/cuda_runtime.h`` (a block as
std::threads, warp ballots and ``__syncwarp`` through the warp's barrier)
and launched through ``device_prng._launch`` on CPU tensors, for every
sampler, against the plain version: the uniform bitwise, the rest by the
card's rule (>= 99.9% of draws within rtol 1e-4), tile t bitwise the
one-tile launch at seed + 31 t, at 1, 3 and 5 tiles (5 divides neither the
emulated grid's tile groups nor its warps) and at 9 (more draws than the
emulated card's resident warps take at their least), at two seeds. The counters of
the stats build are held against the per-element trace.

The emulation runs the kernel's control flow, indexing and warp
bookkeeping; it says nothing about the card's compiler or its timing.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from basicrta_torch.sampler import cuda_sweep as cs
from basicrta_torch.scripts import device_prng as dp

HERE = os.path.dirname(os.path.abspath(__file__))
ROWS = 8   # rows a tile: 1,024 draws, so a few tiles cross warp slices
CASES = [("uniform", 0, 0, 0), ("binom_lgamma", 5000, 0.47, 0),
         ("binom_h4", 5000, 0.47, 0), ("binom_h4", 50, 0.3, 0),
         ("binom_lgamma", 16, 0.35, 0), ("binom_h4", 40, 0.9, 0),
         ("gamma", 0, 0, 3.7), ("gamma", 0, 0, 0.0667)]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The g++ stats build of prng.cu, bound like the card's library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    out = str(tmp_path_factory.mktemp("emu") / "libprng_emu.so")
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off",
           "-DBASICRTA_HOST_EMULATION", "-DBASICRTA_PRNG_STATS",
           "-x", "c++", "-I", os.path.join(HERE, "cuda_stub"),
           "-I", cs._CSRC, "-shared", "-fPIC", "-pthread", "-o", out,
           os.path.join(cs._CSRC, "prng.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return dp._bind(out)


def _draw(lib, kind, seed, n, p, a, tiles, stats=False):
    out = torch.full((tiles, dp.ROWS, 128), float("nan"))
    trace = torch.zeros(out.shape, dtype=torch.int32)
    counters = torch.zeros(len(dp.COUNTERS), dtype=torch.int64)
    rc = dp._launch(lib, out, kind, seed, n, p, a, tiles, None,
                    *((trace, counters) if stats else ()))
    assert rc == 0
    return out, trace, dict(zip(dp.COUNTERS, counters.tolist()))


@pytest.mark.parametrize("seed", [97, 2024])
@pytest.mark.parametrize("tiles", [1, 3, 5, 9])
@pytest.mark.parametrize("kind,n,p,a", CASES)
def test_emulated_draws_match_plain(emulated, monkeypatch, kind, n, p, a,
                                    tiles, seed):
    monkeypatch.setattr(dp, "ROWS", ROWS)
    got, trace, c = _draw(emulated, kind, seed, n, p, a, tiles, stats=True)
    plain = dp.draw_plain(kind, seed, n, p, a, tiles=tiles)
    plain = plain.reshape(got.shape)
    if kind == "uniform":
        assert torch.equal(got, plain)
    else:
        close = torch.isclose(got, plain, rtol=1e-4, atol=0)
        assert close.float().mean().item() >= 0.999
    # the launch without counters draws the same bits
    assert torch.equal(_draw(emulated, kind, seed, n, p, a, tiles)[0], got)
    for t in range(tiles):
        one = _draw(emulated, kind, seed + t * dp.SEED_STRIDE, n, p, a, 1)[0]
        assert torch.equal(got[t], one[0])
    # counters against the trace: every element drew, in 1..12 rounds
    rounds = trace & 0xFF
    slow = trace >> 8
    assert rounds.min().item() >= 1 and rounds.max().item() <= 12
    assert c["lane_rounds"] == rounds.sum().item()
    assert c["lane_rounds"] <= c["lane_slots"]
    assert c["slow_tests"] == sum(((slow >> b) & 1).sum().item()
                                  for b in range(12))
    assert c["slow_tests"] <= c["slow_slots"]
    if kind == "uniform" or (kind != "gamma" and n * min(p, 1 - p) <= 10):
        assert c["slow_tests"] == 0 and rounds.max().item() == 1


@pytest.mark.parametrize("kind,n,p,a", dp.TIMED)
def test_emulated_full_tile(emulated, kind, n, p, a):
    """One full (256, 128) tile of each timed sampler."""
    got, _, _ = _draw(emulated, kind, 5, n, p, a, 1)
    plain = dp.draw_plain(kind, 5, n, p, a)
    if kind == "uniform":
        assert torch.equal(got[0], plain)
    else:
        close = torch.isclose(got[0], plain, rtol=1e-4, atol=0)
        assert close.float().mean().item() >= 0.999


def test_layout_counts():
    """One thread per element: a warp of 32 columns issues its slowest
    lane's rounds and a slow test in each round any lane needs one."""
    rounds = np.ones((2, 1, 128), np.int32)
    slow = np.zeros((2, 1, 128), np.int32)
    rounds[0, 0, 5] = 3          # warp 0: 3 rounds, slow tests in 0 and 2
    slow[0, 0, 5] = 0b101
    slow[0, 0, 7] = 0b001
    rounds[1, 0, 100] = 12       # warp 7: 12 rounds, a slow test in the
    slow[1, 0, 100] = 1 << 11    # last
    trace = torch.tensor(rounds | (slow << 8))
    got = dp.layout_counts(trace)
    assert got == dict(lane_slots=32 * (3 + 12 + 6), lane_rounds=256 + 2 + 11,
                       slow_slots=32 * 3, slow_tests=4)
