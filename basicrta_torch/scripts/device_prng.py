"""Statistical validation of the sweep kernels' in-kernel samplers (K5).

Port of ``scripts/device_prng.py``: a tiny CUDA kernel (``csrc/prng.cu``)
writes raw draws of the samplers the sweep kernels run — the counter-hash
uniform, the exact binomial (CDF inversion where n p <= 10, BTRS
elsewhere) in the two BTRS forms the port runs (``True``: K1's lgamma
form; ``'btrd_nat_h4'``: K2/K3's production form) and the early-exit
Marsaglia-Tsang gamma of the conjugate draw — on a (256, 128) tile with
lane id 1 and the JAX package's call sites, and the scipy goodness-of-fit
battery runs on them with the reference's thresholds.

Each ``draw_*`` launches the kernel on the card, its default, and runs the
plain version (``cuda_sweep._Rng`` / ``_binom_full`` / ``_gamma_mt``) only
for ``device='cpu'``; without a CUDA device a launch raises.
``draw_kernel.launches`` counts launches. One
launch draws ``tiles`` tiles, tile t with seed ``seed + t * SEED_STRIDE``:
its bits are those of a one-tile launch at that seed, so the battery draws
each sampler's whole sample in one launch without changing a draw.

One tile costs a launch and says nothing of the kernel; :func:`time_draws`
times it over ``TIMING_TILES`` tiles (512 MiB of output) by CUDA events,
beside its bound (``roofline.prng_bound``) and the one PyTorch call that
draws the same law at the same size.

Usage (on a machine with a CUDA device)::

    python -m basicrta_torch.scripts.device_prng [--stats] [--time-only]

``--stats`` adds each timed sampler's counters from a
``-DBASICRTA_PRNG_STATS`` build (:func:`draw_stats`).
"""

from __future__ import annotations

import ctypes
import sys
from typing import List, Tuple

import numpy as np
import torch

from basicrta_torch.sampler import cuda_sweep as cs

ROWS = 256           # (ROWS, 128) tile per draw
SEED_STRIDE = 31     # tile t of a launch draws with seed + 31 t
TIMING_TILES = 4096  # tiles of a timed launch: 512 MiB of f32 draws
_PLAIN_CHUNK = 128   # tiles the plain version draws at a time
# (kind, n, p, a) of the timed samplers
TIMED = (("uniform", 0.0, 0.0, 0.0), ("binom_lgamma", 5000.0, 0.47, 0.0),
         ("binom_h4", 5000.0, 0.47, 0.0), ("gamma", 0.0, 0.0, 3.7))
_KINDS = {"uniform": 0, "binom_lgamma": 1, "binom_h4": 2, "gamma": 3}
# forms of the reference's battery that no port kernel draws
NOT_RUN = ("binom btrd", "binom btrd_sl", "binom btrd_nat",
           "gamma without early exit")
# counters of the stats build (csrc/prng.cu Counter), per launch; cycles
# are sums over warps
COUNTERS = ("lane_slots", "lane_rounds", "slow_slots", "slow_tests",
            "warp_cycles", "round_cycles", "drain_cycles")
_STATS = "BASICRTA_PRNG_STATS"
_BTRS_ROUNDS = 12    # kBtrsRounds: a trace's slow-test bits, one a round
_libs = {}


def _bind(path: str):
    """Load a build of ``prng.cu`` and declare its entry points."""
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.basicrta_prng_draws.argtypes = [p, i, i, i, i, i, f, f, f, p]
    lib.basicrta_prng_draws.restype = i
    if hasattr(lib, "basicrta_prng_draws_stats"):
        lib.basicrta_prng_draws_stats.argtypes = [p, p, p, i, i, i, i, i, f,
                                                  f, f, p]
        lib.basicrta_prng_draws_stats.restype = i
    return lib


def _library(stats: bool = False):
    if stats not in _libs:
        _libs[stats] = _bind(cs.build_library(
            source="prng.cu", defines=(_STATS,) if stats else ()))
    return _libs[stats]


def _launch(lib, out, kind, seed, n, p, a, tiles, stream, trace=None,
            counters=None) -> int:
    """One launch of ``lib``'s K5 into ``out`` (ROWS x 128 x ``tiles``
    draws); with ``trace`` and ``counters``, the stats entry point."""
    args = (ROWS, int(tiles), _KINDS[kind], cs._int32(seed), SEED_STRIDE,
            float(n), float(p), float(a), stream)
    if trace is None:
        return lib.basicrta_prng_draws(out.data_ptr(), *args)
    return lib.basicrta_prng_draws_stats(out.data_ptr(), trace.data_ptr(),
                                         counters.data_ptr(), *args)


def _form(btrs_mode) -> str:
    if btrs_mode is True:
        return "binom_lgamma"
    if btrs_mode == "btrd_nat_h4":
        return "binom_h4"
    raise ValueError(f"BTRS form {btrs_mode!r} is not run by the port's "
                     "kernels; use True or 'btrd_nat_h4'")


def _plain_tiles(kind, seeds, n, p, a, device):
    """(len(seeds), ROWS, 128) plain draws, tile t seeded ``seeds[t]``:
    the per-lane hash state of ``cuda_sweep._Rng`` carries one seed a
    tile."""
    T = len(seeds)
    rows = torch.arange(ROWS, device=device, dtype=torch.int64)[:, None]
    cols = torch.arange(cs._LANES, device=device, dtype=torch.int64)[None]
    fe = cs._murmur_fmix((rows * cs._ELEM_MUL + cols) & cs._M32)
    fe = fe[None].expand(T, ROWS, cs._LANES)
    rng = cs._Rng(0, torch.ones(T, device=device, dtype=torch.int64))
    seeds = torch.as_tensor(seeds, device=device, dtype=torch.int64)
    rng.h0 = (((seeds & cs._M32) * 0x9E3779B9) & cs._M32) ^ 0x85EBCA6B
    full = lambda x: torch.full(fe.shape, float(x), device=device)  # noqa
    if kind == "uniform":
        return rng.uniform(fe)
    if kind in ("binom_lgamma", "binom_h4"):
        return cs._binom_full(rng, fe, full(n), full(p), kind == "binom_h4")
    if kind == "gamma":
        return cs._gamma_mt(rng, fe, full(a))
    raise ValueError(f"unknown draw kind {kind!r}")


def draw_plain(kind: str, seed: int, n: float = 0.0, p: float = 0.0,
               a: float = 0.0, device="cpu", tiles: int = 1):
    """The plain version: ``tiles`` (ROWS, 128) tiles of draws of ``kind``
    from the sweep's plain samplers, element id row * 0x27D4EB2F + col,
    tile t seeded ``seed + t * SEED_STRIDE``. One tile comes back as
    (ROWS, 128), several as (tiles, ROWS, 128)."""
    device = torch.device(device)
    draw_plain.calls += 1
    seeds = [int(seed) + t * SEED_STRIDE for t in range(tiles)]
    out = torch.cat([_plain_tiles(kind, seeds[lo:lo + _PLAIN_CHUNK], n, p, a,
                                  device)
                     for lo in range(0, tiles, _PLAIN_CHUNK)])
    return out[0] if tiles == 1 else out


def draw_kernel(kind: str, seed: int, n: float = 0.0, p: float = 0.0,
                a: float = 0.0, device="cuda", tiles: int = 1, out=None):
    """K5: the same draws from one launch of the CUDA kernel (into ``out``
    when given); CPU devices run :func:`draw_plain`."""
    device = torch.device(device)
    if device.type == "cpu":
        return draw_plain(kind, seed, n, p, a, device, tiles)
    if kind not in _KINDS:
        raise ValueError(f"unknown draw kind {kind!r}")
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"K5 launches on a CUDA device; got {device} "
                           f"(cuda available: {torch.cuda.is_available()}); "
                           "pass device='cpu' for the plain version")
    shape = (ROWS, cs._LANES) if tiles == 1 else (tiles, ROWS, cs._LANES)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=device)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32
          or not out.is_contiguous() or out.device.type != "cuda"
          or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous, 16-byte aligned "
                         f"float32 CUDA tensor of shape {shape}")
    rc = _launch(_library(), out, kind, seed, n, p, a, tiles,
                 torch.cuda.current_stream(device).cuda_stream)
    cs._raise_on(rc, "prng_draws")
    draw_kernel.launches += 1
    return out


draw_plain.calls = 0
draw_kernel.launches = 0


def layout_counts(trace: torch.Tensor) -> dict:
    """The counters of one thread per element (K5 before its redesign)
    from a stats launch's per-element trace (rounds | slow-test rounds <<
    8): a warp of 32 columns of a row issues the rounds of its slowest
    lane, and its slow test in every round some lane needs it. These are
    modelled from the trace, not counted on the old kernel."""
    rounds = (trace & 0xFF).reshape(-1, 32)
    slow = (trace >> 8).reshape(-1, 32)
    slow_slots = slow_tests = 0
    for b in range(_BTRS_ROUNDS):  # one bit plane at a time
        bit = (slow >> b) & 1
        slow_slots += 32 * bit.amax(1).sum().item()
        slow_tests += bit.sum().item()
    return dict(lane_slots=32 * rounds.amax(1).sum().item(),
                lane_rounds=rounds.sum().item(),
                slow_slots=slow_slots, slow_tests=slow_tests)


def draw_stats(kind: str, seed: int, n: float = 0.0, p: float = 0.0,
               a: float = 0.0, device="cuda", tiles: int = 1):
    """K5's stats build on the card: the draws ((tiles, ROWS, 128)), the
    launch's counters (:data:`COUNTERS`: lane-round slots the warps issued,
    lane-rounds that drew, slow-test slots, slow tests, clock64() cycles
    summed over warps) and the same counts for one thread per element
    (:func:`layout_counts`)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("K5's counters come from a CUDA device")
    shape = (tiles, ROWS, cs._LANES)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    trace = torch.zeros(shape, dtype=torch.int32, device=device)
    counters = torch.zeros(len(COUNTERS), dtype=torch.int64, device=device)
    rc = _launch(_library(stats=True), out, kind, seed, n, p, a, tiles,
                 torch.cuda.current_stream(device).cuda_stream, trace,
                 counters)
    cs._raise_on(rc, "prng_draws_stats")
    return (out, dict(zip(COUNTERS, counters.tolist())),
            layout_counts(trace))


def draw_uniform(seed: int, device="cuda", tiles: int = 1):
    return draw_kernel("uniform", seed, device=device, tiles=tiles)


def draw_binom(seed: int, n: float, p: float, btrs_mode=True, device="cuda",
               tiles: int = 1):
    return draw_kernel(_form(btrs_mode), seed, n=n, p=p, device=device,
                       tiles=tiles)


def draw_gamma(seed: int, a: float, device="cuda", tiles: int = 1):
    """The early-exit gamma (the conjugate draw's form)."""
    return draw_kernel("gamma", seed, a=a, device=device, tiles=tiles)


def collect(fn, reps: int, **kw) -> np.ndarray:
    """``reps`` tiles of ``fn``'s draws in one launch: seeds 97, 128, ...,
    tile after tile."""
    return fn(97, tiles=reps, **kw).cpu().numpy().ravel()


def _event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, by CUDA
    events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_draws(device="cuda", tiles: int = TIMING_TILES, reps: int = 20):
    """Each timed sampler's milliseconds on the card: one launch over
    ``tiles`` tiles (``ms``), one tile (``launch_ms``: the launch's time,
    not the kernel's), and the one PyTorch call that draws the same law at
    the many-tile size (``library``, ``library_ms``). {kind: dict}."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("timing the PRNG kernel needs a CUDA device")
    shape = (tiles, ROWS, cs._LANES)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    report = {}
    for kind, n, p, a in TIMED:
        ms = _event_ms(lambda: draw_kernel(kind, 97, n, p, a, device, tiles,
                                           out=out), reps)
        launch_ms = _event_ms(lambda: draw_kernel(kind, 97, n, p, a, device),
                              reps)
        if kind == "uniform":
            name, call = "torch.rand", lambda: torch.rand(shape, out=out)
        elif kind == "gamma":
            alpha = torch.full(shape, a, device=device)
            name, call = "torch._standard_gamma", \
                lambda: torch._standard_gamma(alpha)
        else:
            count = torch.full(shape, n, device=device)
            prob = torch.full(shape, p, device=device)
            name, call = "torch.binomial", lambda: torch.binomial(count, prob)
        report[kind] = dict(n=n, p=p, a=a, tiles=tiles,
                            draws=tiles * ROWS * cs._LANES, ms=ms,
                            launch_ms=launch_ms, library=name,
                            library_ms=_event_ms(call, reps))
        del call
    return report


def _censored_ks(x, a):
    """KS above a 1e-25 floor plus the floor's mass z-score: Gamma(a << 1)
    has real mass below f32's smallest normals, which the kernel clamps to
    1e-30 by design."""
    from scipy import stats
    t0 = 1e-25
    p_below = stats.gamma.cdf(t0, a)
    zb = ((np.mean(x <= t0) - p_below)
          / np.sqrt(p_below * (1 - p_below) / len(x)))
    ks = stats.kstest(x[x > t0], lambda v: ((stats.gamma.cdf(v, a) - p_below)
                                            / (1.0 - p_below)))
    return ks.pvalue, zb


def run_battery(device="cuda", out=print) -> Tuple[List[str], List[str]]:
    """The GOF battery on ``device``'s draws, with the reference's
    thresholds. Returns (failures, forms not run)."""
    from scipy import stats
    failures = []
    u = collect(draw_uniform, 32, device=device)        # 1M draws
    ks = stats.kstest(u, "uniform")
    mean_z = (u.mean() - 0.5) / (np.sqrt(1 / 12) / np.sqrt(len(u)))
    r1 = np.corrcoef(u[:-1], u[1:])[0, 1]
    out(f"[uniform] n={len(u)} KS p={ks.pvalue:.3g} mean_z={mean_z:.2f} "
        f"lag1_corr={r1:.2e}")
    if ks.pvalue < 1e-3 or abs(mean_z) > 5 or abs(r1) > 5 / np.sqrt(len(u)):
        failures.append("uniform")

    # inversion (n p <= 10), BTRS (n p = 15, 2350) and the symmetry fold,
    # each under both BTRS forms the port runs
    for n, p in [(16, 0.35), (100, 0.02), (50, 0.3), (5000, 0.47),
                 (40, 0.9)]:
        for mode in (True, "btrd_nat_h4"):
            x = collect(draw_binom, 4, n=n, p=p, btrs_mode=mode,
                        device=device)
            kmax = int(x.max())
            obs = np.bincount(x.astype(int), minlength=kmax + 1)
            exp = stats.binom.pmf(np.arange(kmax + 1), n, p) * len(x)
            keep = exp >= 5
            obs_p = np.concatenate([obs[keep], [obs[~keep].sum()]])
            exp_p = np.concatenate([exp[keep], [len(x) - exp[keep].sum()]])
            sel = exp_p > 0
            chi2 = ((obs_p[sel] - exp_p[sel]) ** 2 / exp_p[sel]).sum()
            pval = stats.chi2.sf(chi2, max(sel.sum() - 1, 1))
            mz = (x.mean() - n * p) / (np.sqrt(n * p * (1 - p))
                                       / np.sqrt(len(x)))
            tag = "" if mode is True else f" {mode}"
            out(f"[binom n={n} p={p}{tag}] n={len(x)} chi2 p={pval:.3g} "
                f"mean_z={mz:.2f}")
            if pval < 1e-4 or abs(mz) > 5:
                failures.append(f"binom({n},{p}{tag})")

    for a in [0.0667, 1.0, 3.7, 500.0]:   # 1/15 = the Dirichlet prior
        x = collect(draw_gamma, 4, a=a, device=device)
        mz = (x.mean() - a) / (np.sqrt(a) / np.sqrt(len(x)))
        if a < 1.0:
            pks, zb = _censored_ks(x, a)
            out(f"[gamma a={a} early-exit] n={len(x)} censored-KS p="
                f"{pks:.3g} below-floor z={zb:.2f} mean_z={mz:.2f}")
            bad = pks < 1e-3 or abs(zb) > 5
        else:
            pks = stats.kstest(x, "gamma", args=(a,)).pvalue
            out(f"[gamma a={a} early-exit] n={len(x)} KS p={pks:.3g} "
                f"mean_z={mz:.2f}")
            bad = pks < 1e-3
        if bad or abs(mz) > 5:
            failures.append(f"gamma_ee({a})")
    out(f"not run (no port kernel draws them): {', '.join(NOT_RUN)}")
    return failures, list(NOT_RUN)


def stats_report(tiles: int = TIMING_TILES, device="cuda") -> dict:
    """Each timed sampler's counters over ``tiles`` tiles, the kernel's and
    one thread per element's, with the ratios a design is read by: slots a
    draw, the share of lane slots that drew, the share of slow-test slots
    whose lane needed the test, and the kernel's cycles a warp round and a
    slow-test batch. {kind: {layout: counts}}."""
    report = {}
    for kind, n, p, a in TIMED:
        out, new, old = draw_stats(kind, 97, n, p, a, device, tiles)
        draws = out.numel()
        del out
        for c in (new, old):
            c["slots_a_draw"] = c["lane_slots"] / draws
            c["rounds_a_draw"] = c["lane_rounds"] / draws
            c["lane_use"] = c["lane_rounds"] / c["lane_slots"]
            c["slow_use"] = (c["slow_tests"] / c["slow_slots"]
                             if c["slow_slots"] else None)
        if new["warp_cycles"]:
            # a warp round (refill and one round) and a batch of queued
            # slow tests in cycles, and the warps' share of their time in
            # each
            new["cycles_a_round"] = (32 * new["round_cycles"]
                                     / new["lane_slots"])
            new["cycles_a_slow_batch"] = (32 * new["drain_cycles"]
                                          / new["slow_slots"]
                                          if new["slow_slots"] else None)
            for part in ("round", "drain"):
                new[f"{part}_share"] = (new[f"{part}_cycles"]
                                        / new["warp_cycles"])
        report[kind] = {"kernel": new, "one_thread_per_element": old}
    return report


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stats", action="store_true",
                    help="print each timed sampler's counters (a "
                         f"-D{_STATS} build) beside those of one thread "
                         "per element")
    ap.add_argument("--time-only", action="store_true",
                    help="skip the battery")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("device_prng: no CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}; RNG path: counter "
          f"hash in csrc/prng.cu")
    if not args.time_only:
        failures, _ = run_battery("cuda")
        if failures:
            print(f"FAILED: {failures}")
            return 1
        print("device PRNG GOF battery: ALL PASS")
    from basicrta_torch.scripts import roofline as rf
    ceiling = rf.transcendental_ceiling()
    for kind, r in time_draws().items():
        bound_ms, by, per_draw = rf.prng_bound(kind, r["draws"], ceiling,
                                               r["n"], r["p"], r["a"])
        print(f"[time {kind}] {r['tiles']} tiles: {r['ms']:.4f} ms a launch "
              f"({r['launch_ms']:.4f} ms for one tile: the launch's time); "
              f"bound {bound_ms:.4f} ms by {by} ({per_draw:.3f} "
              f"transcendentals a draw at one round, ceiling {ceiling:.4g} "
              f"/s) = {100 * bound_ms / r['ms']:.1f}% of the bound's rate; "
              f"{r['library']} {r['library_ms']:.4f} ms")
    if args.stats:
        for kind, layouts in stats_report().items():
            print(f"[stats {kind}] {json.dumps(layouts)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
