"""Statistical validation of the sweep kernels' in-kernel samplers (K5).

Port of ``scripts/device_prng.py``: a tiny CUDA kernel (``csrc/prng.cu``)
writes raw draws of the samplers the sweep kernels run — the counter-hash
uniform, the exact binomial (CDF inversion where n p <= 10, BTRS
elsewhere) in the two BTRS forms the port runs (``True``: K1's lgamma
form; ``'btrd_nat_h4'``: K2/K3's production form) and the early-exit
Marsaglia-Tsang gamma of the conjugate draw — on a (256, 128) tile with
lane id 1 and the JAX package's call sites, and the scipy goodness-of-fit
battery runs on them with the reference's thresholds.

Each ``draw_*`` runs the plain version (``cuda_sweep._Rng`` /
``_binom_full`` / ``_gamma_mt``) for ``device='cpu'`` and launches the
kernel for a CUDA device; ``draw_kernel.launches`` counts launches.

Usage (on a machine with a CUDA device)::

    python -m basicrta_torch.scripts.device_prng
"""

from __future__ import annotations

import ctypes
import sys
from typing import List, Tuple

import numpy as np
import torch

from basicrta_torch.sampler import cuda_sweep as cs

ROWS = 256           # (ROWS, 128) tile per draw
_KINDS = {"uniform": 0, "binom_lgamma": 1, "binom_h4": 2, "gamma": 3}
# forms of the reference's battery that no port kernel draws
NOT_RUN = ("binom btrd", "binom btrd_sl", "binom btrd_nat",
           "gamma without early exit")
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cs.build_library(source="prng.cu"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.basicrta_prng_draws.argtypes = [p, i, i, i, f, f, f, p]
        lib.basicrta_prng_draws.restype = i
        _lib = lib
    return _lib


def _form(btrs_mode) -> str:
    if btrs_mode is True:
        return "binom_lgamma"
    if btrs_mode == "btrd_nat_h4":
        return "binom_h4"
    raise ValueError(f"BTRS form {btrs_mode!r} is not run by the port's "
                     "kernels; use True or 'btrd_nat_h4'")


def draw_plain(kind: str, seed: int, n: float = 0.0, p: float = 0.0,
               a: float = 0.0, device="cpu"):
    """The plain version: the (ROWS, 128) draws of ``kind`` from the
    sweep's plain samplers, element id row * 0x27D4EB2F + col."""
    device = torch.device(device)
    draw_plain.calls += 1
    rows = torch.arange(ROWS, device=device, dtype=torch.int64)[:, None]
    cols = torch.arange(cs._LANES, device=device, dtype=torch.int64)[None]
    fe = cs._murmur_fmix((rows * cs._ELEM_MUL + cols) & cs._M32)[None]
    rng = cs._Rng(int(seed), torch.ones(1, device=device,
                                        dtype=torch.int64))
    full = lambda x: torch.full(fe.shape, float(x), device=device)  # noqa
    if kind == "uniform":
        out = rng.uniform(fe)
    elif kind in ("binom_lgamma", "binom_h4"):
        out = cs._binom_full(rng, fe, full(n), full(p), kind == "binom_h4")
    elif kind == "gamma":
        out = cs._gamma_mt(rng, fe, full(a))
    else:
        raise ValueError(f"unknown draw kind {kind!r}")
    return out[0]


def draw_kernel(kind: str, seed: int, n: float = 0.0, p: float = 0.0,
                a: float = 0.0, device="cuda"):
    """K5: the same draws from the CUDA kernel; CPU devices run
    :func:`draw_plain`."""
    device = torch.device(device)
    if device.type == "cpu":
        return draw_plain(kind, seed, n, p, a, device)
    if kind not in _KINDS:
        raise ValueError(f"unknown draw kind {kind!r}")
    out = torch.empty((ROWS, cs._LANES), dtype=torch.float32, device=device)
    rc = _library().basicrta_prng_draws(
        out.data_ptr(), ROWS, _KINDS[kind], cs._int32(seed), float(n),
        float(p), float(a), torch.cuda.current_stream(device).cuda_stream)
    cs._raise_on(rc, "prng_draws")
    draw_kernel.launches += 1
    return out


draw_plain.calls = 0
draw_kernel.launches = 0


def draw_uniform(seed: int, device="cpu"):
    return draw_kernel("uniform", seed, device=device)


def draw_binom(seed: int, n: float, p: float, btrs_mode=True, device="cpu"):
    return draw_kernel(_form(btrs_mode), seed, n=n, p=p, device=device)


def draw_gamma(seed: int, a: float, device="cpu"):
    """The early-exit gamma (the conjugate draw's form)."""
    return draw_kernel("gamma", seed, a=a, device=device)


def collect(fn, reps: int, **kw) -> np.ndarray:
    return np.concatenate([fn(97 + 31 * s, **kw).cpu().numpy().ravel()
                           for s in range(reps)])


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


def main() -> int:
    if not torch.cuda.is_available():
        print("device_prng: no CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}; RNG path: counter "
          f"hash in csrc/prng.cu")
    failures, _ = run_battery("cuda")
    if failures:
        print(f"FAILED: {failures}")
        return 1
    print("device PRNG GOF battery: ALL PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
