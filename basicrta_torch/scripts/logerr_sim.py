#!/usr/bin/env python
"""Error-injection study: which BTRS accept-test forms tolerate the TPU's
native-log error?

Port of the JAX package's ``scripts/logerr_sim.py``, pure numpy and scipy,
with the error model carried over as it is. The model is the TPU's: the
VPU's native log carries ~7e-5 RELATIVE error, quasi-random in the
argument (measured on v5e by the JAX package). It is no model of the
H100: on the card the precise log sites of the sweep kernels call
``logf``, never the approximate ``__logf``, so this study says which
accept-test form the JAX package's kernels may take, and why the port's
precise sites stay precise. It re-runs the BTRS acceptance test in numpy
with that error model injected into chosen log call sites and runs the
chi-square/mean-z battery, for three forms:

- lgamma+native: Stirling's (x-1/2) log x term is amplified by the count
  n, giving a large-n mean bias (z = +23 measured on the TPU at n=5000,
  p=0.47).
- btrd+precise: BTRD regrouping, ratio logs exact.
- btrd+native: BTRD with the error model on the ratio logs. Its amplified
  terms take near-unity ratio arguments, so the injected relative error
  stays small in ABSOLUTE terms at marginal accept decisions.

The injected h(x) in [-1, 1] is a hash of the f32 bit pattern: a
deterministic, argument-quasi-random worst-case-magnitude model (the
real unit's error is smoother, so passing here is conservative in
magnitude, though no substitute for an on-device goodness-of-fit
battery such as ``basicrta_torch.scripts.device_prng``'s).

Each form's draws are seeded from ``hash(name) & 0xFFFF``; Python salts
``str`` hashes per process, so set ``PYTHONHASHSEED`` to repeat a run.

Usage: python -m basicrta_torch.scripts.logerr_sim [--n 5000] [--p 0.47]
    [--draws 2000000]
"""

import argparse
import sys

import numpy as np
from scipy import stats
from scipy.special import gammaln

REL = 7e-5


def _h(x):
    """Deterministic quasi-random in [-1, 1] from the f32 bit pattern."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits ^= bits >> np.uint64(16)
    bits *= np.uint64(0x45D9F3B)
    bits ^= bits >> np.uint64(16)
    bits *= np.uint64(0x45D9F3B)
    bits ^= bits >> np.uint64(16)
    return (bits & np.uint64(0xFFFFFF)).astype(np.float64) \
        / float(0x7FFFFF) - 1.0


def native_log(x):
    """log with the TPU native-unit error model: exact * (1 + REL*h)."""
    lx = np.log(x)
    return lx * (1.0 + REL * _h(x))


def stirling_tail(x):
    w = x + 1.0
    t = gammaln(x + 1) - ((x + 0.5) * np.log(w) - w
                          + 0.5 * np.log(2 * np.pi))
    return t


def btrs(n, p, size, accept, seed=0):
    """Vectorized BTRS with a pluggable accept test; exact rejection."""
    rng = np.random.default_rng(seed)
    q = 1.0 - p
    spq = np.sqrt(n * p * q)
    b = 1.15 + 2.53 * spq
    a = -0.0873 + 0.0248 * b + 0.01 * p
    c = n * p + 0.5
    vr = 0.92 - 4.2 / b
    alpha = (2.83 + 5.1 / b) * spq
    out = np.empty(size)
    done = np.zeros(size, bool)
    while not done.all():
        m = (~done).sum()
        u = rng.uniform(size=m) - 0.5
        v = rng.uniform(size=m)
        us = 0.5 - np.abs(u)
        k = np.floor((2.0 * a / us + b) * u + c)
        in_range = (k >= 0) & (k <= n)
        fast = (us >= 0.07) & (v <= vr)
        vv = np.log(np.maximum(v * alpha / (a / (us * us) + b), 1e-300))
        # clip into the valid domain: out-of-range k is gated by in_range
        # below, exactly as the kernel gates it (silences log(0) noise)
        slow = vv <= accept(np.clip(k, 0.0, n))
        ok = in_range & (fast | slow)
        idx = np.flatnonzero(~done)[ok]
        out[idx] = k[ok]
        done[idx] = True
    return out


def make_accepts(n, p):
    q = 1.0 - p
    r = p / q
    m = np.floor((n + 1.0) * p)
    nm = n - m + 1.0

    # native log inside the n-amplified Stirling term
    def lgamma_native(k):
        def lg(x):
            w = np.asarray(x, np.float64)
            inv = 1.0 / w
            series = inv * (1 / 12 - inv ** 2 * (1 / 360 - inv ** 2 / 1260))
            return ((w - 0.5) * native_log(w) - w
                    + 0.9189385332046727 + series)
        h = lg(m + 1.0) + lg(n - m + 1.0)
        return (h - lg(k + 1.0) - lg(n - k + 1.0)
                + (k - m) * np.log(r))

    hb = ((m + 0.5) * np.log((m + 1.0) / (r * nm))
          + stirling_tail(m) + stirling_tail(n - m))

    def btrd(logf):
        def accept(k):
            nk = n - k + 1.0
            return (hb + (n + 1.0) * logf(nm / nk)
                    + (k + 0.5) * logf(nk * r / (k + 1.0))
                    - stirling_tail(k) - stirling_tail(n - k))
        return accept

    return {"lgamma+native": lgamma_native,
            "btrd+precise": btrd(np.log),
            "btrd+native": btrd(native_log)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--p", type=float, default=0.47)
    ap.add_argument("--draws", type=int, default=2_000_000)
    args = ap.parse_args()
    n, p, size = float(args.n), args.p, args.draws

    failures = []
    for name, accept in make_accepts(n, p).items():
        x = btrs(n, p, size, accept, seed=hash(name) & 0xFFFF)
        mz = (x.mean() - n * p) / (np.sqrt(n * p * (1 - p))
                                   / np.sqrt(size))
        kmin, kmax = int(x.min()), int(x.max())
        obs = np.bincount((x - kmin).astype(int))
        pmf = stats.binom.pmf(np.arange(kmin, kmax + 1), int(n), p)
        exp = pmf * size
        keep = exp >= 5
        obs_p = np.concatenate([obs[keep], [obs[~keep].sum()]])
        exp_p = np.concatenate([exp[keep], [size - exp[keep].sum()]])
        sel = exp_p > 0
        chi2 = ((obs_p[sel] - exp_p[sel]) ** 2 / exp_p[sel]).sum()
        pval = stats.chi2.sf(chi2, max(sel.sum() - 1, 1))
        print(f"[{name:14s}] mean_z={mz:+7.2f}  chi2 p={pval:.3g}")
        expected_bad = name == "lgamma+native"
        bad = abs(mz) > 5 or pval < 1e-4
        if bad != expected_bad:
            failures.append(name)
    if failures:
        print(f"UNEXPECTED: {failures}")
        sys.exit(1)
    print("log-error injection study: as predicted "
          "(lgamma+native biased; both BTRD forms clean)")


if __name__ == "__main__":
    main()
