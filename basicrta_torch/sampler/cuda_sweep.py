"""The fused collapsed-Gibbs sweep: CUDA kernels and their plain versions.

Counterpart of ``basicrta_tpu.sampler.pallas_sweep``. Three kernels, built
from ``csrc/sweep.cu``:

- :func:`sweep_stats` (K1) — one sweep's sufficient statistics (N_k, T_k)
  per lane: suffix sums, then the K-1 stage conditional-binomial chain in
  three multiplicity tiers (inversion + BTRS head, 17-step inversion small
  tier, inverse-CDF singletons). Replaces ``pallas_sweep.sweep_stats``.
- :func:`segment` (K2) — ``n_blocks * g`` whole sweeps per launch with the
  Dirichlet/Gamma conjugate draw inside the kernel, writing the thinned
  state every g sweeps. Replaces ``pallas_sweep.segment_pallas`` with
  ``pack=1``.
- :func:`segment_packed` (K3) — K2 with ``pack`` logical lanes, each with
  its own chain, sharing one 128-column physical lane in uniform or mixed
  widths. Replaces ``pallas_sweep._segment_pallas_packed``.

``tree=True`` gives each of the three its binary-splitting form (K4,
``pallas_sweep._suff_stats_tree``): the multinomial over the components
in log2(Kp) levels of node draws instead of the K-1 stage chain.
:func:`transcendentals_per_sweep` is the roofline's static count.

Random numbers come from the JAX package's counter hash (``_hash_bits``)
keyed by (seed, lane group, call-site tag, round, element id), with the
same call-site numbering and element ids the Pallas kernels use in
interpret mode. The plain versions :func:`sweep_stats_torch` and
:func:`segment_torch` keep the JAX code's structure and Python loops, so
the site counter advances exactly as it does there, and they reproduce the
JAX interpret path draw for draw on the CPU.

Each wrapper runs the plain version for CPU tensors and launches its
kernel for CUDA tensors (or raises); ``launches`` counts kernel launches.
A lane is one thread block with a thread per column
(:func:`block_threads`); K3 takes each slot's contiguous column range
(:func:`slot_ranges`).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import weakref
from typing import Optional, Tuple

import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.ops.precise import (exp_f32, gammaln_f32, log_f32,
                                        pow_smallint, stirling_tail)
from basicrta_torch.sampler.kernels import SMALL_NMAX, MixtureState

_LANES = 128
_GROUP = 64         # lanes per group of the reference's layout (hash lane id)
_INV_FULL = 32      # head-tier inversion depth (n*p <= 10)
_INV_SMALL = SMALL_NMAX + 1
_BTRS_ROUNDS = 12
_BTRS_UNROLL = 4    # btrd_nat_h4: rounds with their own call sites
_MT_ROUNDS = 8
_TINY = 1e-30
_M32 = 0xFFFFFFFF
_ELEM_MUL = 0x27D4EB2F
_KMAX = 32          # largest K the CUDA kernels take (local arrays)
_PACK_MAX = 16      # most logical lanes K3 packs into one physical lane
_CHAIN_THREADS = 1024   # most threads of a block (sweep.cu kChainThreads)
_TREE_THREADS = 512     # ... of a tree form's (kTreeThreads)


# --------------------------------------------------------------------- #
# counter-hash RNG (pallas_sweep._hash_bits / _bits_to_uniform)

def _murmur_fmix(h):
    """murmur3 finalizer on uint32 values held in int64 (or Python ints):
    torch has no uint32 shift or add on the CPU, so products are masked."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _bits_to_uniform(bits):
    """uint32 bits (int64) -> U[2^-25, 1) on the 24-bit mantissa grid."""
    u = (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return torch.clamp_min(u, 1.0 / 33554432.0)


def _element_ids(rows, g, cols):
    """Element id of tile position (row, g, col): the row-major iota
    combination of ``_hash_bits`` over a (rows, G, 128) tile."""
    return (((rows * _ELEM_MUL + g) & _M32) * _ELEM_MUL + cols) & _M32


def _hash_bits(seed, lane, tag, t, elem):
    """Counter-hash random bits of (seed, lane, tag, t, element id); every
    argument is an int or an int64 tensor of uint32 values."""
    h = (((seed & _M32) * 0x9E3779B9) & _M32) ^ ((lane * 0x85EBCA6B) & _M32)
    h = _murmur_fmix(h ^ ((((tag * 0xC2B2AE35) & _M32) + t) & _M32))
    return _murmur_fmix(h ^ _murmur_fmix(elem))


class _Rng:
    """Uniforms for one sweep of every lane, numbered by call site as the
    Pallas kernel traces them (``pallas_sweep._Rng``). ``lane`` is each
    lane's group index; uniforms are drawn on precomputed ``fmix(elem)``
    tiles."""

    def __init__(self, seed: int, lane: torch.Tensor):
        self.h0 = (((seed & _M32) * 0x9E3779B9) & _M32) ^ (
            (lane * 0x85EBCA6B) & _M32)
        self.site = 0

    def reserve(self, n: int) -> int:
        """Take ``n`` consecutive sites (a loop body traced once)."""
        first = self.site + 1
        self.site += n
        return first

    def uniform(self, felem, t: int = 0, site: Optional[int] = None):
        if site is None:
            site = self.reserve(1)
        h = _murmur_fmix(self.h0 ^ ((((site * 0xC2B2AE35) & _M32) + t)
                                    & _M32))
        h = h.view(-1, *([1] * (felem.dim() - 1)))
        return _bits_to_uniform(_murmur_fmix(h ^ felem))


def group_size(B: int, V: int, rows_per_lane: int,
               group_cap: Optional[int] = None) -> int:
    """Lanes per group G of the reference's VMEM layout
    (``pallas_sweep._group_layout``). A lane b draws with lane id b // G
    and element row b % G — the hash keys its uniforms by both."""
    SL = V // _LANES
    g_fit = (12 * 2 ** 20) // max(1, rows_per_lane * SL * _LANES * 4)
    g_fit = max(8, (g_fit // 8) * 8)
    cap = int(min(group_cap or _GROUP, g_fit))
    NG = -(-B // cap)
    return max(8, (-(-B // NG) + 7) // 8 * 8)


def _tier_elems(B: int, G: int, c0: int, c1: int, device):
    """fmix(element id) over value columns [c0, c1) of every lane, for a
    tier tile whose first row is column c0's row."""
    cols = torch.arange(c0, c1, device=device, dtype=torch.int64)
    b = torch.arange(B, device=device, dtype=torch.int64)[:, None]
    return _murmur_fmix(_element_ids(((cols - c0) // _LANES)[None, :],
                                     b % G, (cols % _LANES)[None, :]))


def _lane_ids(B: int, G: int, device):
    return torch.arange(B, device=device, dtype=torch.int64) // G


# --------------------------------------------------------------------- #
# plain versions of the samplers (pallas_sweep counterparts)

def _binom_inversion(u, n, p, depth: int, nmax_bits: int = 0):
    """CDF-inversion binomial, complete for counts < depth. The walk stops
    once every uniform is covered: m never moves after that."""
    q = torch.clamp_min(1.0 - p, _TINY)
    ratio = p / q
    if nmax_bits:
        pmf0 = pow_smallint(q, n, nmax_bits)
    else:
        pmf0 = exp_f32(n * log_f32(q))
    cdf, pmf, m = pmf0, pmf0, torch.zeros_like(u)
    for t in range(depth):
        above = u > cdf
        if not bool(above.any()):
            break
        m = m + above.to(torch.float32)
        pmf = torch.where(n - float(t) > 0,
                          pmf * ratio * (n - float(t)) / (t + 1.0), 0.0)
        cdf = cdf + pmf
    return torch.minimum(m, n)


def _binom_btrs(rng: _Rng, felem, n, p, h4: bool):
    """Hormann BTRS rejection, first accepted of 12 rounds (mode m after).

    ``h4`` is the production ``btrd_nat_h4`` form (BTRD regrouping with
    native ratio logs; 4 rounds with their own call sites, then a loop body
    whose two sites the remaining rounds share). Otherwise the lgamma-form
    accept test of ``mode=True``, one shared pair of sites for all rounds —
    the form ``pallas_sweep.sweep_stats`` runs."""
    q = 1.0 - p
    spq = torch.sqrt(n * p * q)
    b = 1.15 + 2.53 * spq
    a = -0.0873 + 0.0248 * b + 0.01 * p
    c = n * p + 0.5
    vr = 0.92 - 4.2 / b
    alpha = (2.83 + 5.1 / b) * spq
    r = torch.clamp_min(p / q, _TINY)
    m = torch.floor((n + 1.0) * p)
    if h4:
        nm = n - m + 1.0
        hb = ((m + 0.5) * log_f32(torch.clamp_min((m + 1.0) / (r * nm),
                                                  _TINY))
              + stirling_tail(m) + stirling_tail(n - m))
    else:
        lpq = log_f32(r)
        h = gammaln_f32(m + 1.0) + gammaln_f32(n - m + 1.0)

    def round_step(t, site, k_acc, done):
        u = rng.uniform(felem, t, site) - 0.5
        v = rng.uniform(felem, t, site + 1)
        us = 0.5 - torch.abs(u)
        k = torch.floor((2.0 * a / us + b) * u + c)
        in_range = (k >= 0) & (k <= n)
        fast = (us >= 0.07) & (v <= vr)
        vv = torch.log(torch.clamp_min(v * alpha / (a / (us * us) + b),
                                       _TINY))
        if h4:
            nk = n - k + 1.0
            slow = vv <= (hb + (n + 1.0)
                          * torch.log(torch.clamp_min(nm / nk, _TINY))
                          + (k + 0.5)
                          * torch.log(torch.clamp_min(nk * r / (k + 1.0),
                                                      _TINY))
                          - stirling_tail(k) - stirling_tail(n - k))
        else:
            slow = vv <= (h - gammaln_f32(k + 1.0) - gammaln_f32(n - k + 1.0)
                          + (k - m) * lpq)
        ok = in_range & (fast | slow)
        upd = ok & ~done
        return torch.where(upd, k, k_acc), done | ok

    k_acc, done = m, torch.zeros(n.shape, dtype=torch.bool, device=n.device)
    unroll = _BTRS_UNROLL if h4 else 0
    for t in range(unroll):
        k_acc, done = round_step(t, rng.reserve(2), k_acc, done)
    loop_site = rng.reserve(2)
    for t in range(unroll, _BTRS_ROUNDS):
        if bool(done.all()):
            break
        k_acc, done = round_step(t, loop_site, k_acc, done)
    return k_acc


def _binom_full(rng: _Rng, felem, n, p, h4: bool):
    """General exact binomial: symmetry fold, inversion where n*p <= 10,
    BTRS elsewhere (both drawn for every element, as in the reference)."""
    p = torch.clamp(p, 0.0, 1.0)
    flip = p > 0.5
    p_eff = torch.where(flip, 1.0 - p, p)
    small = n * p_eff <= 10.0
    u = rng.uniform(felem)
    m_inv = _binom_inversion(u, n, torch.where(small, p_eff, 0.0), _INV_FULL)
    n_b = torch.where(small, 100.0, n)
    p_b = torch.where(small, 0.3, p_eff)
    m_btrs = _binom_btrs(rng, felem, n_b, p_b, h4)
    m = torch.where(small, m_inv, m_btrs)
    m = torch.where(flip, n - m, m)
    m = torch.where((p <= 0.0) | (n <= 0.0), 0.0, m)
    m = torch.where(p >= 1.0, n, m)
    return torch.minimum(torch.clamp_min(m, 0.0), n)


def _normal_icdf(p):
    """Acklam's rational approximation of the standard normal inverse CDF
    (three-region select, as the reference)."""
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    cc = (-7.784894002430293e-03, -3.223964580411365e-01,
          -2.400758277161838e+00, -2.549732539343734e+00,
          4.374664141464968e+00, 2.938163982698783e+00)
    dd = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)
    plow = 0.02425
    p = torch.clamp(p, 1.0 / 33554432.0, 1.0 - 1.0 / 33554432.0)

    def tail(q):
        s = torch.sqrt(-2.0 * log_f32(q))
        num = ((((cc[0] * s + cc[1]) * s + cc[2]) * s + cc[3]) * s
               + cc[4]) * s + cc[5]
        den = (((dd[0] * s + dd[1]) * s + dd[2]) * s + dd[3]) * s + 1.0
        return num / den

    q = p - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den = ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0
    central = num * q / den
    lo = tail(p)
    hi = -tail(1.0 - p)
    return torch.where(p < plow, lo,
                       torch.where(p > 1.0 - plow, hi, central))


def _gamma_mt(rng: _Rng, felem, a):
    """Gamma(a, 1) by Marsaglia-Tsang, first accepted of 8 rounds (one
    loop body, so one pair of call sites), shapes a < 1 boosted through
    Gamma(a+1) U^(1/a)."""
    boost = torch.where(a < 1.0, 1.0, 0.0)
    a_eff = a + boost
    d = a_eff - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    v_acc = torch.ones_like(a)
    done = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    site = rng.reserve(2)
    for t in range(_MT_ROUNDS):
        if bool(done.all()):
            break
        x = _normal_icdf(rng.uniform(felem, t, site))
        u = rng.uniform(felem, t, site + 1)
        y = 1.0 + c * x
        v = y * (y * y)                  # lax.integer_pow(y, 3)
        ok = (v > 0.0) & (log_f32(u) < 0.5 * x * x + d - d * v
                          + d * log_f32(torch.clamp_min(v, _TINY)))
        v_acc = torch.where(ok & ~done, v, v_acc)
        done = done | ok
    sample = d * v_acc
    ub = rng.uniform(felem)
    boosted = sample * exp_f32(log_f32(ub) / torch.clamp_min(a, _TINY))
    out = sample * (1.0 - boost) + boosted * boost
    return torch.clamp_min(out, 1e-30)


# --------------------------------------------------------------------- #
# the sweep body (plain)

class _Layout:
    """Per-lane hash keys and tier column ranges of one bucket of B
    (physical) lanes in groups of G. ``pack > 1`` (K3) gives the
    conjugate draw its (2, pack, G, K) tile and each lane ``pack`` slots
    of statistics."""

    def __init__(self, B: int, V: int, K: int, tiers: Tuple[int, int],
                 G: int, device, pack: int = 1):
        head_rows, small_rows = tiers
        self.hh = head_rows * _LANES
        self.hs = small_rows * _LANES
        self.V = V
        self.lane = _lane_ids(B, G, device)
        self.fe_head = _tier_elems(B, G, 0, self.hh, device)
        self.fe_small = _tier_elems(B, G, self.hh, self.hs, device)
        self.fe_single = _tier_elems(B, G, self.hs, V, device)
        self.G = G
        self.zeros = torch.zeros((B,) if pack == 1 else (B, pack),
                                 dtype=torch.float32, device=device)
        self._node_elems = {}
        ar = lambda n: torch.arange(n, device=device,  # noqa: E731
                                    dtype=torch.int64)
        g = ar(B) % G
        if pack == 1:
            # the conjugate draw's (2, G, K) tile
            self.fe_gamma = _murmur_fmix(_element_ids(
                ar(2)[None, :, None], g[:, None, None],
                ar(K)[None, None, :]))
        else:
            # (2, pack, G, K): the leading pair of iota axes folds first
            i_s = (ar(2)[:, None] * _ELEM_MUL + ar(pack)[None, :]) & _M32
            self.fe_gamma = _murmur_fmix(_element_ids(
                i_s[None, :, :, None], g[:, None, None, None],
                ar(K)[None, None, None, :]))

    def node_elems(self, nodes: int):
        """fmix(element id) of the tree's stacked (nodes, rows, G, 128)
        draws, as (B, nodes, cols) per tier: the node index folds in
        before the tier's own row, which restarts at 0 in each tier."""
        if nodes not in self._node_elems:
            B = self.lane.shape[0]
            dev = self.lane.device
            node = torch.arange(nodes, device=dev, dtype=torch.int64)
            g = (torch.arange(B, device=dev, dtype=torch.int64)
                 % self.G)[:, None, None]
            tiles = []
            for c0, c1 in ((0, self.hh), (self.hh, self.hs),
                           (self.hs, self.V)):
                cols = torch.arange(c0, c1, device=dev, dtype=torch.int64)
                rows = (node[:, None] * _ELEM_MUL
                        + (cols - c0)[None, :] // _LANES) & _M32
                tiles.append(_murmur_fmix(_element_ids(
                    rows[None], g, (cols % _LANES)[None, None, :])))
            self._node_elems[nodes] = tiles
        return self._node_elems[nodes]


def _suffix_sums(v, w, r, K: int):
    """[S_0..S_{K-1}], S_k = sum_{j>=k} w_j r_j exp(-r_j v). ``w``/``r``
    are per lane (B, K) or per column (B, K, V)."""
    z = [None] * K
    zsum = torch.zeros_like(v)
    for k in range(K - 1, -1, -1):
        wk, rk = ((w[:, k], r[:, k]) if w.dim() == 3
                  else (w[:, k:k + 1], r[:, k:k + 1]))
        zsum = zsum + (wk * rk) * torch.exp(-rk * v)
        z[k] = zsum
    return z


def _lane_sums(draw, vals):
    """(N, T) contributions of a (B, cols) draw to each lane."""
    return draw.sum(1), (vals * draw).sum(1)


def _suff_stats(rng: _Rng, lay: _Layout, v, c, w, r, K: int, h4: bool,
                reduce=_lane_sums):
    """Sufficient statistics (N_k, T_k) of one collapsed sweep
    (``pallas_sweep._suff_stats`` on the (B, V) layout), each (B, K), or
    (B, pack, K) with K3's per-slot ``reduce``."""
    hh, hs, V = lay.hh, lay.hs, lay.V
    z = _suffix_sums(v, w, r, K)
    if V > hs:
        u1 = rng.uniform(lay.fe_single)
        thresh = u1 * z[0][:, hs:]
        c_single = c[:, hs:]
        v_single = v[:, hs:]
        prev_ind = torch.ones_like(thresh)
    rem = c[:, :hs]
    v_hs = v[:, :hs]
    zeros = lay.zeros
    ns_list, ts_list = [], []
    for k in range(K - 1):
        ns_k, ts_k = zeros, zeros
        if hs > 0:
            suffix = z[k][:, :hs]
            nxt = z[k + 1][:, :hs]
            pcond = torch.clamp((suffix - nxt)
                                / torch.clamp_min(suffix, _TINY), 0.0, 1.0)
            parts = []
            if hh > 0:
                parts.append(_binom_full(rng, lay.fe_head, rem[:, :hh],
                                         pcond[:, :hh], h4))
            if hs > hh:
                u = rng.uniform(lay.fe_small)
                parts.append(_binom_inversion(u, rem[:, hh:], pcond[:, hh:],
                                              _INV_SMALL, nmax_bits=5))
            draw = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
            dn, dt = reduce(draw, v_hs)
            ns_k = ns_k + dn
            ts_k = ts_k + dt
            rem = rem - draw
        if V > hs:
            ind = torch.where(z[k + 1][:, hs:] > thresh, 1.0, 0.0)
            sdraw = c_single * (prev_ind - ind)
            prev_ind = ind
            dn, dt = reduce(sdraw, v_single)
            ns_k = ns_k + dn
            ts_k = ts_k + dt
        ns_list.append(ns_k)
        ts_list.append(ts_k)
    ns_K, ts_K = zeros, zeros
    if hs > 0:
        dn, dt = reduce(rem, v_hs)
        ns_K = ns_K + dn
        ts_K = ts_K + dt
    if V > hs:
        sdraw = c_single * prev_ind
        dn, dt = reduce(sdraw, v_single)
        ns_K = ns_K + dn
        ts_K = ts_K + dt
    ns_list.append(ns_K)
    ts_list.append(ts_K)
    return torch.stack(ns_list, -1), torch.stack(ts_list, -1)


def _tiered_binom(rng: _Rng, lay: _Layout, n, p, h4: bool):
    """Tier-dispatched binomial draws of one tree level's stacked
    (B, nodes, V) node counts (``pallas_sweep._tiered_binom``): the head
    tier's general binomial, the small tier's 17-step inversion, and a
    Bernoulli ``u < p`` per node for the singleton tier."""
    hh, hs, V = lay.hh, lay.hs, lay.V
    fe_head, fe_small, fe_single = lay.node_elems(n.shape[1])
    parts = []
    if hh > 0:
        parts.append(_binom_full(rng, fe_head, n[..., :hh], p[..., :hh], h4))
    if hs > hh:
        u = rng.uniform(fe_small)
        parts.append(_binom_inversion(u, n[..., hh:hs], p[..., hh:hs],
                                      _INV_SMALL, nmax_bits=5))
    if V > hs:
        u = rng.uniform(fe_single)
        parts.append(n[..., hs:] * (u < p[..., hs:]).to(torch.float32))
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def _suff_stats_tree(rng: _Rng, lay: _Layout, v, c, w, r, K: int, h4: bool,
                     reduce=_lane_sums):
    """Sufficient statistics by binary multinomial splitting
    (``pallas_sweep._suff_stats_tree``): the components, padded with
    empty ones to Kp = the next power of two, split in half level by
    level, every node of a level drawn in one stacked binomial call, so
    log2(Kp) levels replace the chain's K - 1 stages. Returns (B, K), or
    (B, pack, K) with K3's per-slot ``reduce``."""
    z = _suffix_sums(v, w, r, K)
    Kp = 1
    while Kp < K:
        Kp *= 2
    zero = torch.zeros_like(v)

    def S(k):
        return z[k] if k < K else zero

    nodes = [(0, Kp, c)]                       # (a, b, counts) in order
    while len(nodes) < Kp:
        pairs = [(a, (a + b) // 2, b, n) for a, b, n in nodes]
        num = torch.stack([S(a) - S(m) for a, m, _, _ in pairs], 1)
        den = torch.stack([S(a) - S(b) for a, _, b, _ in pairs], 1)
        p = torch.clamp(num / torch.clamp_min(den, _TINY), 0.0, 1.0)
        n_st = torch.stack([n for _, _, _, n in pairs], 1)
        draws = _tiered_binom(rng, lay, n_st, p, h4)
        nxt = []
        for i, (a, m, b, n) in enumerate(pairs):
            left = torch.minimum(draws[:, i], n)
            nxt.append((a, m, left))
            nxt.append((m, b, n - left))
        nodes = nxt
    sums = [reduce(n, v) for _, _, n in nodes[:K]]
    return (torch.stack([x for x, _ in sums], -1),
            torch.stack([t for _, t in sums], -1))


def _conjugate(rng: _Rng, lay: _Layout, ns, ts, alpha: float, ga: float,
               gb: float):
    """Dirichlet/Gamma conjugate draw from the sweep's statistics: one
    Marsaglia-Tsang call over the stacked (weight, rate) shapes."""
    g2 = _gamma_mt(rng, lay.fe_gamma, torch.stack([alpha + ns, ga + ns], 1))
    w = g2[:, 0] / torch.sum(g2[:, 0], -1, keepdim=True)
    r = g2[:, 1] / (gb + ts)
    return w, r


def _check(state: MixtureState, values, counts, K: int,
           tiers: Tuple[int, int], state_rows: Optional[int] = None):
    """Validate a bucket: (B, V) values/counts with V a multiple of 128,
    row tiers, and a (state_rows, K) state (default B rows)."""
    B, V = values.shape
    if V % _LANES or V == 0:
        raise ValueError(f"value width must be a positive multiple of "
                         f"{_LANES}; got {V}")
    if counts.shape != values.shape:
        raise ValueError(f"counts {tuple(counts.shape)} do not match values "
                         f"{tuple(values.shape)}")
    rows = B if state_rows is None else state_rows
    if tuple(state.weights.shape) != (rows, K) or tuple(
            state.rates.shape) != (rows, K):
        raise ValueError(f"state must be ({rows}, {K}); got "
                         f"{tuple(state.weights.shape)}")
    head_rows, small_rows = tiers
    if not 0 <= head_rows <= small_rows <= V // _LANES:
        raise ValueError(f"row tiers {tiers} outside 0 <= head <= small <= "
                         f"{V // _LANES}")
    for name, x in (("values", values), ("counts", counts),
                    ("weights", state.weights), ("rates", state.rates)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32; got {x.dtype}")


def sweep_stats_torch(seed: int, state: MixtureState, values, counts,
                      K: int, tiers: Tuple[int, int], tree: bool = False):
    """Plain version of K1: (Ns, Ts), each (B, K), of one sweep.

    Draw for draw the JAX ``sweep_stats`` in interpret mode (its default
    lgamma-form BTRS); ``tree`` takes the binary-splitting multinomial
    (K4). ``tiers`` are row tiers (``pad_tiers_to_rows``)."""
    _check(state, values, counts, K, tiers)
    sweep_stats_torch.calls += 1
    B, V = values.shape
    lay = _Layout(B, V, K, tiers, group_size(B, V, K + 3), values.device)
    rng = _Rng(int(seed), lay.lane)
    stats = _suff_stats_tree if tree else _suff_stats
    return stats(rng, lay, values, counts, state.weights, state.rates, K,
                 h4=False)


def rows_per_lane(K: int, tree: bool) -> int:
    """The reference's VMEM row budget of a K2/K3 lane: the suffix sums
    plus the chain's temporaries, ~3x more at the tree's widest level."""
    return 3 * K + 12 if tree else K + 12


def segment_torch(seed: int, sweep_offset: int, state: MixtureState,
                  values, counts, cfg: GibbsConfig, n_blocks: int,
                  tiers: Tuple[int, int], tree: bool = False):
    """Plain version of K2: ``n_blocks * cfg.g`` sweeps from ``state``.

    Every sweep reseeds from ``seed * 2654435761 + absolute sweep`` (int32
    wrap-around), so any segmentation of a run gives the same chain.
    ``tree`` draws the statistics by binary splitting (K4).
    Returns (state, W, R) with W/R (B, n_blocks, K) thinned samples."""
    K = cfg.ncomp
    _check(state, values, counts, K, tiers)
    segment_torch.calls += 1
    B, V = values.shape
    lay = _Layout(B, V, K, tiers, group_size(B, V, rows_per_lane(K, tree)),
                  values.device)
    stats = _suff_stats_tree if tree else _suff_stats
    w, r = state.weights, state.rates
    W, R = [], []
    for i in range(n_blocks * cfg.g):
        seed_sweep = (int(seed) * 2654435761 + int(sweep_offset) + i) & _M32
        rng = _Rng(seed_sweep, lay.lane)
        ns, ts = stats(rng, lay, values, counts, w, r, K, h4=True)
        w, r = _conjugate(rng, lay, ns, ts, cfg.alpha_eff, cfg.gamma_shape,
                          cfg.gamma_rate)
        if (i + 1) % cfg.g == 0:
            W.append(w)
            R.append(r)
    return MixtureState(w, r), torch.stack(W, 1), torch.stack(R, 1)


# --------------------------------------------------------------------- #
# packed lanes (K3): ``pack`` logical lanes share one physical lane

def packed_row_tiers(tiers: Tuple[int, int], seg_width: int,
                     SL: int) -> Tuple[int, int]:
    """Row tiers of a uniformly packed bucket: logical column j of a
    segment lies in physical row j // seg_width, so a column tier boundary
    t covers rows [0, ceil(t / seg_width))."""
    up = lambda x: -(-x // seg_width)  # noqa: E731
    head = min(up(tiers[0]), SL)
    small = min(max(up(tiers[1]), head), SL)
    return head, small


def packed_group_size(Bph: int, SL: int, K: int, n_blocks: int, pack: int,
                      group_cap: Optional[int] = None,
                      tree: bool = False) -> int:
    """Physical lanes per group G of the reference's packed layout
    (``pallas_sweep._segment_pallas_packed``). Its budget counts the
    thinned outputs too, so G depends on ``n_blocks`` and ``pack``."""
    per_lane = (rows_per_lane(K, tree) * SL * _LANES * 4
                + 2 * n_blocks * pack * K * 4)
    g_fit = max(8, ((12 * 2 ** 20) // max(1, per_lane)) // 8 * 8)
    cap = int(min(group_cap or _GROUP, g_fit))
    NG = -(-Bph // cap)
    return max(8, (-(-Bph // NG) + 7) // 8 * 8)


def _packed_operands(state: MixtureState, values, counts, K: int,
                     tiers: Tuple[int, int], pack: int, seg_mask,
                     check_slots: bool = True):
    """Physical operands of K3: (v, c, slot) with v/c (Bph, SL * 128) and
    slot (Bph, 128) int64, each column's owning slot.

    Uniform packing (``seg_mask`` None): values/counts are logical
    (B, SL * 128 // pack), B a multiple of pack, and lane g's slot s owns
    columns [s * W, (s + 1) * W) of every row (W = 128 // pack). Mixed
    packing: values/counts are physical already and ``seg_mask`` is the
    (Bph, 128) f32 slot-id tile. Either way the state is slot-ordered
    (pack * Bph, K): logical lane g * pack + s. ``check_slots`` False
    leaves the refusal of slot ids outside [0, pack) to the caller."""
    if not 2 <= pack <= _PACK_MAX:
        raise ValueError(f"pack must lie in [2, {_PACK_MAX}]; got {pack}")
    B, WL = values.shape
    if seg_mask is None:
        W = _LANES // pack
        if _LANES % pack or B % pack or WL % W or WL == 0:
            raise ValueError(
                f"packed batch needs B % pack == 0 and width a multiple "
                f"of 128 // pack; got B={B}, V={WL}, pack={pack}")
        Bph, SL = B // pack, WL // W

        def to_phys(x):
            x = x.reshape(Bph, pack, SL, W)
            return x.transpose(1, 2).reshape(Bph, SL * _LANES)

        values, counts = to_phys(values), to_phys(counts)
        slot = (torch.arange(_LANES, device=values.device) // W).expand(
            Bph, _LANES)
    else:
        Bph, SL = B, WL // _LANES
        if (WL % _LANES or WL == 0
                or tuple(seg_mask.shape) != (Bph, _LANES)):
            raise ValueError(
                f"mixed-width packing needs physical (Bph, SL*128) values "
                f"and a (Bph, 128) slot tile; got values "
                f"{tuple(values.shape)}, seg_mask {tuple(seg_mask.shape)}")
        slot = seg_mask.to(torch.int64)
        if check_slots and bool(((slot < 0) | (slot >= pack)).any()):
            raise ValueError(f"slot ids must lie in [0, {pack})")
    _check(state, values, counts, K, tiers, state_rows=pack * Bph)
    return values.contiguous(), counts.contiguous(), slot.contiguous()


def slot_ranges(slot, pack: int):
    """(Bph, pack, 2) int64 column ranges [start, end) of K3's slots, read
    off the (Bph, 128) slot tile: a slot's first run of columns. Both
    packings give every slot one contiguous range (uniform: W columns
    from s * W; mixed: its width from the running offset); columns that no
    member owns carry slot 0 and count 0 behind the last slot and belong
    to no range. A slot without columns gets (0, 0)."""
    Bph = slot.shape[0]
    col = torch.arange(_LANES, device=slot.device)
    owns = slot[:, None, :] == torch.arange(pack, device=slot.device)[
        None, :, None]                                     # (Bph, pack, 128)
    some = owns.any(-1)
    start = owns.to(torch.int64).argmax(-1)
    after = ~owns & (col[None, None, :] >= start[..., None])
    end = torch.where(after.any(-1), after.to(torch.int64).argmax(-1),
                      torch.full_like(start, _LANES))
    zero = torch.zeros_like(start)
    return torch.stack([torch.where(some, start, zero),
                        torch.where(some, end, zero)], -1).view(Bph, pack, 2)


def block_threads(SL: int, tree: bool = False) -> int:
    """Threads of the block that runs one lane of ``SL`` 128-column rows:
    a thread per column, whole rows, at most 1,024 (512 for the tree
    forms, whose node array costs registers). A lane with more rows takes
    them in turns of the block's rows, to and fro: the threads of the
    first rows, the dearest, get the last or none."""
    cap = (_TREE_THREADS if tree else _CHAIN_THREADS) // _LANES
    return _LANES * min(max(SL, 1), cap)


def block_shared_bytes(K: int, SL: int, pack: int = 1,
                       tree: bool = False) -> int:
    """Dynamic shared memory of the block that runs one lane (``smem_bytes``
    in ``sweep.cu``): (w, r) of its pack * K chains, the columns' slots and
    runs, the slots' first and last run, and the 2K rows of reduction
    cells, one cell a block row and run."""
    rows = block_threads(SL, tree) // _LANES
    runs = 2 * pack + 4 if pack > 1 else _LANES // 32
    return 4 * (2 * pack * K + 2 * K * ((rows * runs) | 1)
                + 2 * _LANES + 2 * pack)


def _slot_sums(masks):
    """K3's reduction: rows first, then each slot's masked columns
    (``pallas_sweep._suff_stats_packed`` seg_sums); (Bph, pack) sums."""
    Bph = masks.shape[0]

    def reduce(draw, vals):
        rn = draw.view(Bph, -1, _LANES).sum(1)
        rt = (vals * draw).view(Bph, -1, _LANES).sum(1)
        return (rn[:, None] * masks).sum(-1), (rt[:, None] * masks).sum(-1)
    return reduce


def segment_packed_torch(seed: int, sweep_offset: int, state: MixtureState,
                         values, counts, cfg: GibbsConfig, n_blocks: int,
                         tiers: Tuple[int, int], pack: int, seg_mask=None,
                         tree: bool = False):
    """Plain version of K3: ``n_blocks * cfg.g`` sweeps of packed lanes.

    Draw for draw the JAX ``segment_pallas(..., pack=pack,
    seg_mask=seg_mask)`` in interpret mode. Each column takes its owning
    slot's (w, r) in the suffix sums; the binomial chain runs on the
    physical rows as in K2; the statistics reduce rows first, then each
    slot's columns; the conjugate draw runs on a (2, pack, G, K) tile.
    ``tree`` splits the physical rows by binary splitting instead (K4).
    ``tiers`` are physical row tiers (:func:`packed_row_tiers`, or the
    mixed layout's). Returns (state, W, R), slot-ordered, W/R
    (pack * Bph, n_blocks, K)."""
    K = cfg.ncomp
    v, c, slot = _packed_operands(state, values, counts, K, tiers, pack,
                                  seg_mask)
    segment_packed_torch.calls += 1
    Bph, V = v.shape
    G = packed_group_size(Bph, V // _LANES, K, n_blocks, pack, tree=tree)
    stats = _suff_stats_tree if tree else _suff_stats
    lay = _Layout(Bph, V, K, tiers, G, v.device, pack)
    masks = (slot[:, None, :] == torch.arange(pack, device=v.device)[
        None, :, None]).to(torch.float32)                  # (Bph, pack, 128)
    reduce = _slot_sums(masks)
    col_slot = slot.repeat(1, V // _LANES)[:, None, :].expand(Bph, K, V)
    w = state.weights.reshape(Bph, pack, K)
    r = state.rates.reshape(Bph, pack, K)
    W, R = [], []
    for i in range(n_blocks * cfg.g):
        seed_sweep = (int(seed) * 2654435761 + int(sweep_offset) + i) & _M32
        rng = _Rng(seed_sweep, lay.lane)
        w_col = torch.gather(w.transpose(1, 2), 2, col_slot)  # (Bph, K, V)
        r_col = torch.gather(r.transpose(1, 2), 2, col_slot)
        ns, ts = stats(rng, lay, v, c, w_col, r_col, K, h4=True,
                       reduce=reduce)
        w, r = _conjugate(rng, lay, ns, ts, cfg.alpha_eff, cfg.gamma_shape,
                          cfg.gamma_rate)
        if (i + 1) % cfg.g == 0:
            W.append(w.reshape(-1, K))
            R.append(r.reshape(-1, K))
    return (MixtureState(w.reshape(-1, K), r.reshape(-1, K)),
            torch.stack(W, 1), torch.stack(R, 1))


sweep_stats_torch.calls = 0
segment_torch.calls = 0
segment_packed_torch.calls = 0


# --------------------------------------------------------------------- #
# the CUDA kernels: build, bind, launch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "build")
# -fmad=false: a contracted multiply-add changes Acklam's inverse-normal
# polynomial (which cancels near its region edges) by up to 1e-3 relative,
# so contracted gamma draws leave the plain version in ~12% of lanes after
# one sweep; uncontracted, the kernel does the plain version's arithmetic
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def build_library(verbose: bool = False, source: str = "sweep.cu",
                  defines: Tuple[str, ...] = ()) -> str:
    """Compile ``csrc/<source>`` into ``build/`` (keyed by a hash of the
    source, the shared headers and the flags) unless that library exists;
    returns its path. ``defines`` are preprocessor symbols of a profiling
    build (``scripts/sweep_phases.py``)."""
    path = os.path.join(_CSRC, source)
    flags = _NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    h = hashlib.sha1(" ".join(flags).encode())
    for p in [path] + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(p, "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    out = os.path.join(_BUILD_DIR, f"lib{stem}_{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *flags, "-Xptxas", "-v", "-o", tmp, path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, out)
    return out


def _bind(path: str):
    """Load a build of ``sweep.cu`` and declare its entry points."""
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.basicrta_sweep_stats.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                         i, i, i, i, i, p]
    lib.basicrta_sweep_stats.restype = i
    lib.basicrta_segment.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                     i, i, i, i, i, i, i, f, f, f, i, i, p]
    lib.basicrta_segment.restype = i
    lib.basicrta_segment_packed.argtypes = [p, p, p, p, p, p, p, p, p,
                                            i, i, i, i, i, i, i, i, i,
                                            i, i, f, f, f, i, i, p]
    lib.basicrta_segment_packed.restype = i
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = _bind(build_library())
    return _lib


def _cuda_inputs(state: MixtureState, values, counts, K: int):
    """Validate CUDA operands; returns contiguous copies where needed."""
    for x in (values, counts, state.weights, state.rates):
        if x.device.type != "cuda" or x.device != values.device:
            raise ValueError("CUDA kernel operands must all lie on one CUDA "
                             f"device; got {x.device} and {values.device}")
    if not 1 <= K <= _KMAX:
        raise ValueError(f"the CUDA kernels take 1 <= K <= {_KMAX}; got {K}")
    return (state.weights.contiguous(), state.rates.contiguous(),
            values.contiguous(), counts.contiguous())


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _count_launch(fn, tree: bool):
    """One more launch of ``fn``'s kernel, or of its tree form (K4)."""
    if tree:
        fn.tree_launches += 1
    else:
        fn.launches += 1


def sweep_stats(seed: int, state: MixtureState, values, counts, K: int,
                tiers: Tuple[int, int], tree: bool = False):
    """K1: (Ns, Ts), each (B, K), of one collapsed sweep of every lane;
    ``tree`` launches its binary-splitting form (K4).

    CPU tensors run :func:`sweep_stats_torch`; CUDA tensors launch the
    kernel. ``tiers`` are row tiers (``pad_tiers_to_rows``)."""
    if values.device.type == "cpu":
        return sweep_stats_torch(seed, state, values, counts, K, tiers, tree)
    _check(state, values, counts, K, tiers)
    w, r, v, c = _cuda_inputs(state, values, counts, K)
    B, V = v.shape
    ns = torch.empty((B, K), dtype=torch.float32, device=v.device)
    ts = torch.empty_like(ns)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = _library().basicrta_sweep_stats(
        w.data_ptr(), r.data_ptr(), v.data_ptr(), c.data_ptr(),
        ns.data_ptr(), ts.data_ptr(), B, V, K, tiers[0], tiers[1],
        group_size(B, V, K + 3), _int32(seed), int(tree),
        block_threads(V // _LANES, tree), stream)
    _raise_on(rc, "sweep_stats")
    _count_launch(sweep_stats, tree)
    return ns, ts


def _int32(x: int) -> int:
    """Python int -> the int32 with the same low 32 bits."""
    x = int(x) & _M32
    return x - (1 << 32) if x >= 1 << 31 else x


def _launch_segment(lib, stream, seed: int, sweep_offset: int, w, r, v, c,
                    cfg: GibbsConfig, n_blocks: int, tiers, tree: bool):
    """Allocate K2's outputs beside ``v`` and launch it from ``lib``, a
    build of ``sweep.cu`` (:func:`_bind`), on ``stream``."""
    K = cfg.ncomp
    B, V = v.shape
    W = torch.empty((B, n_blocks, K), dtype=torch.float32, device=v.device)
    R = torch.empty_like(W)
    wf = torch.empty((B, K), dtype=torch.float32, device=v.device)
    rf = torch.empty_like(wf)
    rc = lib.basicrta_segment(
        w.data_ptr(), r.data_ptr(), v.data_ptr(), c.data_ptr(),
        W.data_ptr(), R.data_ptr(), wf.data_ptr(), rf.data_ptr(),
        B, V, K, tiers[0], tiers[1],
        group_size(B, V, rows_per_lane(K, tree)), _int32(seed),
        _int32(sweep_offset), cfg.g, n_blocks, cfg.alpha_eff,
        cfg.gamma_shape, cfg.gamma_rate, int(tree),
        block_threads(V // _LANES, tree), stream)
    _raise_on(rc, "segment")
    return MixtureState(wf, rf), W, R


def segment(seed: int, sweep_offset: int, state: MixtureState, values,
            counts, cfg: GibbsConfig, n_blocks: int, tiers: Tuple[int, int],
            tree: bool = False):
    """K2: advance every lane ``n_blocks * cfg.g`` sweeps in one launch;
    ``tree`` launches its binary-splitting form (K4).

    CPU tensors run :func:`segment_torch`; CUDA tensors launch the kernel.
    Returns (state, W, R) with W/R (B, n_blocks, K) thinned samples."""
    if values.device.type == "cpu":
        return segment_torch(seed, sweep_offset, state, values, counts, cfg,
                             n_blocks, tiers, tree)
    _check(state, values, counts, cfg.ncomp, tiers)
    w, r, v, c = _cuda_inputs(state, values, counts, cfg.ncomp)
    out = _launch_segment(
        _library(), torch.cuda.current_stream(v.device).cuda_stream, seed,
        sweep_offset, w, r, v, c, cfg, n_blocks, tiers, tree)
    _count_launch(segment, tree)
    return out


def checked_ranges(slot, c, pack: int):
    """K3's (Bph, pack, 2) int32 column ranges of the (Bph, 128) slot tile
    (:func:`slot_ranges`), after refusing what the kernel does not take: a
    slot id outside [0, pack), or a live column of ``c`` (Bph, SL * 128)
    outside its slot's one contiguous range. One device-to-host read."""
    Bph = slot.shape[0]
    ranges = slot_ranges(slot, pack)
    col = torch.arange(_LANES, device=slot.device)
    mine = torch.gather(ranges, 1, slot.clamp(0, pack - 1)[..., None].expand(
        Bph, _LANES, 2))
    live = (c.view(Bph, -1, _LANES) != 0).any(1)
    bad_id = (slot < 0) | (slot >= pack)
    stray = live & ((col < mine[..., 0]) | (col >= mine[..., 1]))
    flags = torch.stack([bad_id.any(), stray.any()]).tolist()
    if flags[0]:
        raise ValueError(f"slot ids must lie in [0, {pack})")
    if flags[1]:
        raise ValueError("the CUDA kernel takes slots that each own one "
                         "contiguous column range; a live column lies "
                         "outside its slot's")
    return ranges.to(torch.int32).contiguous()


# {id(tile): (tile ref, counts ref, their versions and pack, ranges)}: a
# bucket's segments pass the same tile and counts, and only the first
# pays for :func:`checked_ranges` and its read from the device
_ranges_memo: dict = {}


def _ranges_for(seg_mask, counts, slot, c, pack: int):
    """The launch's ranges: analytic for the uniform packing (``seg_mask``
    None), else :func:`checked_ranges`, remembered while the caller's tile
    and counts tensors stay the same objects, unmodified."""
    if seg_mask is None:
        start = torch.arange(pack, device=c.device,
                             dtype=torch.int32) * (_LANES // pack)
        return torch.stack([start, start + _LANES // pack], -1).expand(
            slot.shape[0], pack, 2).contiguous()
    key = id(seg_mask)
    stamp = (seg_mask._version, counts._version, pack)
    hit = _ranges_memo.get(key)
    if (hit is not None and hit[0]() is seg_mask and hit[1]() is counts
            and hit[2] == stamp):
        return hit[3]
    ranges = checked_ranges(slot, c, pack)
    _ranges_memo[key] = (
        weakref.ref(seg_mask, lambda _: _ranges_memo.pop(key, None)),
        weakref.ref(counts), stamp, ranges)
    return ranges


def _launch_packed(lib, stream, seed: int, sweep_offset: int, w, r, v, c,
                   ranges, cfg: GibbsConfig, n_blocks: int, tiers, pack: int,
                   tree: bool):
    """Allocate K3's outputs beside ``v`` and launch it from ``lib``
    (:func:`_bind`) on ``stream``, with the slots' column ranges
    (:func:`checked_ranges`)."""
    K = cfg.ncomp
    Bph, V = v.shape
    W = torch.empty((pack * Bph, n_blocks, K), dtype=torch.float32,
                    device=v.device)
    R = torch.empty_like(W)
    wf = torch.empty((pack * Bph, K), dtype=torch.float32, device=v.device)
    rf = torch.empty_like(wf)
    rc = lib.basicrta_segment_packed(
        w.data_ptr(), r.data_ptr(), v.data_ptr(), c.data_ptr(),
        ranges.data_ptr(), W.data_ptr(), R.data_ptr(), wf.data_ptr(),
        rf.data_ptr(), Bph, V, K, pack, tiers[0], tiers[1],
        packed_group_size(Bph, V // _LANES, K, n_blocks, pack, tree=tree),
        _int32(seed), _int32(sweep_offset), cfg.g, n_blocks,
        cfg.alpha_eff, cfg.gamma_shape, cfg.gamma_rate, int(tree),
        block_threads(V // _LANES, tree), stream)
    _raise_on(rc, "segment_packed")
    return MixtureState(wf, rf), W, R


def segment_packed(seed: int, sweep_offset: int, state: MixtureState,
                   values, counts, cfg: GibbsConfig, n_blocks: int,
                   tiers: Tuple[int, int], pack: int, seg_mask=None,
                   tree: bool = False):
    """K3: advance every packed logical lane ``n_blocks * cfg.g`` sweeps
    in one launch (operands as :func:`segment_packed_torch`); ``tree``
    launches its binary-splitting form (K4).

    CPU tensors run :func:`segment_packed_torch`; CUDA tensors launch the
    kernel, which takes slots that each own one contiguous column range,
    as both packings give them. Returns (state, W, R), slot-ordered, W/R
    (pack * Bph, n_blocks, K)."""
    if values.device.type == "cpu":
        return segment_packed_torch(seed, sweep_offset, state, values,
                                    counts, cfg, n_blocks, tiers, pack,
                                    seg_mask, tree)
    v, c, slot = _packed_operands(state, values, counts, cfg.ncomp, tiers,
                                  pack, seg_mask, check_slots=False)
    if slot.device != v.device:
        raise ValueError("CUDA kernel operands must all lie on one CUDA "
                         f"device; got {slot.device} and {v.device}")
    w, r, v, c = _cuda_inputs(state, v, c, cfg.ncomp)
    out = _launch_packed(
        _library(), torch.cuda.current_stream(v.device).cuda_stream, seed,
        sweep_offset, w, r, v, c, _ranges_for(seg_mask, counts, slot, c, pack),
        cfg, n_blocks, tiers, pack, tree)
    _count_launch(segment_packed, tree)
    return out


for _fn in (sweep_stats, segment, segment_packed):
    _fn.launches = 0        # the chain forms' kernels (K1, K2, K3)
    _fn.tree_launches = 0   # their tree forms (K4)


def pad_tiers_to_rows(tiers: Tuple[int, int], V: int) -> Tuple[int, int]:
    """Round column tier boundaries up to whole 128-column rows (larger
    tiers are always safe: each sampler is exact on its tier's counts)."""
    up = lambda x: -(-x // _LANES)  # noqa: E731
    head = min(up(tiers[0]), V // _LANES)
    small = min(max(up(tiers[1]), head), V // _LANES)
    return head, small


def transcendentals_per_sweep(B: int, V: int, pack: int,
                              tiers: Tuple[int, int], K: int,
                              phys: Optional[Tuple[int, ...]] = None) -> int:
    """Static count of the exp/log/sqrt one sweep of a bucket executes,
    padded lanes and columns included (``pallas_sweep.
    transcendentals_per_sweep``, exactly): the roofline numerator of
    ``vpu_transcendental_util``.

    Per physical row and component step: K exps per element for the
    suffix sums; a head row pays the inversion's exp + log, ~6 BTRS rounds
    of ~5 log/sqrt and the 2-lgamma setup; a small row exp + log;
    singleton rows none. The conjugate draw adds ~3 per Marsaglia-Tsang
    round over the (pack, G, K) state. ``phys`` is a mixed bucket's
    (SL, head_rows, small_rows[, Bph]) physical layout; ``tiers`` are
    column tiers otherwise."""
    if phys is not None:
        SL, head, small = phys[:3]
        Bph = phys[3] if len(phys) > 3 else -(-B // pack)
    elif pack > 1:
        W = _LANES // pack
        SL = V // W
        head, small = packed_row_tiers(tiers, W, SL)
        Bph = -(-B // pack)
    else:
        SL = max(V // _LANES, 1)
        head, small = pad_tiers_to_rows(tiers, max(V, _LANES))
        Bph = B
    # padded physical lane count (the reference layout's G choice)
    NG = -(-Bph // _GROUP)
    G = max(8, (-(-Bph // NG) + 7) // 8 * 8)
    lanes = NG * G
    suffix = K * SL * _LANES                          # exps per lane
    chain = 0
    for _ in range(K - 1):
        chain += head * _LANES * (2 + 6 * 5 + 5)        # head rows
        chain += max(small - head, 0) * _LANES * 2      # small rows
    conj = 2 * pack * K * (_MT_ROUNDS * 3 + 2)        # per physical lane
    return int(lanes * (suffix + chain + conj))
