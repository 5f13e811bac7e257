"""Precise f32 transcendentals for precision-amplified sampler sites.

Bit-for-bit ports of ``basicrta_tpu.ops.precise``: bit manipulation plus
polynomials (~2 ulp), used where a large count amplifies the error of a
log or exp (the binomial PMF anchor ``exp(n log q)`` and the BTRS Stirling
terms). The CUDA kernel in ``csrc/sweep.cu`` carries the same polynomials.
Non-f32 dtypes fall through to the native ops, as in the reference.
"""

from __future__ import annotations

import torch

__all__ = ["log_f32", "exp_f32", "gammaln_f32", "pow_smallint",
           "stirling_tail"]


def _log_f32_impl(x):
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)  # [1, 2)
    big = m > 1.4142135
    m = torch.where(big, m * 0.5, m)                 # -> [sqrt2/2, sqrt2)
    e = e + big.to(torch.int32)
    s = (m - 1.0) / (m + 1.0)                        # |s| <= 0.1716
    s2 = s * s
    p = 2.0 * s * (1.0 + s2 * (1.0 / 3.0 + s2 * (
        1.0 / 5.0 + s2 * (1.0 / 7.0 + s2 / 9.0))))
    return p + e.to(torch.float32) * 0.6931471805599453


_LN2_HI = 0.693359375          # ln2 split: hi exact in f32, lo the rest
_LN2_LO = -2.12194440e-4


def _exp_f32_impl(x):
    x = torch.clamp(x, -87.0, 88.0)
    kf = torch.round(x * 1.4426950408889634)        # half to even
    r = (x - kf * _LN2_HI) - kf * _LN2_LO            # |r| <= ln2/2
    p = 1.0 + r * (1.0 + r * (0.5 + r * (
        1.0 / 6.0 + r * (1.0 / 24.0 + r * (
            1.0 / 120.0 + r * (1.0 / 720.0 + r / 5040.0))))))
    scale = ((kf.to(torch.int32) + 127) << 23).view(torch.float32)
    return p * scale


def log_f32(x):
    """log(x) to ~2 ulp for f32; native log for other dtypes."""
    if x.dtype != torch.float32:
        return torch.log(x)
    return _log_f32_impl(x)


def exp_f32(x):
    """exp(x) to ~2 ulp for f32; native exp for other dtypes. Underflows
    to 0 below exp(-87)."""
    if x.dtype != torch.float32:
        return torch.exp(x)
    return _exp_f32_impl(x)


def gammaln_f32(x):
    """log-Gamma via Stirling with a 6-term shift for x < 6; only the
    amplified (x - 0.5) log x term pays for the polynomial log."""
    if x.dtype != torch.float32:
        return torch.lgamma(x)
    small = x < 6.0
    xb = torch.where(small, x, 1.0)
    prod = (xb * (xb + 1.0) * (xb + 2.0) * (xb + 3.0) * (xb + 4.0)
            * (xb + 5.0))
    xs = torch.where(small, x + 6.0, x)
    inv = 1.0 / xs
    inv2 = inv * inv
    series = inv * (1.0 / 12.0 - inv2 * (1.0 / 360.0 - inv2 / 1260.0))
    lg = ((xs - 0.5) * _log_f32_impl(xs) - xs + 0.9189385332046727
          + series)
    return lg - torch.where(small, torch.log(prod), 0.0)


# Stirling-tail exact values for integer x = 0..9; the 3-term asymptotic
# series takes over at x >= 9.5
_ST_TABLE = (0.08106146679532726, 0.04134069595540929, 0.02767792568499834,
             0.02079067210376509, 0.01664469118982119, 0.01387612882307075,
             0.01189670994589177, 0.01041126526197209, 0.00925546218271273,
             0.00833056343336287)


def stirling_tail(x):
    """t(x) = lgamma(x+1) - [(x+0.5) ln(x+1) - (x+1) + 0.5 ln(2 pi)], pure
    rational arithmetic (Hormann 1993's f_c): table below 9.5, series
    beyond."""
    w = x + 1.0
    inv = 1.0 / w
    inv2 = inv * inv
    s = inv * (1.0 / 12.0 - inv2 * (1.0 / 360.0 - inv2 / 1260.0))
    for i in range(9, -1, -1):
        s = torch.where(x < i + 0.5, _ST_TABLE[i], s)
    return s


def pow_smallint(q, n, bits: int):
    """q**n for integer-valued n < 2**bits by binary exponentiation."""
    result = torch.ones_like(q)
    base = q
    e = n
    for _ in range(bits):
        half = torch.floor(e * 0.5)
        odd = e - 2.0 * half
        result = result * torch.where(odd > 0.5, base, 1.0)
        base = base * base
        e = half
    return result
