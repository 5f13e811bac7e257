"""Exact samplers for the reference chains and the votes.

Ports of ``basicrta_tpu.ops.random``. Each takes an explicit
``torch.Generator`` on the tensors' device and draws on that device.

The JAX package unrolls its own fixed-round rejection samplers because a
``lax.while_loop`` costs ~100 us of control-flow latency a call on a TPU
(``basicrta_tpu/ops/random.py:1-17``). That reason does not hold on a GPU,
so torch's own samplers stand in where they pass the JAX package's
battery (``tests/test_torch_random.py``): ``torch.binomial`` for
``binomial``, ``torch._standard_gamma`` for ``gamma`` and normalised gammas
for ``dirichlet``. The bounded samplers are exact by construction: a
Binomial(n <= nmax, p) is the sum of n Bernoulli trials and a
Multinomial(n <= nmax, probs) the sum of n inverse-CDF categorical draws,
each from nmax uniforms a row. On the card that is a few launches for a
whole tier where the JAX package's (nmax + 1)-term PMF table costs ~24
eager launches a chain stage.

Gamma and Dirichlet draws are clamped to the smallest normal f32, as in
the JAX package: the prior's shape 1/K gives draws below f32 range, and
``log`` of them must stay finite.
"""

from __future__ import annotations

import hashlib

import torch

_TINY = torch.finfo(torch.float32).tiny


def seeded_generator(device, *ids) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``ids`` (a seed,
    then salts, segment or shard indices): each tuple its own stream."""
    key = ":".join(str(int(i)) for i in ids).encode()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(hashlib.sha256(key).digest()[:8],
                                   "little") & 0x7FFFFFFFFFFFFFFF)
    return gen


def binomial(n, p, generator):
    """Exact Binomial(n, p) draws, elementwise over broadcast shapes, as
    float counts in [0, max(n, 0)]."""
    n, p = torch.broadcast_tensors(n, p)
    n = torch.clamp_min(n, 0.0)
    return torch.binomial(n, torch.clamp(p, 0.0, 1.0), generator=generator)


def gamma(a, generator):
    """Gamma(a, 1) draws, clamped below at the smallest normal f32."""
    return torch.clamp_min(torch._standard_gamma(a, generator=generator),
                           _TINY)


def dirichlet(alpha, generator):
    """Dirichlet(alpha) over the last axis via normalised gammas."""
    g = gamma(alpha, generator)
    return g / g.sum(-1, keepdim=True)


def binomial_small(n, p, nmax: int, generator):
    """Exact Binomial(n, p) for n <= ``nmax``: the count of the first n of
    nmax uniforms that fall below p."""
    n, p = torch.broadcast_tensors(n, p)
    u = torch.rand(n.shape + (nmax,), generator=generator, dtype=p.dtype,
                   device=p.device)
    trial = torch.arange(nmax, device=p.device)
    hit = (u < torch.clamp(p, 0.0, 1.0)[..., None]) & (trial < n[..., None])
    return hit.sum(-1).to(p.dtype)


def multinomial(counts, probs, generator):
    """Counts ``m[..., v, :] ~ Multinomial(counts[..., v], probs[..., v, :])``
    by the conditional-binomial chain on ``torch.binomial``.

    Args:
        counts: (..., V) float multiplicities.
        probs: (..., V, K) rows summing to one (up to rounding).
        generator: a torch.Generator on the tensors' device, or a sequence
            of them, one per index of the leading axis, each drawing that
            slice's binomials (the votes pass one a residue, so each
            residue's draws are its own whatever shares the batch).
    Returns:
        (..., V, K) float counts; each row sums to ``counts`` exactly.
    """
    K = probs.shape[-1]
    tail = torch.flip(torch.cumsum(torch.flip(probs, [-1]), -1), [-1])
    rem = counts
    out = []
    for k in range(K - 1):
        p = torch.clamp(probs[..., k] / torch.clamp_min(tail[..., k], 1e-30),
                        0.0, 1.0)
        if isinstance(generator, torch.Generator):
            draw = torch.binomial(rem, p, generator=generator)
        else:
            draw = torch.stack([torch.binomial(rem[i], p[i], generator=g)
                                for i, g in enumerate(generator)])
        out.append(draw)
        rem = rem - draw
    out.append(rem)
    return torch.stack(out, -1)


def multinomial_small(n, probs, nmax: int, generator):
    """Exact Multinomial(n, probs) for n <= ``nmax``: the sum of n
    inverse-CDF categorical draws (nmax uniforms a row)."""
    K = probs.shape[-1]
    cdf = torch.cumsum(probs, -1)
    u = torch.rand(n.shape + (nmax,), generator=generator, dtype=probs.dtype,
                   device=probs.device)
    # the count of CDF entries below u: the searchsorted of a CDF, which
    # never decreases
    comp = torch.clamp_max(torch.searchsorted(cdf.contiguous(), u), K - 1)
    live = torch.arange(nmax, device=probs.device) < n[..., None]
    return torch.zeros_like(probs).scatter_add_(-1, comp,
                                                live.to(probs.dtype))


def multinomial_single(n, probs, generator):
    """Exact Multinomial for n in {0, 1}: one inverse-CDF categorical draw
    a row, scaled by n. The dominant tier of real residence-time data,
    where most unique values occur once."""
    cdf = torch.cumsum(probs, -1)
    u = torch.rand(n.shape, generator=generator, dtype=probs.dtype,
                   device=probs.device)
    comp = torch.clamp_max((u[..., None] > cdf).sum(-1), probs.shape[-1] - 1)
    return torch.zeros_like(probs).scatter_(-1, comp[..., None],
                                            n[..., None].to(probs.dtype))
