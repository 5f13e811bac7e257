"""Samplers for post-processing.

Only what the votes need: a multinomial over the component axis for every
(saved sample, unique value) pair, as a conditional-binomial chain on
``torch.binomial`` with an explicit generator (the counterpart of
``basicrta_tpu.sampler.kernels._tiered_multinomial`` as the vote program
uses it).
"""

from __future__ import annotations

import torch


def multinomial(counts, probs, generator: torch.Generator):
    """Counts ``m[..., v, :] ~ Multinomial(counts[..., v], probs[..., v, :])``.

    Args:
        counts: (..., V) float multiplicities.
        probs: (..., V, K) rows summing to one (up to rounding).
        generator: torch.Generator on the tensors' device.
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
        draw = torch.binomial(rem, p, generator=generator)
        out.append(draw)
        rem = rem - draw
    out.append(rem)
    return torch.stack(out, -1)
