"""Samplers for post-processing.

Only what the votes need: a multinomial over the component axis for every
(saved sample, unique value) pair, as a conditional-binomial chain on
``torch.binomial`` with an explicit generator (the counterpart of
``basicrta_tpu.sampler.kernels._tiered_multinomial`` as the vote program
uses it). A batch of residues passes one generator per residue, so each
residue's draws are its own whatever shares the batch.
"""

from __future__ import annotations

import torch


def multinomial(counts, probs, generator):
    """Counts ``m[..., v, :] ~ Multinomial(counts[..., v], probs[..., v, :])``.

    Args:
        counts: (..., V) float multiplicities.
        probs: (..., V, K) rows summing to one (up to rounding).
        generator: a torch.Generator on the tensors' device, or a sequence
            of them, one per index of the leading axis, each drawing that
            slice's binomials.
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
