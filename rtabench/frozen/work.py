"""The work-count arithmetic of the sweep kernels' roofline, frozen.

:func:`transcendentals_per_sweep` is a copy of the port's static count
(``basicrta_torch.sampler.cuda_sweep.transcendentals_per_sweep``, padded
lanes and columns included), kept so the tests can show the per-lane count
below is the same arithmetic. :func:`lane_transcendentals` applies it to one
lane's own inputs, unpadded: its unique times, their multiplicity tiers and
K. The sum over the lanes of a run is therefore the same whatever layout or
kernel the program picks.

The peak is the card's published special-function rate: 16 exp2 results a
clock an SM (Hopper's MUFU), 132 SMs, the card's maximum SM clock.
"""

from __future__ import annotations

import numpy as np

LANES = 128          # columns of a physical lane
GROUP = 64           # lanes a group of the reference layout
MT_ROUNDS = 8        # Marsaglia-Tsang rounds a gamma draw counts
SMALL_NMAX = 16      # multiplicity bound of the bounded (small) tier
HEAD_COST = 2 + 6 * 5 + 5   # a head element's inversion, BTRS rounds, set-up
SMALL_COST = 2              # a small element's exp + log
MUFU_PER_CLOCK = 16
SMS = 132


def pad_tiers_to_rows(tiers, V):
    up = lambda x: -(-x // LANES)  # noqa: E731
    head = min(up(tiers[0]), V // LANES)
    small = min(max(up(tiers[1]), head), V // LANES)
    return head, small


def packed_row_tiers(tiers, seg_width, SL):
    up = lambda x: -(-x // seg_width)  # noqa: E731
    head = min(up(tiers[0]), SL)
    small = min(max(up(tiers[1]), head), SL)
    return head, small


def transcendentals_per_sweep(B, V, pack, tiers, K, phys=None):
    """The port's static count of the exp/log/sqrt of one sweep of a
    bucket, padded lanes and columns included."""
    if phys is not None:
        SL, head, small = phys[:3]
        Bph = phys[3] if len(phys) > 3 else -(-B // pack)
    elif pack > 1:
        W = LANES // pack
        SL = V // W
        head, small = packed_row_tiers(tiers, W, SL)
        Bph = -(-B // pack)
    else:
        SL = max(V // LANES, 1)
        head, small = pad_tiers_to_rows(tiers, max(V, LANES))
        Bph = B
    NG = -(-Bph // GROUP)
    G = max(8, (-(-Bph // NG) + 7) // 8 * 8)
    lanes = NG * G
    suffix = K * SL * LANES
    chain = 0
    for _ in range(K - 1):
        chain += head * LANES * HEAD_COST
        chain += max(small - head, 0) * LANES * SMALL_COST
    conj = 2 * pack * K * (MT_ROUNDS * 3 + 2)
    return int(lanes * (suffix + chain + conj))


def lane_tiers(counts):
    """(head, small) element counts of one lane: multiplicities above
    ``SMALL_NMAX``, and from 2 to ``SMALL_NMAX``."""
    c = np.asarray(counts)
    return int((c > SMALL_NMAX).sum()), int(((c > 1) & (c <= SMALL_NMAX)).sum())


def lane_transcendentals(counts, K):
    """Transcendentals one sweep of one lane needs, from its own unique
    times' multiplicities ``counts`` (zeros are not times): K exps a unique
    time, the head and small tiers' draws over K - 1 component steps, and
    the conjugate draw's 2K gammas."""
    c = np.asarray(counts)
    c = c[c > 0]
    head, small = lane_tiers(c)
    return int(K * c.size + (K - 1) * (head * HEAD_COST + small * SMALL_COST)
               + 2 * K * (MT_ROUNDS * 3 + 2))


def sfu_peak(max_sm_clock_mhz):
    """The card's published special-function peak [results/s]."""
    return MUFU_PER_CLOCK * SMS * max_sm_clock_mhz * 1e6
