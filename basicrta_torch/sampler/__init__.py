"""The Gibbs sampler: fused sweep kernels, buckets, the reference chains
and the per-residue API."""

from basicrta_torch.sampler.kernels import (
    collapsed_sweep,
    dedup_times,
    dense_sweep,
    init_mixture_params,
    run_chain,
    run_chains,
    sample_indicator_counts,
)

__all__ = [
    "init_mixture_params",
    "dense_sweep",
    "collapsed_sweep",
    "run_chain",
    "run_chains",
    "sample_indicator_counts",
    "dedup_times",
    "Gibbs",
]

from basicrta_torch.sampler.gibbs import Gibbs  # noqa: E402 (after kernels)
