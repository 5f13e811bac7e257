"""Numerics shared across pipeline stages (host + device helpers)."""

from basicrta_torch.ops.diagnostics import (
    convergence_report,
    effective_sample_size,
    split_rhat,
)
from basicrta_torch.ops.surv import (
    survival_function,
    survival_bins,
    empirical_ci,
    ci_bars,
    infer_timestep,
    decimals_of,
    start_stop_frames,
    simulate_hyperexp,
    unique_rate_count,
)

__all__ = [
    "survival_function",
    "survival_bins",
    "empirical_ci",
    "ci_bars",
    "infer_timestep",
    "decimals_of",
    "start_stop_frames",
    "simulate_hyperexp",
    "unique_rate_count",
    "split_rhat",
    "effective_sample_size",
    "convergence_report",
]
