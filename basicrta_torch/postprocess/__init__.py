"""Posterior post-processing: filtering, clustering, tau estimation."""

from basicrta_torch.postprocess.gmm import gmm_fit_predict
from basicrta_torch.postprocess.clustering import (
    component_counts,
    select_lmode,
    gather_cluster_data,
    cluster_samples,
    accumulate_cluster_votes,
    sort_labels_by_rate,
    ClusterResult,
)
from basicrta_torch.postprocess.tau import estimate_params, estimate_tau
from basicrta_torch.postprocess.batched import process_residues_batched

__all__ = [
    "gmm_fit_predict",
    "component_counts",
    "select_lmode",
    "gather_cluster_data",
    "cluster_samples",
    "accumulate_cluster_votes",
    "sort_labels_by_rate",
    "ClusterResult",
    "estimate_params",
    "estimate_tau",
    "process_residues_batched",
]
