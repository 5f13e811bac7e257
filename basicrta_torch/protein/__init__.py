"""Protein-level drivers: all-residue sampling and tau aggregation."""

from basicrta_torch.protein.driver import ParallelGibbs, ProcessProtein

__all__ = ["ParallelGibbs", "ProcessProtein"]
