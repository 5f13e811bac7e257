"""Kinetic mapping: component trajectories and weighted densities."""

from basicrta_torch.kinetics.density import (Density, GridAccumulator,
                                             WDensity, weighted_histogram_3d)
from basicrta_torch.kinetics.mapper import MapKinetics

__all__ = ["Density", "GridAccumulator", "WDensity", "weighted_histogram_3d",
           "MapKinetics"]
