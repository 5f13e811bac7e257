"""Sampler configuration.

The port's own copy of the JAX package's ``GibbsConfig``: the same fields,
defaults, derived properties and JSON form, so the ``cfg`` JSON stored in
NPZ artifacts is byte-identical in both packages and an artifact written
by either loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

__all__ = ["GibbsConfig"]


@dataclasses.dataclass(frozen=True)
class GibbsConfig:
    """Configuration of the exponential-mixture Gibbs sampler.

    Defaults reproduce the reference: 15 components, 110,000 sweeps,
    thinning every 100 sweeps, 10,000 burn-in sweeps, a Dirichlet prior
    of 1/ncomp per component, a Gamma(1, 3) prior on the rates, a noise
    cutoff of 0.4, a weight cutoff of 10 events / N and 117 GMM restarts.
    The library runs one chain per residue; the CLI runs two.
    """

    ncomp: int = 15
    niter: int = 110_000
    g: int = 100                      # thinning interval
    burnin: int = 10_000              # sweeps discarded before analysis
    alpha: Optional[float] = None     # Dirichlet prior; None -> 1/ncomp
    gamma_shape: float = 1.0          # Gamma prior shape a
    gamma_rate: float = 3.0           # Gamma prior rate b
    noise_cutoff: float = 0.4         # pindicator max below this -> noise
    weight_cut_events: float = 10.0   # wcutoff = weight_cut_events / N
    gmm_n_init: int = 117             # GMM restarts during clustering
    gmm_max_iter: int = 100           # EM iterations per restart
    gmm_tol: float = 1e-3             # EM convergence tolerance
    n_chains: int = 1                 # independent chains per residue
    seed: int = 0

    @property
    def n_samples(self) -> int:
        """Thinned posterior samples kept per chain (sweeps g, 2g, ...)."""
        return self.niter // self.g

    @property
    def burnin_samples(self) -> int:
        return self.burnin // self.g

    @property
    def alpha_eff(self) -> float:
        return (1.0 / self.ncomp) if self.alpha is None else self.alpha

    def wcutoff(self, n_events: int) -> float:
        return self.weight_cut_events / float(n_events)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "GibbsConfig":
        return cls(**json.loads(s))
