"""Sampler and contact-map configuration.

The port's own copies of the JAX package's ``GibbsConfig`` and
``ContactConfig``: the same fields, defaults, derived properties and JSON
form, so the ``cfg`` JSON stored in NPZ artifacts is byte-identical in
both packages and an artifact written by either loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

__all__ = ["GibbsConfig", "ContactConfig"]


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


@dataclasses.dataclass(frozen=True)
class ContactConfig:
    """Configuration of contact-map extraction and event merging.

    Defaults reproduce the reference: primary (map) cutoff 10.0 A,
    analysis cutoff typically 7.0 A, and trajectory chunking as a memory
    valve, expressed as frames per device batch.
    """

    map_cutoff: float = 10.0     # primary contact-map cutoff [A]
    cutoff: float = 7.0          # analysis cutoff imposed on the map [A]
    frames_per_batch: int = 32   # trajectory frames per device batch
    # per-frame capacity of the device-compacted contact transfer; frames
    # with more sub-cutoff pairs trigger an exact dense-transfer fallback
    transfer_cap: int = 2048
    use_pbc: bool = True         # minimum-image convention
    # bounding-sphere prefilter: skip residue pairs whose centroid-distance
    # lower bound clears the map cutoff (exact, see
    # distances.min_dist_pruned). 'auto' enables it when the dense
    # kernel's per-frame atom-pair count crosses prefilter_auto_pairs (the
    # JAX package's crossover; not remeasured on the card); True/False
    # force it.
    prefilter: object = "auto"
    # per-frame packing capacity for plausible residue pairs. The exact
    # atom sweep and the device->host transfer scale with the cap, so the
    # mapper adapts it: batches run at the smallest power-of-two cap that
    # held every frame so far (x1.25 margin, floor prefilter_cap_min), a
    # frame overflowing the current cap is redone at the exact fit, and
    # prefilter_cap is the ceiling past which the batch falls back to the
    # dense kernel (exactness is guarded at every step). Set
    # prefilter_cap_min == prefilter_cap to pin a static cap.
    prefilter_cap: int = 32768
    prefilter_cap_min: int = 256
    prefilter_auto_pairs: int = 128_000_000
    # coordinate wire format for the host->device upload: 'f32' (exact)
    # or 'u16', per-frame affine quantization onto the 16-bit grid
    # spanning each axis's coordinate extent: half the upload bytes for a
    # coordinate error <= extent/65535/2 (~0.002 A at a 240 A box; XTC
    # trajectories natively store a 0.01 A grid). Works with any box
    # geometry or none. The CLI picks 'u16' for XTC-only inputs.
    upload_dtype: str = "f32"
    # host-memory valve: accumulated contact rows spill to an on-disk
    # memmap past this budget; 0 disables spilling
    host_row_budget: int = 8_000_000

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "ContactConfig":
        return cls(**json.loads(s))
