"""basicrta_torch — the PyTorch/CUDA port of basicrta_tpu.

From a trajectory file to τ on one NVIDIA H100: topologies and
trajectories are read by ``io`` (the C++ codec in ``native/``), contact
frames are extracted by torch ops and merged into residence events
(``contacts``), residence times are bucketed into lanes (``sampler.batch``), every lane runs its collapsed
sweeps inside one hand-written CUDA kernel (``sampler.cuda_sweep``,
``csrc/sweep.cu``), and the thinned samples are clustered and reduced to
τ with a credible interval (``postprocess``, ``protein.driver``). Each
event's membership probabilities map back onto its frames as reduced
trajectories and weighted densities (``kinetics``), and the protein's
outputs are tables, figures (``plots``) and a b-factor-coloured PDB.

Module and function names follow ``basicrta_tpu`` so each piece has an
obvious counterpart in the JAX reference. The package imports ``torch``
and never ``jax``; on the CPU every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from basicrta_torch.config import GibbsConfig

__all__ = ["GibbsConfig", "__version__"]
