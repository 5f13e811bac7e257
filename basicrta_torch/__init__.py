"""basicrta_torch — the PyTorch/CUDA port of basicrta_tpu.

The per-residue Gibbs main path on one NVIDIA H100: residence times are
bucketed into lanes (``sampler.batch``), every lane runs its collapsed
sweeps inside one hand-written CUDA kernel (``sampler.cuda_sweep``,
``csrc/sweep.cu``), and the thinned samples are clustered and reduced to
τ with a credible interval (``postprocess``, ``protein.driver``).

Module and function names follow ``basicrta_tpu`` so each piece has an
obvious counterpart in the JAX reference. The package imports ``torch``
and never ``jax``; on the CPU every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from basicrta_torch.config import GibbsConfig

__all__ = ["GibbsConfig", "__version__"]
