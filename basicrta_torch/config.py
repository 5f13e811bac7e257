"""Sampler configuration, shared with the JAX package.

``GibbsConfig`` is re-exported unchanged (``basicrta_tpu.config`` imports
no JAX), so the ``cfg`` JSON stored in NPZ artifacts is byte-identical in
both packages and an artifact written by either loads in the other.
"""

from basicrta_tpu.config import GibbsConfig

__all__ = ["GibbsConfig"]
