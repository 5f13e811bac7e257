"""Moving data between the JAX package and the port.

Both packages exchange numpy arrays: sampler state, buckets and thinned
samples go through :func:`to_numpy`, and a bucket built by
``basicrta_tpu.sampler.batch.bucket_residues`` becomes the port's with
:func:`from_jax_batch`. Checkpoints and ``gibbs_*.npz`` artifacts are numpy
already and load in either package.
"""

from __future__ import annotations

import numpy as np
import torch

from basicrta_torch.sampler.batch import ResidueBatch
from basicrta_torch.sampler.kernels import MixtureState


def to_numpy(x):
    """numpy view of a tensor, a JAX array, or a MixtureState of either."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(f) for f in x))
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_state(state, device=None) -> MixtureState:
    """The port's f32 MixtureState from either package's state."""
    w, r = to_numpy(state)
    return MixtureState(torch.as_tensor(w, dtype=torch.float32,
                                        device=device),
                        torch.as_tensor(r, dtype=torch.float32,
                                        device=device))


def from_jax_batch(batch) -> ResidueBatch:
    """The port's ResidueBatch from an unpacked JAX ResidueBatch (the
    ``ladder='pow2'`` layout: ``pack == 1``, no mixed-width bounds)."""
    if getattr(batch, "pack", 1) != 1 or getattr(batch, "bounds",
                                                 None) is not None:
        raise ValueError("only unpacked buckets (pack=1) have a "
                         "counterpart in the port")
    return ResidueBatch(list(batch.names), np.asarray(batch.values),
                        np.asarray(batch.counts), np.asarray(batch.n_events),
                        tuple(batch.tiers))
