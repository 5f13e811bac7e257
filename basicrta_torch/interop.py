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
    """The port's ResidueBatch from a JAX ResidueBatch of any layout: the
    pow2 ladder, uniform packing (``pack > 1``) or k-way mixed widths
    (``bounds``, ``phys_rows``). A packed bucket whose widths do not name
    one slot per member, or do not match ``pack``, is refused."""
    pack = int(getattr(batch, "pack", 1))
    bounds = getattr(batch, "bounds", None)
    phys_rows = int(getattr(batch, "phys_rows", 0))
    if bounds is not None:
        bounds = np.asarray(bounds, np.int64)
        if (bounds.ndim != 2 or bounds.shape[1] != pack or pack < 2
                or int((bounds > 0).sum()) != len(batch.names)
                or phys_rows < 1):
            raise ValueError(
                f"malformed mixed-width bucket: bounds "
                f"{bounds.shape} for pack {pack}, {len(batch.names)} "
                f"members, phys_rows {phys_rows}")
    elif pack < 1 or 128 % pack:
        raise ValueError(f"malformed packed bucket: pack {pack}")
    return ResidueBatch(list(batch.names), np.asarray(batch.values),
                        np.asarray(batch.counts), np.asarray(batch.n_events),
                        tuple(batch.tiers), pack=pack, bounds=bounds,
                        phys_rows=phys_rows)
