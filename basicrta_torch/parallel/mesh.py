"""Sharding of the Gibbs workload over several devices of one process.

Port of ``basicrta_tpu.parallel.mesh``. The JAX package drives one process
per host over a ``Mesh`` of that host's devices and splits arrays with
``shard_map``; here one process drives a list of ``torch.device``s laid
out as a (lanes, events) grid, and each shard is a slice of the tensors
placed on its device:

- **lane (data) parallelism**: the residue x chain lanes of a bucket are
  split over the 'lanes' axis; every shard sweeps its own lanes and no
  shard reads another's (``sampler.batch.run_batch(sharding=...)``);
- **event (value) parallelism**: the unique-value axis of each lane is
  split over the 'events' axis; every shard draws the multinomial counts
  of its columns, the sufficient statistics (N_k, T_k) are summed on the
  lane shard's first device each sweep (the JAX package's ``psum``), and
  the conjugate update runs there once, so the chain state stays one.

No collective library is involved inside a process. A mesh may name one
device several times (two shards on one card, or the CPU n times), which
is how the tests and the smoke run multi-shard layouts on one device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from basicrta_torch.config import GibbsConfig
from basicrta_torch.ops.random import seeded_generator
from basicrta_torch.sampler.kernels import (MixtureState, _conjugate_update,
                                            _log_responsibilities,
                                            _suff_stats, _thinned_scan,
                                            _tiered_multinomial)

AXES = ("lanes", "events")


def local_devices(n: Optional[int] = None, device=None) -> List[torch.device]:
    """The devices this process drives: the visible cards
    (``torch.cuda.device_count()``, the counterpart of
    ``jax.local_devices()``) unless ``device`` names the CPU, which counts
    as many times as asked (once by default). ``n`` None or 0 takes every
    visible card; more than are visible raises, as does a card request
    without one."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (n or 1)
    if kind != "cuda":
        raise ValueError(f"no mesh of {kind!r} devices; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh of cards needs a CUDA device and none is "
                           "available; pass device='cpu' for the CPU")
    visible = torch.cuda.device_count()
    if n and n > visible:
        raise ValueError(f"{n} devices asked for, {visible} cards visible")
    return [torch.device("cuda", i) for i in range(n or visible)]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (lanes, events) grid of devices; ``devices[l, e]`` runs lane shard
    l's event shard e."""
    devices: np.ndarray            # (lanes, events) object array

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str = "lanes") -> List[torch.device]:
        """One device a shard of ``axis``: each lane shard's first device,
        or lane shard 0's event devices."""
        row = self.devices[:, 0] if axis == "lanes" else self.devices[0]
        return list(row)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and the axes a (B, ...) array is split over, the stand-in
    for ``jax.sharding.NamedSharding``: ``spec`` ('lanes',) splits the
    lanes, ('lanes', 'events') the lanes and the value columns."""
    mesh: Mesh
    spec: Tuple[str, ...]

    @property
    def n_lanes(self) -> int:
        return self.mesh.shape["lanes"]

    @property
    def n_events(self) -> int:
        """Event shards the spec asks for (1 unless it names 'events')."""
        return self.mesh.shape["events"] if "events" in self.spec else 1


def make_mesh(n_lanes: Optional[int] = None, n_events: int = 1,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """A ('lanes', 'events') mesh over ``devices`` (a list, which may
    repeat a device), or over :func:`local_devices` of ``device``'s kind
    (the cards by default): ``n_lanes * n_events`` of them, or all visible
    cards with ``n_lanes`` None."""
    if devices is None:
        devices = local_devices(None if n_lanes is None
                                else n_lanes * n_events, device)
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n_lanes is None:
        n_lanes = n // n_events
    if n_lanes < 1 or n_lanes * n_events != n:
        raise ValueError(f"a mesh of {n_lanes} lanes x {n_events} events "
                         f"needs {n_lanes * n_events} devices; got {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_lanes, n_events))


def lane_sharding(mesh: Mesh) -> Sharding:
    """(B, ...) batch arrays: lanes split, the rest whole."""
    return Sharding(mesh, ("lanes",))


def event_sharding(mesh: Mesh) -> Sharding:
    """(B, V) arrays: lanes x events split."""
    return Sharding(mesh, ("lanes", "events"))


def deal_columns(values: np.ndarray, counts: np.ndarray, n_shards: int,
                 tiers: Tuple[int, int]):
    """Deal multiplicity-sorted value columns round-robin onto event
    shards, so every shard's contiguous slice stays multiplicity-descending
    and one tier pair covers all shards.

    Columns sorted descending are distributed cyclically (shard e takes
    columns e, e+E, e+2E, ...) and laid out contiguously per shard. Per-shard
    tier boundaries are the ceilings of the global ones (safe: each tier's
    sampler is exact on any smaller count).

    Returns (values, counts, per_shard_tiers).
    """
    V = values.shape[-1]
    if V % n_shards:
        raise ValueError(f"V={V} not divisible by events={n_shards}")
    per = V // n_shards
    # position e*per + j <- old column j*n_shards + e
    old = (np.arange(per)[None, :] * n_shards
           + np.arange(n_shards)[:, None]).reshape(-1)
    head = -(-tiers[0] // n_shards)
    single = max(-(-tiers[1] // n_shards), head)
    return (np.take(values, old, axis=-1), np.take(counts, old, axis=-1),
            (head, single))


def split_rows(n_rows: int, n_shards: int) -> List[slice]:
    """Equal contiguous row ranges of ``n_rows`` (a multiple of
    ``n_shards``)."""
    per = n_rows // n_shards
    return [slice(s * per, (s + 1) * per) for s in range(n_shards)]


def event_sharded_blocks(mesh: Mesh, cfg: GibbsConfig, n_blocks: int,
                         tiers: Optional[Tuple[int, int]] = None):
    """The multi-device sampler step of the collapsed sweep.

    Returns ``step(seed, state, values, counts) -> (state, W, R)`` where

    - ``seed``: an int or a tuple of ints (the run's seed, bucket salt
      and segment); lane shard l draws its conjugate update from a
      generator seeded from (seed..., l) on ``mesh.devices[l, 0]``, and
      its event shard e its multinomial counts from one seeded from
      (seed..., l, e) on ``mesh.devices[l, e]`` (the JAX
      ``fold_in(kmult, ev)``);
    - ``state``: MixtureState of (B, K) tensors;
    - ``values``/``counts``: (B, V), B a multiple of the lane shards and V
      of the event shards (lay columns out with :func:`deal_columns` to use
      the tiered sampler);
    - ``tiers``: per-shard tier boundaries from :func:`deal_columns` (None
      runs the untiered sampler).

    Each sweep every event shard draws the counts of its columns, their
    (N_k, T_k) are summed on the lane shard's first device in shard order,
    and the conjugate update runs there. Returns the advanced (B, K) state
    and the (B, n_blocks, K) thinned samples on ``mesh.devices[0, 0]``.
    """
    n_lanes, n_events = mesh.devices.shape
    home = mesh.devices[0, 0]

    def step(seed, state: MixtureState, values, counts):
        ids = tuple(seed) if isinstance(seed, tuple) else (seed,)
        B, V = values.shape
        if B % n_lanes or V % n_events:
            raise ValueError(f"(B, V) = ({B}, {V}) does not split over a "
                             f"{n_lanes} x {n_events} mesh")
        cols = split_rows(V, n_events)
        outs = []
        for ln, rows in enumerate(split_rows(B, n_lanes)):
            lead = mesh.devices[ln, 0]
            shards = [(mesh.devices[ln, e],
                       seeded_generator(mesh.devices[ln, e], *ids, ln, e),
                       values[rows, cols[e]].to(mesh.devices[ln, e]),
                       counts[rows, cols[e]].to(mesh.devices[ln, e]))
                      for e in range(n_events)]

            def sweep(gen, st, shards=shards, lead=lead):
                Ns = Ts = 0
                for dev, g_e, v, c in shards:
                    st_e = MixtureState(st.weights.to(dev), st.rates.to(dev))
                    probs = torch.softmax(_log_responsibilities(st_e, v), -1)
                    m = _tiered_multinomial(g_e, c, probs, tiers)
                    n_k, t_k = _suff_stats(v, m)
                    Ns = Ns + n_k.to(lead)
                    Ts = Ts + t_k.to(lead)
                return _conjugate_update(gen, Ns, Ts, cfg.alpha_eff,
                                         cfg.gamma_shape, cfg.gamma_rate)

            st0 = MixtureState(state.weights[rows].to(lead),
                               state.rates[rows].to(lead))
            outs.append(_thinned_scan(sweep, seeded_generator(lead, *ids, ln),
                                      st0, cfg.g, n_blocks))

        def cat(parts):
            return torch.cat([p.to(home) for p in parts])
        return (MixtureState(cat([o[0].weights for o in outs]),
                             cat([o[0].rates for o in outs])),
                cat([o[1] for o in outs]), cat([o[2] for o in outs]))

    return step


def sharded_training_step(mesh: Mesh, cfg: GibbsConfig, n_blocks: int = 1):
    """The full multi-device step: lanes (residues x chains) split over
    'lanes', unique values over 'events' with the statistics summed each
    sweep (:func:`event_sharded_blocks` without tiers)."""
    return event_sharded_blocks(mesh, cfg, n_blocks)
