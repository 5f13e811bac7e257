"""Multi-host execution.

Port of ``basicrta_tpu.parallel.distributed`` on ``torch.distributed``
with the gloo backend, the counterpart of ``jax.distributed``. Residues
are independent, so a cluster runs the reference's Slurm-array shape at
device speed: every host runs the same command over its own residue
subset (:func:`host_residue_partition`) with its own cards (``--ndevices
0``), writing into the shared ``basicrta-{cutoff}/{res}/`` tree. Sampling
needs no collectives; the process group gives each host its rank and the
world size, and a host that cannot join an advertised cluster stops.

Typical launch, the same command on every host (``torchrun`` sets
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``)::

    torchrun --nnodes 2 --nproc-per-node 1 --rdzv-backend c10d \\
        --rdzv-endpoint HOST0:29500 -m basicrta_torch.cli gibbs \\
        --contacts contacts_7.0.npz --multihost --ndevices 0
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch.distributed as dist

__all__ = ["initialize", "is_multihost", "host_residue_partition"]

_initialized = False


def _cluster_env_detected() -> bool:
    """True when the environment advertises a multi-process cluster.

    Tells 'no cluster here' (an expected single-process no-op) from 'there
    IS a cluster but joining it failed': the latter must never be
    swallowed, or a degraded host would run single-process, take ALL
    residues in :func:`host_residue_partition`, and race the other hosts'
    writes into the shared results tree."""
    def size(var):
        try:
            return int(os.environ.get(var, "1"))
        except ValueError:
            return 1

    if os.environ.get("MASTER_ADDR") and size("WORLD_SIZE") > 1:
        return True
    return any(size(var) > 1 for var in (
        "SLURM_JOB_NUM_NODES", "SLURM_NNODES", "OMPI_COMM_WORLD_SIZE",
        "PMI_SIZE"))


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               timeout_s: float = 300.0) -> None:
    """Join this process into the cluster's gloo process group
    (idempotent).

    With no arguments it joins from ``env://`` when ``MASTER_ADDR`` is set
    (``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as ``torchrun`` exports
    them); with none of that it is a no-op (a single process). Explicit
    arguments (``init_method`` such as ``tcp://host:port``) always join.
    A failed join raises when the arguments were explicit or a cluster is
    advertised (:func:`_cluster_env_detected`); it never falls back to a
    single process that would take every residue. Call it before anything
    touches CUDA."""
    global _initialized
    if _initialized:
        return
    explicit = any(a is not None for a in (init_method, world_size, rank))
    if dist.is_initialized():
        pass
    elif explicit or os.environ.get("MASTER_ADDR"):
        kwargs = {k: v for k, v in (("world_size", world_size),
                                    ("rank", rank)) if v is not None}
        try:
            dist.init_process_group(
                "gloo", init_method=init_method or "env://",
                timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
        except (RuntimeError, ValueError):
            if explicit or _cluster_env_detected():
                raise
    elif _cluster_env_detected():
        raise RuntimeError(
            "the environment advertises a multi-process cluster (Slurm, "
            "Open MPI or PMI) but names no rendezvous: export MASTER_ADDR, "
            "MASTER_PORT, RANK and WORLD_SIZE (torchrun does) or pass "
            "init_method, world_size and rank")
    _initialized = True


def _world() -> tuple:
    """(world size, rank) of the process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_multihost() -> bool:
    return _world()[0] > 1


def host_residue_partition(labels):
    """This host's residue subset: every host runs the same command over
    its own residues with its local cards, writing into the shared
    ``basicrta-{cutoff}/{res}/`` tree. No cross-host tensors, and the
    failure/rerun sentinel contract (``missing_residues`` +
    ``--rerun-missing``) works unchanged across hosts. Round-robin over
    the sorted labels, so event-count skew spreads evenly."""
    n, i = _world()
    return [lab for j, lab in enumerate(sorted(labels)) if j % n == i]
