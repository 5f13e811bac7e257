"""Importers for the reference package's pickled artifacts.

Port of ``basicrta_tpu.io.legacy``: the same restricted unpickler and
allowlists, returning this package's ``ContactRecords`` /
``ContactEvents`` / ``Gibbs``.

The reference persists live objects: contact tables as pickled
``np.memmap`` row matrices whose dtype *metadata* carries MDAnalysis
AtomGroups (reference contacts.py:79-94), and whole ``Gibbs`` instances
(reference gibbs.py:336-349). Loading those normally requires ``basicrta``
and ``MDAnalysis`` installed. Here a restricted unpickler substitutes
inert stubs for any class from those packages while allowing the numpy
payload through — so finished contact maps, residence-event tables, and
sampler chains migrate into this framework without the legacy stack:

    events = load_reference_contacts("contacts_7.0.pkl")   # -> ContactEvents
    g = load_reference_gibbs("basicrta-7.0/W313/gibbs_110000.pkl")
    g.process_gibbs()                          # on the card by default

Class resolution is allowlisted: numpy array-reconstruction machinery,
container types, and stubbed basicrta/MDAnalysis classes; everything else
(including ``builtins`` callables like ``eval``) is refused. This blocks
the standard pickle code-execution gadgets, but pickle is not a security
boundary — still only load files you (or someone you trust) created.
"""

from __future__ import annotations

import pickle
from typing import Union

import numpy as np

from basicrta_torch.contacts.records import (ContactEvents, ContactMeta,
                                             ContactRecords)

__all__ = ["load_reference_pickle", "load_reference_contacts",
           "load_reference_gibbs"]

_STUBBED_ROOTS = ("basicrta", "MDAnalysis")
# exact (module, name) pairs of the array/dtype reconstruction machinery a
# numpy pickle legitimately references (both the numpy<2 'numpy.core' and
# numpy>=2 'numpy._core' spellings). Whole-module allowlisting is unsafe:
# 'numpy' itself exposes file-writing callables (numpy.save, numpy.fromfile)
# a crafted pickle could invoke. '_frombuffer' here is numpy's protocol-5
# reconstructor over in-band bytes — no file or code access.
_ALLOWED_CLASSES = frozenset({
    ("numpy", "ndarray"), ("numpy", "dtype"), ("numpy", "memmap"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
    ("_codecs", "encode"),               # protocol-2 bytes round-trip
    ("collections", "OrderedDict"),
    ("collections", "defaultdict"),
    ("collections", "deque"),
    ("collections", "Counter"),
    ("copyreg", "_reconstructor"),
})
# builtins are dangerous wholesale (eval/exec/getattr...); allow only the
# plain container/scalar types pickles legitimately reference
_ALLOWED_BUILTINS = frozenset({
    "complex", "frozenset", "set", "slice", "range", "bytearray",
})


class _Opaque:
    """Inert stand-in for legacy-package classes: captures constructor
    args / state without executing any legacy code."""

    def __init__(self, *args, **kwargs):
        self._args, self._kwargs = args, kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _RefUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in _STUBBED_ROOTS:
            return _Opaque
        # protocol-4 STACK_GLOBAL resolves dotted names as attribute
        # chains (e.g. ('numpy', 'random.default_rng')); legit numpy
        # pickles never need that, so refuse it outright
        if "." not in name and (
                (module, name) in _ALLOWED_CLASSES
                or (module == "builtins" and name in _ALLOWED_BUILTINS)):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"blocked class {module}.{name} (only numpy payloads and "
            f"stubbed {_STUBBED_ROOTS} classes are accepted)")


def load_reference_pickle(path: str):
    """Restricted-unpickle a reference artifact (legacy classes -> stubs)."""
    with open(path, "rb") as f:
        return _RefUnpickler(f).load()


def _meta_from_dtype(dtype: np.dtype) -> ContactMeta:
    md = dict(dtype.metadata or {})

    def opt(key, cast):
        v = md.get(key)
        try:
            return cast(v) if v is not None and not isinstance(v, _Opaque) \
                else None
        except (TypeError, ValueError):
            return None

    return ContactMeta(top=opt("top", str), traj=opt("traj", str),
                       ts=opt("ts", float), cutoff=opt("cutoff", float))


def load_reference_contacts(
        path: str) -> Union[ContactRecords, ContactEvents]:
    """Import ``contacts.pkl`` (primary map, 5 columns) or
    ``contacts_{cutoff}.pkl`` (residence events, 4 columns).

    Timestep/cutoff/paths survive from the dtype metadata; the pickled
    AtomGroups are discarded (selection strings are not recoverable from
    them without MDAnalysis — set ``meta.sel1/sel2`` yourself if a later
    stage needs them).
    """
    arr = np.asarray(load_reference_pickle(path))
    meta = _meta_from_dtype(arr.dtype)
    arr = arr.astype(np.float64, copy=False)   # drop metadata for slicing
    if arr.ndim != 2 or arr.shape[1] not in (4, 5):
        raise ValueError(
            f"unrecognized reference contact table shape {arr.shape}; "
            "expected (N, 5) contacts.pkl or (M, 4) contacts_cutoff.pkl")
    if arr.shape[1] == 5:
        # [frame, sel1_resid, sel2_resid, min_dist, time_ns]
        # (reference contacts.py:125-127)
        return ContactRecords(
            frames=arr[:, 0].astype(np.int64),
            sel1_resids=arr[:, 1].astype(np.int32),
            sel2_resids=arr[:, 2].astype(np.int32),
            min_dist=arr[:, 3].astype(np.float32),
            times=arr[:, 4], meta=meta)
    # [sel1_resid, sel2_resid, start_time, duration]
    # (reference contacts.py:227-229)
    return ContactEvents(
        sel1_resids=arr[:, 0].astype(np.int32),
        sel2_resids=arr[:, 1].astype(np.int32),
        start_times=arr[:, 2], durations=arr[:, 3], meta=meta)


def load_reference_gibbs(path: str, root: str = "."):
    """Import a reference ``gibbs_{niter}.pkl`` into this framework's
    :class:`~basicrta_torch.sampler.gibbs.Gibbs`.

    Carries over the raw chain (times, thinned mcweights/mcrates, sampler
    configuration); post-processing state is NOT imported — rerun
    ``process_gibbs()`` to cluster/estimate with the device pipeline
    (on the card unless given a CPU ``device``).
    """
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.sampler.gibbs import Gibbs

    r = load_reference_pickle(path)
    if not isinstance(r, _Opaque):
        raise ValueError(f"{path} does not contain a reference Gibbs pickle")

    def attr(name, default=None):
        return getattr(r, name, default)

    times = attr("times")
    if times is None:
        raise ValueError(f"{path}: pickle has no 'times' array")
    residue = attr("residue")
    if isinstance(residue, np.ndarray):      # reference load() quirk
        residue = residue[0]
    cfg = GibbsConfig(
        ncomp=int(attr("ncomp", 15)), niter=int(attr("niter", 110_000)),
        g=int(attr("g", 100)), burnin=int(attr("burnin", 10_000)))
    cutoff = attr("cutoff")
    g = Gibbs(np.asarray(times, np.float64),
              residue=str(residue) if residue is not None else "X0",
              cutoff=float(cutoff) if cutoff is not None else 7.0,
              cfg=cfg, root=root)
    for src in ("mcweights", "mcrates"):
        a = attr(src)
        if a is not None:
            # add the chain axis (the reference runs one chain)
            setattr(g, src, np.asarray(a, np.float64)[None])
    return g
