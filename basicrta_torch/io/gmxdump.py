"""GROMACS TPR reach via ``gmx dump`` text output.

The reference accepts TPR topologies because MDAnalysis parses them
(reference contacts.py:246-249 builds ``mda.Universe(args.top, args.traj)``
from anything MDAnalysis reads). TPR is a versioned binary container whose
layout changes across GROMACS releases; rather than chase that surface,
this framework reads the *stable, documented* text rendering every GROMACS
install can produce::

    gmx dump -s topol.tpr > topol.tpr.dump

and ``basicrta-torch contacts --top topol.tpr.dump --traj traj.xtc ...``
works from there (the CLI also accepts ``.dump``/``.txt`` suffixes). A
raw ``.tpr`` path works directly when ``gmx`` is on PATH: the framework
runs the dump itself and caches it next to the input
(``io/universe.py:_dump_tpr``); without ``gmx`` the error names this
recipe.

Parsed content: the molblock/moltype tables (atom names, masses, charges,
force-field types, residue names/numbers), coordinates ``x`` (nm ->
Angstrom) and the ``box`` (nm -> Angstrom), expanded over molecule copies.

Residue numbering: GROMACS stores residue numbers per *moltype*, so the
10,000 copies of a solvent or lipid molecule all carry the same residue
``nr`` (MDAnalysis's TPRParser exposes exactly that). Residence-time
analysis requires each sel2 molecule copy to be a distinct residue, so
this reader keeps the author's ``nr`` numbering for single-copy molblocks
(proteins keep their resids, tau tables stay comparable) and renumbers
multi-copy molblocks sequentially past the largest resid seen so far.
"""

from __future__ import annotations

import re
import warnings

import numpy as np

from basicrta_torch.io.topology import Topology

_RE_MOLBLOCK = re.compile(r"^\s*molblock\s*\((\d+)\)")
_RE_MOLTYPE_HDR = re.compile(r"^\s*moltype\s*\((\d+)\)")
_RE_MB_MOLTYPE = re.compile(
    r"^\s*moltype\s*=\s*(\d+)\s*\"([^\"]*)\"")
_RE_MB_NMOL = re.compile(r"^\s*#molecules\s*=\s*(\d+)")
_RE_NAME = re.compile(r"^\s*name=\"([^\"]*)\"")
# atom[ 0]={type= 2, typeB= 2, ptype= Atom, m= 1.4e+01, q=-3e-01,
#           resind= 0, atomnumber= 7}
_RE_ATOM_NUM = re.compile(
    r"^\s*atom\[\s*(\d+)\]=\{[^}]*\bm\s*=\s*([-+0-9.eE]+)"
    r"[^}]*\bq\s*=\s*([-+0-9.eE]+)[^}]*\bresind\s*=\s*(\d+)")
_RE_ATOM_NAME = re.compile(r"^\s*atom\[\s*(\d+)\]=\{name=\"([^\"]*)\"")
_RE_TYPE_NAME = re.compile(r"^\s*type\[\s*(\d+)\]=\{name=\"([^\"]*)\"")
# residue[0]={name="MET", nr=1, ic=' '}  (older dumps omit nr/ic)
_RE_RESIDUE = re.compile(
    r"^\s*residue\[\s*(\d+)\]=\{name=\"([^\"]*)\""
    r"(?:[^}]*\bnr\s*=\s*(-?\d+))?")
_RE_X_HDR = re.compile(r"^x \((\d+)x3\):")
_RE_BOX_HDR = re.compile(r"^box \(3x3\):")
_RE_VEC = re.compile(
    r"=\{\s*([-+0-9.eE]+),\s*([-+0-9.eE]+),\s*([-+0-9.eE]+)\s*\}")


class _Moltype:
    def __init__(self):
        self.name = ""
        self.masses: list = []
        self.charges: list = []
        self.resinds: list = []
        self.names: dict = {}
        self.types: dict = {}
        self.resnames: dict = {}
        self.resnrs: dict = {}


def looks_like_tpr_dump(path: str) -> bool:
    """Cheap content sniff: the first few KB of a ``gmx dump -s`` output
    carry the topology header tokens."""
    try:
        with open(path, "rb") as f:
            head = f.read(65536).decode("utf-8", "replace")
    except OSError:
        return False
    return "molblock" in head and ("topology:" in head or "tpx" in head)


def read_tpr_dump(path: str) -> Topology:
    """Parse ``gmx dump -s topol.tpr`` output into a :class:`Topology`."""
    molblocks = []            # [(moltype_idx, nmol)]
    moltypes: dict = {}
    coords = None
    box = None

    section = None            # None | 'molblock' | 'moltype'
    cur_mb = None             # [moltype_idx, nmol]
    cur_mt = None
    n_x = 0

    with open(path) as f:
        for ln in f:
            m = _RE_X_HDR.match(ln)
            if m:
                n_x = int(m.group(1))
                coords = np.empty((n_x, 3), np.float32)
                section = "x"
                i_x = 0
                continue
            if _RE_BOX_HDR.match(ln):
                section = "box"
                box_rows = []
                continue
            if section == "x":
                v = _RE_VEC.search(ln)
                if v and i_x < n_x:
                    coords[i_x] = [float(v.group(1)), float(v.group(2)),
                                   float(v.group(3))]
                    i_x += 1
                    continue
                section = None
            if section == "box":
                v = _RE_VEC.search(ln)
                if v and len(box_rows) < 3:
                    box_rows.append([float(v.group(1)), float(v.group(2)),
                                     float(v.group(3))])
                    if len(box_rows) == 3:
                        box = np.asarray(box_rows, np.float64)
                        section = None
                    continue
                section = None

            m = _RE_MOLBLOCK.match(ln)
            if m:
                cur_mb = [None, None]
                molblocks.append(cur_mb)
                section = "molblock"
                continue
            m = _RE_MOLTYPE_HDR.match(ln)
            if m and "=" not in ln:
                cur_mt = _Moltype()
                moltypes[int(m.group(1))] = cur_mt
                section = "moltype"
                continue
            if section == "molblock" and cur_mb is not None:
                m = _RE_MB_MOLTYPE.match(ln)
                if m:
                    cur_mb[0] = int(m.group(1))
                    continue
                m = _RE_MB_NMOL.match(ln)
                if m:
                    cur_mb[1] = int(m.group(1))
                    continue
            if section == "moltype" and cur_mt is not None:
                m = _RE_NAME.match(ln)
                if m and not cur_mt.name:
                    cur_mt.name = m.group(1)
                    continue
                m = _RE_ATOM_NUM.match(ln)
                if m:
                    cur_mt.masses.append(float(m.group(2)))
                    cur_mt.charges.append(float(m.group(3)))
                    cur_mt.resinds.append(int(m.group(4)))
                    continue
                m = _RE_ATOM_NAME.match(ln)
                if m:
                    cur_mt.names[int(m.group(1))] = m.group(2)
                    continue
                m = _RE_TYPE_NAME.match(ln)
                if m:
                    cur_mt.types[int(m.group(1))] = m.group(2)
                    continue
                m = _RE_RESIDUE.match(ln)
                if m:
                    k = int(m.group(1))
                    cur_mt.resnames[k] = m.group(2)
                    cur_mt.resnrs[k] = (int(m.group(3))
                                        if m.group(3) is not None
                                        else k + 1)
                    continue

    mbs = [(mt, n) for mt, n in molblocks
           if mt is not None and n is not None]
    if not mbs or not moltypes:
        raise ValueError(
            f"{path}: no molblock/moltype tables found — is this the "
            "output of `gmx dump -s topol.tpr`?")

    names, resids, resnames, segids = [], [], [], []
    masses, charges, types = [], [], []
    next_resid = 0
    for mt_idx, nmol in mbs:
        mt = moltypes.get(mt_idx)
        if mt is None or not mt.masses:
            raise ValueError(
                f"{path}: molblock references moltype {mt_idx} with no "
                "parsed atoms")
        n_at = len(mt.masses)
        mt_names = [mt.names.get(i, f"A{i}") for i in range(n_at)]
        mt_types = [mt.types.get(i, "") for i in range(n_at)]
        n_res = max(mt.resinds) + 1 if mt.resinds else 0
        single = nmol == 1
        for copy in range(nmol):
            if single:
                copy_resids = [mt.resnrs.get(r, r + 1)
                               for r in range(n_res)]
            else:
                copy_resids = [next_resid + 1 + r for r in range(n_res)]
            names.extend(mt_names)
            types.extend(mt_types)
            masses.extend(mt.masses)
            charges.extend(mt.charges)
            segids.extend([mt.name or f"MOL{mt_idx}"] * n_at)
            resids.extend(copy_resids[r] for r in mt.resinds)
            resnames.extend(mt.resnames.get(r, "UNK")
                            for r in mt.resinds)
            next_resid = max(next_resid, max(copy_resids, default=0))

    pos = None
    if coords is not None:
        if len(coords) < len(names):
            warnings.warn(
                f"{path}: coordinate table has {len(coords)} rows for "
                f"{len(names)} atoms; dropping coordinates", stacklevel=2)
        else:
            pos = coords[:len(names)] * 10.0     # nm -> Angstrom

    top_box = None
    if box is not None:
        off = box - np.diag(np.diag(box))
        if np.abs(off).max() > 1e-9 * max(np.abs(box).max(), 1.0):
            warnings.warn(
                f"{path}: triclinic box; topology-level selections use "
                "the diagonal lengths (trajectory frames carry the full "
                "matrix)", stacklevel=2)
        top_box = (np.diag(box) * 10.0).astype(np.float32)

    return Topology(np.asarray(names), np.asarray(resids, np.int32),
                    np.asarray(resnames), positions=pos, box=top_box,
                    segids=np.asarray(segids),
                    masses=np.asarray(masses, np.float32),
                    charges=np.asarray(charges, np.float32),
                    types=np.asarray(types))
