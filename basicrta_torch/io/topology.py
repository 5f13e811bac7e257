"""Topology parsing (GRO/PDB/PSF) and a selection mini-language.

Replaces the MDAnalysis Universe/AtomGroup machinery the reference uses for
atom selection and PDB b-factor export (reference contacts.py:246-249,
cluster.py:157-175). The selection grammar covers the expressions reference
users routinely pass through ``--sel1/--sel2``::

    protein | backbone | water | nucleic | all
    name CA CB H* ... | resname CHOL POPC ... | segid PROA ... | type OT ...
    resid 313 | resid 100-200 | resnum ... | index 0 5 10-20 | bynum 1 6 11-21
    around 5.0 TERM | byres TERM | sphzone 8.0 TERM | point x y z R
    same {residue|resid|resname|name|segid|mass|charge} as TERM
    sphlayer R1 R2 TERM | cyzone R zmax zmin TERM | cylayer R1 R2 zmax zmin TERM
    prop mass > 1.1 | prop charge < 0 | prop abs z <= 15
    not EXPR | EXPR and EXPR | EXPR or EXPR | ( EXPR )

``name``/``resname``/``segid`` values accept ``*``/``?`` glob wildcards.
``around X TERM`` selects atoms within X Angstrom of TERM's atoms
(excluding TERM itself, minimum-image when the topology has a box —
MDAnalysis ``around`` semantics); ``byres`` expands a selection to whole
residues.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import re
from typing import Dict, List, Optional, Sequence

import numpy as np


def box_from_cosines(A, B, C, ca, cb, cg) -> np.ndarray:
    """Triclinic cell row matrix (F, 3, 3) from edge lengths and angle
    cosines (the one construction shared by DCD unitcells, Amber
    cell_lengths/angles, and inpcrd box lines)."""
    sg = np.sqrt(np.maximum(1.0 - cg * cg, 1e-12))
    H = np.zeros((len(A), 3, 3), np.float32)
    H[:, 0, 0] = A
    H[:, 1, 0] = B * cg
    H[:, 1, 1] = B * sg
    H[:, 2, 0] = C * cb
    H[:, 2, 1] = C * (ca - cb * cg) / sg
    H[:, 2, 2] = np.sqrt(np.maximum(
        C * C - H[:, 2, 0] ** 2 - H[:, 2, 1] ** 2, 1e-12))
    return H


class _InMemoryFrames:
    """read()/__len__ for readers that parse the whole file up front
    into ``self._coords`` (F, A, 3) and ``self._box`` ((F, ...) or
    None)."""

    def read(self, frames: Optional[Sequence[int]] = None):
        idx = (np.arange(self.nframes) if frames is None
               else np.asarray(frames, np.int64))
        box = self._box[idx] if self._box is not None else None
        return self._coords[idx], box

    def __len__(self):
        return self.nframes

# standard amino-acid residue names (3-letter, incl. common His variants)
PROTEIN_RESNAMES = {
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "HSD", "HSE", "HSP", "HID", "HIE", "HIP", "CYX", "MSE", "ASH", "GLH",
    "LYN",
}
BACKBONE_NAMES = {"N", "CA", "C", "O", "BB"}
WATER_RESNAMES = {
    "SOL", "WAT", "HOH", "H2O", "OH2", "TIP", "TIP2", "TIP3", "TIP4",
    "TIP5", "T3P", "T4P", "T5P", "SPC", "SPCE", "TP3", "TP4", "TP5",
}
NUCLEIC_RESNAMES = {
    "ADE", "GUA", "CYT", "THY", "URA",
    "DA", "DG", "DC", "DT", "DU", "A", "G", "C", "T", "U",
    "RA", "RG", "RC", "RU", "DA5", "DG5", "DC5", "DT5",
    "DA3", "DG3", "DC3", "DT3", "A5", "G5", "C5", "U5",
    "A3", "G3", "C3", "U3",
}

AA_3TO1 = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C", "GLN": "Q",
    "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K",
    "MET": "M", "PHE": "F", "PRO": "P", "SER": "S", "THR": "T", "TRP": "W",
    "TYR": "Y", "VAL": "V", "HSD": "H", "HSE": "H", "HSP": "H", "HID": "H",
    "HIE": "H", "HIP": "H", "CYX": "C", "MSE": "M", "ASH": "D", "GLH": "E",
    "LYN": "K",
}


def convert_aa_code(resname: str) -> str:
    """3-letter -> 1-letter code (reference uses
    mda.lib.util.convert_aa_code, gibbs.py:64)."""
    try:
        return AA_3TO1[resname.upper()]
    except KeyError:
        raise ValueError(f"unknown residue name {resname!r}") from None


# element masses for name-based guessing (formats without a mass column)
_ELEMENT_MASS = {
    "H": 1.008, "C": 12.011, "N": 14.007, "O": 15.999, "S": 32.06,
    "P": 30.974, "F": 18.998, "K": 39.098, "B": 10.81, "I": 126.90,
    "CL": 35.45, "BR": 79.904, "NA": 22.990, "MG": 24.305, "ZN": 65.38,
    "FE": 55.845, "MN": 54.938, "CU": 63.546, "NI": 58.693, "CO": 58.933,
    "LI": 6.94, "AL": 26.982, "SI": 28.085, "SE": 78.971, "CD": 112.41,
    "HG": 200.59,
}
_TWO_LETTER = {k for k in _ELEMENT_MASS if len(k) == 2}


def guess_mass(name: str) -> float:
    """Mass from an atom name (GRO/PDB carry none). Heuristic: a
    two-letter element only when the RAW name is exactly its symbol
    (so bare CL/NA ions resolve but CA stays alpha-carbon and HG1/HB2
    stay hydrogens — the conservative side of MDAnalysis's guesser);
    else the first letter after stripping leading digits."""
    raw = name.upper()
    if raw in _TWO_LETTER and raw != "CA":
        return _ELEMENT_MASS[raw]
    stripped = raw.lstrip("0123456789")
    return _ELEMENT_MASS.get(stripped[:1], 0.0) if stripped else 0.0


@dataclasses.dataclass
class Topology:
    """Struct-of-arrays atom table."""
    names: np.ndarray      # (A,) str
    resids: np.ndarray     # (A,) int32
    resnames: np.ndarray   # (A,) str
    positions: Optional[np.ndarray] = None  # (A, 3) float32 [Angstrom]
    box: Optional[np.ndarray] = None        # (3,) float32 [Angstrom]
    segids: Optional[np.ndarray] = None     # (A,) str (PSF/PDB segments)
    masses: Optional[np.ndarray] = None     # (A,) float32 [amu] (PSF/PRMTOP)
    charges: Optional[np.ndarray] = None    # (A,) float32 [e] (PSF/PRMTOP)
    types: Optional[np.ndarray] = None      # (A,) str force-field atom types

    @property
    def natoms(self) -> int:
        return len(self.names)

    @property
    def masses_or_guess(self) -> np.ndarray:
        """Masses from the topology when it carries them, else guessed
        from atom names (see :func:`guess_mass`)."""
        if self.masses is not None:
            return self.masses
        return np.asarray([guess_mass(str(n)) for n in self.names],
                          np.float32)

    @property
    def segids_or_default(self) -> np.ndarray:
        if self.segids is None:
            return np.full(self.natoms, "SYSTEM")
        return self.segids

    def select(self, expr: str) -> np.ndarray:
        """Atom indices matching a selection expression."""
        mask = _SelectionParser(expr).parse()(self)
        return np.flatnonzero(mask)

    def residue_resids(self, indices: np.ndarray) -> np.ndarray:
        return np.unique(self.resids[indices])

    def residue_labels(self, indices: np.ndarray) -> List[str]:
        """Labels like 'W313' for the selected residues
        (reference gibbs.py:62-67)."""
        labels = []
        for resid in self.residue_resids(indices):
            rn = self.resnames[self.resids == resid][0]
            labels.append(f"{convert_aa_code(str(rn))}{resid}")
        return labels


# --------------------------- selection grammar --------------------------- #

class _SelectionParser:
    """Recursive-descent parser producing mask functions Topology -> bool[A].

    Grammar: expr := term (('and'|'or') term)* ; term := 'not' term |
    '(' expr ')' | primitive. Keyword primitives consume their value lists.
    """

    # tokens: quoted strings (kept whole, quotes preserved — they mark
    # regex values), parentheses, bare words
    _TOKEN_RE = re.compile(r'"[^"]*"|\'[^\']*\'|\(|\)|[^\s()\'"]+')

    def __init__(self, expr: str):
        self.tokens = self._TOKEN_RE.findall(expr)
        self.pos = 0

    def parse(self):
        fn = self._expr()
        if self.pos != len(self.tokens):
            raise ValueError(
                f"trailing tokens in selection: {self.tokens[self.pos:]}")
        return fn

    def _peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def _next(self):
        tok = self._peek()
        self.pos += 1
        return tok

    def _expr(self):
        left = self._term()
        while self._peek() in ("and", "or"):
            op = self._next()
            right = self._term()
            if op == "and":
                left = (lambda a, b: lambda t: a(t) & b(t))(left, right)
            else:
                left = (lambda a, b: lambda t: a(t) | b(t))(left, right)
        return left

    def _term(self):
        tok = self._peek()
        if tok == "not":
            self._next()
            inner = self._term()
            return lambda t: ~inner(t)
        if tok == "(":
            self._next()
            inner = self._expr()
            if self._next() != ")":
                raise ValueError("unbalanced parenthesis in selection")
            return inner
        return self._primitive()

    def _values(self) -> List[str]:
        vals = []
        # geometric/prop keywords stop value lists so a missing 'and' is
        # a loud parse error instead of silently matching them as names
        stop = {"and", "or", "not", "(", ")", "around", "byres", "prop",
                "point", "sphzone", "sphlayer", "cyzone", "cylayer", "same"}
        while self._peek() is not None and self._peek() not in stop:
            vals.append(self._next())
        if not vals:
            raise ValueError("selection keyword needs at least one value")
        return vals

    @staticmethod
    def _str_matcher(vals):
        """Matcher over a string column. Bare values match literally
        (case-insensitive) with * and ? glob wildcards (MDAnalysis
        accepts e.g. ``name H*`` to select all hydrogens); quoted values
        are full-match regular expressions — ``name "C.*"`` selects every
        carbon-named atom, the MDAnalysis quoted-pattern reach
        (reference users pass any selection MDAnalysis understands
        through contacts.py:241-249)."""
        plain, globs, regexes = [], [], []
        for v in vals:
            if len(v) >= 2 and v[0] == v[-1] and v[0] in "\"'":
                regexes.append(v[1:-1])
            elif any(c in v for c in "*?["):
                globs.append(v.upper())
            else:
                plain.append(v.upper())
        pattern = None
        if globs:
            pattern = re.compile("|".join(
                fnmatch.translate(g) for g in globs))
        rx = None
        if regexes:
            try:
                rx = re.compile("|".join(f"(?:{r})" for r in regexes),
                                re.IGNORECASE)
            except re.error as e:
                raise ValueError(
                    f"bad regex in quoted selection value "
                    f"{regexes!r}: {e}") from None

        def match(column):
            col = np.char.upper(column.astype(str))
            m = np.isin(col, plain) if plain else np.zeros(len(col), bool)
            if pattern is not None:
                uniq = np.unique(col)
                ok = np.asarray([bool(pattern.match(u)) for u in uniq])
                m |= np.isin(col, uniq[ok])
            if rx is not None:
                uniq = np.unique(col)
                ok = np.asarray([rx.fullmatch(u) is not None
                                 for u in uniq])
                m |= np.isin(col, uniq[ok])
            return m
        return match

    @staticmethod
    def _int_spec(vals):
        """Parse int values/ranges ('313', '100-200', '5:9')."""
        ids: List[int] = []
        ranges = []
        for v in vals:
            if "-" in v[1:] or ":" in v:
                sep = ":" if ":" in v else "-"
                lo, hi = v.split(sep)
                ranges.append((int(lo), int(hi)))
            else:
                ids.append(int(v))
        return tuple(ids), tuple(ranges)

    def _primitive(self):
        tok = self._next()
        if tok is None:
            raise ValueError("unexpected end of selection")
        if tok == "all":
            return lambda t: np.ones(t.natoms, bool)
        if tok == "protein":
            return lambda t: np.isin(np.char.upper(
                t.resnames.astype(str)), list(PROTEIN_RESNAMES))
        if tok == "backbone":
            prot = lambda t: np.isin(np.char.upper(  # noqa: E731
                t.resnames.astype(str)), list(PROTEIN_RESNAMES))
            return lambda t: prot(t) & np.isin(
                np.char.upper(t.names.astype(str)), list(BACKBONE_NAMES))
        if tok == "water":
            return lambda t: np.isin(np.char.upper(
                t.resnames.astype(str)), list(WATER_RESNAMES))
        if tok == "nucleic":
            return lambda t: np.isin(np.char.upper(
                t.resnames.astype(str)), list(NUCLEIC_RESNAMES))
        if tok == "type":
            # force-field atom types (PSF/PRMTOP); other formats fall
            # back to atom names, MDAnalysis's guessed-type behavior
            match = self._str_matcher(self._values())
            return lambda t: match(t.names if t.types is None else t.types)
        if tok == "name":
            match = self._str_matcher(self._values())
            return lambda t: match(t.names)
        if tok == "resname":
            match = self._str_matcher(self._values())
            return lambda t: match(t.resnames)
        if tok == "segid":
            match = self._str_matcher(self._values())
            return lambda t: match(t.segids_or_default)
        if tok in ("resid", "resnum"):
            # resnum: without author-assigned numbering, MDAnalysis
            # defaults resnums to resids — the only case that exists here
            ids, ranges = self._int_spec(self._values())

            def fn(t, ids=ids, ranges=ranges):
                m = np.isin(t.resids, ids)
                for lo, hi in ranges:
                    m |= (t.resids >= lo) & (t.resids <= hi)
                return m
            return fn
        if tok == "index":
            ids, ranges = self._int_spec(self._values())

            def fn(t, ids=ids, ranges=ranges):
                idx = np.arange(t.natoms)
                m = np.isin(idx, ids)
                for lo, hi in ranges:
                    m |= (idx >= lo) & (idx <= hi)
                return m
            return fn
        if tok == "bynum":
            # 1-based atom numbers (MDAnalysis 'bynum'; 'index' is 0-based)
            ids, ranges = self._int_spec(self._values())

            def fn(t, ids=ids, ranges=ranges):
                num = np.arange(1, t.natoms + 1)
                m = np.isin(num, ids)
                for lo, hi in ranges:
                    m |= (num >= lo) & (num <= hi)
                return m
            return fn
        if tok == "same":
            return self._same()
        if tok == "around":
            cut = self._next()
            try:
                cutoff = float(cut)
            except (TypeError, ValueError):
                raise ValueError(
                    f"'around' needs a numeric cutoff, got {cut!r}") from None
            inner = self._term()

            def fn(t, cutoff=cutoff, inner=inner):
                if t.positions is None:
                    raise ValueError(
                        "'around' selections need atom coordinates in the "
                        "topology")
                ref = inner(t)
                if not ref.any():
                    return np.zeros(t.natoms, bool)
                # minimum-image pairwise distances, chunked over reference
                # atoms to bound memory (MDAnalysis 'around' semantics:
                # strictly within cutoff of the inner group, excluding it)
                pos = np.asarray(t.positions, np.float32)
                refpos = pos[ref]
                best = np.full(t.natoms, np.inf, np.float32)
                box = (np.asarray(t.box, np.float32)
                       if t.box is not None else None)
                for lo in range(0, len(refpos), 256):
                    d = pos[:, None, :] - refpos[None, lo:lo + 256, :]
                    if box is not None:
                        d -= box * np.round(d / box)
                    best = np.minimum(
                        best, np.sqrt((d * d).sum(-1)).min(axis=1))
                return (best <= cutoff) & ~ref
            return fn
        if tok == "byres":
            inner = self._term()

            def fn(t, inner=inner):
                m = inner(t)
                return np.isin(t.resids, np.unique(t.resids[m]))
            return fn
        if tok == "point":
            # point x y z R: atoms within R of a fixed point (MDAnalysis)
            vals = [self._next() for _ in range(4)]
            try:
                x, y, z, radius = (float(v) for v in vals)
            except (TypeError, ValueError):
                raise ValueError(
                    f"'point' needs x y z radius, got {vals!r}") from None
            return lambda t: self._within(t, np.array([[x, y, z]],
                                                      np.float32), radius)
        if tok == "sphzone":
            # sphzone R SEL: atoms within R of SEL's center of geometry
            # (the zone INCLUDES the reference group, unlike 'around')
            radius, = self._floats(1, "sphzone", "a numeric radius")
            inner = self._term()

            def fn(t, radius=radius, inner=inner):
                d = self._cog_delta(t, inner, "sphzone")
                if d is None:
                    return np.zeros(t.natoms, bool)
                return np.sqrt((d * d).sum(-1)) <= radius
            return fn
        if tok == "sphlayer":
            # sphlayer R1 R2 SEL: spherical shell R1 <= r <= R2 around
            # SEL's center of geometry (MDAnalysis keyword)
            rmin, rmax = self._floats(2, "sphlayer",
                                      "inner and outer radii")
            inner = self._term()

            def fn(t, rmin=rmin, rmax=rmax, inner=inner):
                d = self._cog_delta(t, inner, "sphlayer")
                if d is None:
                    return np.zeros(t.natoms, bool)
                r = np.sqrt((d * d).sum(-1))
                return (r >= rmin) & (r <= rmax)
            return fn
        if tok == "cyzone":
            # cyzone R zmax zmin SEL: z-axis-aligned cylinder of radius R
            # around SEL's center of geometry, zmin <= dz <= zmax
            # (MDAnalysis operand order: externalRadius zMax zMin)
            rmax, zmax, zmin = self._floats(
                3, "cyzone", "externalRadius zMax zMin")
            inner = self._term()

            def fn(t, rmax=rmax, zmax=zmax, zmin=zmin, inner=inner):
                d = self._cog_delta(t, inner, "cyzone")
                if d is None:
                    return np.zeros(t.natoms, bool)
                r = np.sqrt((d[:, :2] ** 2).sum(-1))
                return (r <= rmax) & (d[:, 2] >= zmin) & (d[:, 2] <= zmax)
            return fn
        if tok == "cylayer":
            # cylayer R1 R2 zmax zmin SEL: cylindrical shell
            # R1 <= radial distance <= R2, zmin <= dz <= zmax
            rmin, rmax, zmax, zmin = self._floats(
                4, "cylayer", "innerRadius externalRadius zMax zMin")
            inner = self._term()

            def fn(t, rmin=rmin, rmax=rmax, zmax=zmax, zmin=zmin,
                   inner=inner):
                d = self._cog_delta(t, inner, "cylayer")
                if d is None:
                    return np.zeros(t.natoms, bool)
                r = np.sqrt((d[:, :2] ** 2).sum(-1))
                return ((r >= rmin) & (r <= rmax)
                        & (d[:, 2] >= zmin) & (d[:, 2] <= zmax))
            return fn
        if tok == "prop":
            return self._prop()
        raise ValueError(f"unknown selection keyword {tok!r}")

    _SAME_FIELDS = ("residue", "resid", "resname", "name", "segid",
                    "mass", "charge")

    def _same(self):
        """``same FIELD as SEL``: every atom sharing FIELD's value with
        some atom of SEL (MDAnalysis group-propagation keyword; ``byres``
        is the ``same residue as`` shorthand)."""
        field = self._next()
        if field not in self._SAME_FIELDS:
            raise ValueError(
                f"'same' supports {'/'.join(self._SAME_FIELDS)}, "
                f"got {field!r}")
        if self._next() != "as":
            raise ValueError(f"'same {field} ...' is missing 'as'")
        inner = self._term()

        def fn(t, field=field, inner=inner):
            m = inner(t)
            if not m.any():
                return m
            if field in ("residue", "resid"):
                col = t.resids
            elif field == "resname":
                col = np.char.upper(t.resnames.astype(str))
            elif field == "name":
                col = np.char.upper(t.names.astype(str))
            elif field == "segid":
                col = np.char.upper(t.segids_or_default.astype(str))
            elif field == "mass":
                col = t.masses_or_guess
            else:  # charge
                if t.charges is None:
                    raise ValueError(
                        "'same charge as' needs a topology with charges "
                        "(PSF or PRMTOP)")
                col = t.charges
            return np.isin(col, np.unique(col[m]))
        return fn

    def _floats(self, n: int, kw: str, what: str) -> List[float]:
        vals = [self._next() for _ in range(n)]
        try:
            return [float(v) for v in vals]
        except (TypeError, ValueError):
            raise ValueError(
                f"'{kw}' needs {what}, got {vals!r}") from None

    @staticmethod
    def _cog_delta(t, inner, kw: str) -> Optional[np.ndarray]:
        """Minimum-image displacement (A, 3) of every atom from the
        center of geometry of the atoms ``inner`` selects, or None when
        the inner selection is empty."""
        if t.positions is None:
            raise ValueError(
                f"'{kw}' selections need atom coordinates in the topology")
        ref = inner(t)
        if not ref.any():
            return None
        pos = np.asarray(t.positions, np.float32)
        d = pos - pos[ref].mean(axis=0)
        if t.box is not None:
            box = np.asarray(t.box, np.float32)
            d -= box * np.round(d / box)
        return d

    @staticmethod
    def _within(t, centers: np.ndarray, radius: float) -> np.ndarray:
        """Atoms within radius of any center point (minimum-image when
        the topology has an orthorhombic box)."""
        if t.positions is None:
            raise ValueError(
                "point-based selections need atom coordinates in the "
                "topology")
        pos = np.asarray(t.positions, np.float32)
        d = pos[:, None, :] - centers[None, :, :]
        if t.box is not None:
            box = np.asarray(t.box, np.float32)
            d -= box * np.round(d / box)
        return np.sqrt((d * d).sum(-1)).min(axis=1) <= radius

    _PROP_OPS = {
        "<": np.less, "<=": np.less_equal, ">": np.greater,
        ">=": np.greater_equal, "==": np.equal, "!=": np.not_equal,
    }

    def _prop(self):
        """``prop [abs] {mass|charge|x|y|z} OP value`` (MDAnalysis
        numeric-property selections)."""
        attr = self._next()
        use_abs = attr == "abs"
        if use_abs:
            attr = self._next()
        if attr not in ("mass", "charge", "x", "y", "z"):
            raise ValueError(f"'prop' supports mass/charge/x/y/z, "
                             f"got {attr!r}")
        op = self._next()
        if op not in self._PROP_OPS:
            raise ValueError(f"'prop' needs a comparison operator "
                             f"(<, <=, >, >=, ==, !=), got {op!r}")
        raw = self._next()
        try:
            value = float(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"'prop {attr} {op}' needs a numeric value, "
                f"got {raw!r}") from None

        def fn(t, attr=attr, op=op, value=value, use_abs=use_abs):
            if attr == "mass":
                col = t.masses_or_guess
            elif attr == "charge":
                if t.charges is None:
                    raise ValueError(
                        "'prop charge' needs a topology with charges "
                        "(PSF or PRMTOP)")
                col = t.charges
            else:
                if t.positions is None:
                    raise ValueError(
                        f"'prop {attr}' needs atom coordinates in the "
                        "topology")
                col = t.positions[:, "xyz".index(attr)]
            col = np.abs(col) if use_abs else col
            return self._PROP_OPS[op](col, value)
        return fn


# ------------------------------ GRO format ------------------------------- #

def read_gro(path: str) -> Topology:
    """Parse a GROMACS .gro file (fixed columns, nm -> Angstrom)."""
    with open(path) as f:
        lines = f.read().splitlines()
    natoms = int(lines[1])
    names, resids, resnames = [], [], []
    pos = np.empty((natoms, 3), np.float32)
    for i, ln in enumerate(lines[2:2 + natoms]):
        resids.append(int(ln[0:5]))
        resnames.append(ln[5:10].strip())
        names.append(ln[10:15].strip())
        pos[i] = (float(ln[20:28]), float(ln[28:36]), float(ln[36:44]))
    boxvals = [float(v) for v in lines[2 + natoms].split()]
    box = np.asarray(boxvals[:3], np.float32) * 10.0
    return Topology(np.asarray(names), np.asarray(resids, np.int32),
                    np.asarray(resnames), pos * 10.0, box)


def write_gro(path: str, top: Topology, positions: Optional[np.ndarray] = None,
              box: Optional[np.ndarray] = None, title: str = "basicrta_torch"):
    """Write a GRO file (Angstrom -> nm)."""
    pos = (top.positions if positions is None else positions) / 10.0
    b = (top.box if box is None else box)
    b = np.zeros(3, np.float32) if b is None else np.asarray(b) / 10.0
    with open(path, "w") as f:
        f.write(f"{title}\n{top.natoms:5d}\n")
        for i in range(top.natoms):
            f.write(f"{int(top.resids[i]) % 100000:5d}"
                    f"{str(top.resnames[i])[:5]:<5s}"
                    f"{str(top.names[i])[:5]:>5s}"
                    f"{(i + 1) % 100000:5d}"
                    f"{pos[i, 0]:8.3f}{pos[i, 1]:8.3f}{pos[i, 2]:8.3f}\n")
        f.write(f"{b[0]:10.5f}{b[1]:10.5f}{b[2]:10.5f}\n")
    return path


# ------------------------------ PSF format ------------------------------- #

def read_psf(path: str) -> Topology:
    """Parse a CHARMM/X-PLOR/NAMD PSF topology (!NATOM section).

    Atom lines are whitespace-delimited in every PSF dialect (standard,
    EXT, CHEQ): ``id segid resid resname name type charge mass [...]``.
    No coordinates — pair with a trajectory (reference reach:
    contacts.py:246-249 builds a Universe from any topology MDAnalysis
    reads; PSF is the CHARMM/NAMD standard).
    """
    names, resids, resnames, segids = [], [], [], []
    charges, masses, types = [], [], []
    with open(path) as f:
        first = f.readline()
        if not first.startswith("PSF"):
            raise ValueError(f"{path} is not a PSF file (missing PSF "
                             "header)")
        natom = None
        for ln in f:
            if "!NATOM" in ln:
                natom = int(ln.split()[0])
                break
        if natom is None:
            raise ValueError(f"{path}: no !NATOM section found")
        for _ in range(natom):
            parts = f.readline().split()
            if len(parts) < 8:
                raise ValueError(f"{path}: truncated !NATOM section")
            segids.append(parts[1])
            # resid may carry an insertion code (e.g. '42A'): keep digits
            rid = parts[2]
            resids.append(int(re.match(r"-?\d+", rid).group())
                          if re.match(r"-?\d+", rid) else 0)
            resnames.append(parts[3])
            names.append(parts[4])
            types.append(parts[5])
            charges.append(float(parts[6]))
            masses.append(float(parts[7]))
    return Topology(np.asarray(names), np.asarray(resids, np.int32),
                    np.asarray(resnames), positions=None, box=None,
                    segids=np.asarray(segids),
                    masses=np.asarray(masses, np.float32),
                    charges=np.asarray(charges, np.float32),
                    types=np.asarray(types))


# ------------------------------ PDB format ------------------------------- #

def read_pdb(path: str) -> Topology:
    """Parse ATOM/HETATM records of a PDB file (fixed columns, Angstrom).

    Segment ids come from columns 73-76 when present, else the chain id
    (column 22) — MDAnalysis's fallback order."""
    names, resids, resnames, xyz, segids = [], [], [], [], []
    box = None
    with open(path) as f:
        for ln in f:
            if ln.startswith("ENDMDL"):
                break          # multi-MODEL file: topology = first model
            if ln.startswith("CRYST1"):
                box = np.asarray([float(ln[6:15]), float(ln[15:24]),
                                  float(ln[24:33])], np.float32)
            if not (ln.startswith("ATOM") or ln.startswith("HETATM")):
                continue
            names.append(ln[12:16].strip())
            resnames.append(ln[17:21].strip())
            resids.append(int(ln[22:26]))
            xyz.append((float(ln[30:38]), float(ln[38:46]),
                        float(ln[46:54])))
            seg = ln[72:76].strip() if len(ln) > 72 else ""
            segids.append(seg or ln[21:22].strip() or "SYSTEM")
    return Topology(np.asarray(names), np.asarray(resids, np.int32),
                    np.asarray(resnames),
                    np.asarray(xyz, np.float32), box,
                    segids=np.asarray(segids))


def write_pdb(path: str, top: Topology,
              positions: Optional[np.ndarray] = None,
              indices: Optional[np.ndarray] = None,
              tempfactors: Optional[Dict[int, float]] = None,
              occupancies: Optional[Dict[int, float]] = None):
    """Write a PDB, optionally with per-residue b-factors/occupancies —
    the tau-coloring export (reference cluster.py:157-175)."""
    pos = top.positions if positions is None else positions
    idx = np.arange(top.natoms) if indices is None else np.asarray(indices)
    tempfactors = tempfactors or {}
    occupancies = occupancies or {}
    with open(path, "w") as f:
        if top.box is not None:
            f.write(f"CRYST1{top.box[0]:9.3f}{top.box[1]:9.3f}"
                    f"{top.box[2]:9.3f}  90.00  90.00  90.00 P 1         1\n")
        for serial, i in enumerate(idx, start=1):
            resid = int(top.resids[i])
            name = str(top.names[i])[:4]
            b = tempfactors.get(resid, 0.0)
            occ = occupancies.get(resid, 1.0)
            # standard columns: name 13-16, altLoc 17, resname 18-21,
            # chain 22, resid 23-26 (1-based)
            f.write(f"ATOM  {serial % 100000:5d} {name:<4s} "
                    f"{str(top.resnames[i])[:4]:<4s}"
                    f"A{resid % 10000:4d}    "
                    f"{pos[i, 0]:8.3f}{pos[i, 1]:8.3f}{pos[i, 2]:8.3f}"
                    f"{occ:6.2f}{b:6.2f}\n")
        f.write("END\n")
    return path


# -------------------------- multi-model PDB ------------------------------- #

class PDBModelReader(_InMemoryFrames):
    """Multi-MODEL PDB as a trajectory (the ``mda.Universe(pdb, pdb)``
    pattern the reference inherits; NMR ensembles, short demo
    trajectories). A file with no MODEL records reads as one frame.
    PDB carries no time axis — give ``Universe(..., dt_ns=...)``.
    ``read(frames)`` returns ``(coords, box (F, 3) or None)``.
    """

    def __init__(self, path: str):
        frames, cur = [], []
        box = None
        in_model = False
        with open(path) as f:
            for ln in f:
                if ln.startswith("CRYST1"):
                    box = np.asarray([float(ln[6:15]), float(ln[15:24]),
                                      float(ln[24:33])], np.float32)
                elif ln.startswith("MODEL"):
                    in_model = True
                elif ln.startswith("ENDMDL"):
                    frames.append(cur)
                    cur, in_model = [], False
                elif ln.startswith(("ATOM", "HETATM")):
                    cur.append((float(ln[30:38]), float(ln[38:46]),
                                float(ln[46:54])))
        if cur and (not frames or in_model):
            frames.append(cur)               # trailing / un-MODELed atoms
        if not frames:
            raise ValueError(f"{path}: no ATOM/HETATM records")
        counts = {len(fr) for fr in frames}
        if len(counts) != 1:
            raise ValueError(f"{path}: MODELs have differing atom counts "
                             f"{sorted(counts)}")
        self._coords = np.asarray(frames, np.float32)
        self.nframes, self.natoms = self._coords.shape[:2]
        self._box = (np.tile(box, (self.nframes, 1))
                     if box is not None else None)
