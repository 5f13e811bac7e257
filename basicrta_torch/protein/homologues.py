"""Homologue comparison: alignment-driven residue matching and delta-tau.

Port of ``basicrta_tpu.protein.homologues`` (numpy; matplotlib only
inside ``plot_delta_tau``), the reference's homologue utilities
(reference util.py:1201-1351): parse a FASTA alignment of two proteins,
match residues through the alignment columns, superimpose structures
(Kabsch, replacing MDAnalysis.analysis.align), and compute/plot
per-residue tau differences.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def parse_fasta_alignment(path: str) -> Dict[str, str]:
    """{name: aligned sequence (with '-' gaps)} in file order
    (header format as in reference util.py:1230-1248)."""
    seqs: Dict[str, List[str]] = {}
    name = None
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            if ln.startswith(">"):
                name = ln[1:].split("|")[0].split("/")[0].strip()
                seqs[name] = []
            elif name is not None:
                seqs[name].append(ln)
    return {k: "".join(v) for k, v in seqs.items()}


def matched_columns(seqA: str, seqB: str,
                    identical_only: bool = False) -> Tuple[np.ndarray,
                                                           np.ndarray]:
    """Residue indices (0-based, per protein) of alignment columns where
    both sequences are non-gap (reference get_fa_sel, util.py:1251-1257) or
    additionally identical (get_fa_sel_match, util.py:1280-1286)."""
    a = np.array(list(seqA))
    b = np.array(list(seqB))
    if len(a) != len(b):
        raise ValueError("aligned sequences differ in length")
    both = (a != "-") & (b != "-")
    if identical_only:
        both &= a == b
    posA = np.cumsum(a != "-") - 1
    posB = np.cumsum(b != "-") - 1
    return posA[both], posB[both]


def kabsch(P: np.ndarray, Q: np.ndarray):
    """Optimal rotation R and translation t with ||R P + t - Q|| minimal.

    Returns (R, t, rmsd). Replaces MDAnalysis align.alignto
    (reference util.py:1288-1300).
    """
    P = np.asarray(P, float)
    Q = np.asarray(Q, float)
    cp, cq = P.mean(axis=0), Q.mean(axis=0)
    H = (P - cp).T @ (Q - cq)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = cq - R @ cp
    rmsd = float(np.sqrt(np.mean(
        np.sum((P @ R.T + t - Q) ** 2, axis=1))))
    return R, t, rmsd


def align_homologues(topA, topB, aln_path: str, name_filter="CA BB"):
    """Superimpose structure A onto B through alignment-matched backbone
    atoms; returns (moved positions of A, rmsd)."""
    seqs = list(parse_fasta_alignment(aln_path).values())
    iA, iB = matched_columns(seqs[0], seqs[1])

    selA = topA.select(f"protein and name {name_filter}")
    selB = topB.select(f"protein and name {name_filter}")
    residsA = topA.resids[selA]
    residsB = topB.resids[selB]
    uA = np.unique(residsA)
    uB = np.unique(residsB)
    atomsA = np.concatenate([selA[residsA == uA[i]][:1] for i in iA
                             if i < len(uA)])
    atomsB = np.concatenate([selB[residsB == uB[i]][:1] for i in iB
                             if i < len(uB)])
    n = min(len(atomsA), len(atomsB))
    R, t, rmsd = kabsch(topA.positions[atomsA[:n]],
                        topB.positions[atomsB[:n]])
    return topA.positions @ R.T + t, rmsd


def delta_tau(aln_path: str, residsA: np.ndarray, residsB: np.ndarray,
              tausA: np.ndarray, tausB: np.ndarray,
              identical_only: bool = False):
    """Per-residue tau difference between two homologues.

    Args:
        residsA/residsB: resids of each protein's residues in sequence
            order (one per alignment position of that protein).
        tausA/tausB: (n, >=2) tables [resid, tau, ...] (the tausout format,
            reference cluster.py:122-134).
    Returns:
        (matched resids A, matched resids B, tauA - tauB) over alignment-
        matched residues present in both tau tables
        (reference get_delta_tau, util.py:1302-1322).
    """
    seqs = list(parse_fasta_alignment(aln_path).values())
    iA, iB = matched_columns(seqs[0], seqs[1], identical_only)
    residsA = np.asarray(residsA)
    residsB = np.asarray(residsB)
    valid = (iA < len(residsA)) & (iB < len(residsB))
    rA, rB = residsA[iA[valid]], residsB[iB[valid]]

    tA = {int(r): float(t) for r, t in zip(tausA[:, 0], tausA[:, 1])}
    tB = {int(r): float(t) for r, t in zip(tausB[:, 0], tausB[:, 1])}
    keep = [(a, b) for a, b in zip(rA, rB) if int(a) in tA and int(b) in tB]
    if not keep:
        return (np.zeros(0, int), np.zeros(0, int), np.zeros(0))
    a, b = np.asarray(keep, int).T
    dt = np.asarray([tA[int(x)] - tB[int(y)] for x, y in zip(a, b)])
    return a, b, dt


def plot_delta_tau(residsA, residsB, dtau, labelsA=None, labelsB=None,
                   factor: float = 2.0, basename: str = "delta_tau"):
    """Delta-tau scatter with outliers labeled
    (reference plot_delta_tau, util.py:1324-1351)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dtau = np.asarray(dtau)
    rmsd = float(np.sqrt(np.mean(dtau ** 2))) if dtau.size else 0.0
    fig, ax = plt.subplots(figsize=(4, 3))
    ax.plot(residsA[dtau > 0], dtau[dtau > 0], ".", color="C0")
    ax.plot(residsA[dtau < 0], dtau[dtau < 0], ".", color="C3")
    for i, tau in enumerate(dtau):
        if abs(tau) >= factor * rmsd and rmsd > 0:
            lab = (labelsA[i] if tau >= 0 and labelsA is not None else
                   labelsB[i] if labelsB is not None else
                   str(residsA[i]))
            ax.text(residsA[i], tau, lab)
    ax.set_ylabel(r"$\Delta\tau$ [ns]")
    ax.set_xticks([])
    fig.savefig(f"{basename}.png", bbox_inches="tight", dpi=150)
    fig.savefig(f"{basename}.pdf", bbox_inches="tight")
    return fig
