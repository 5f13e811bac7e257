#!/usr/bin/env python
"""End-to-end demo: a planted membrane system through the four CLI stages.

Port of the JAX package's ``scripts/e2e_demo.py``. It writes a GRO/XTC
pair (and a PDB) with planted binding kinetics: each lipid alternates
between bound at its home protein residue and away, its bound times a
two-exponential mixture (weights 0.75 / 0.25, rates 2.0 / 0.2 per ns, so
the slowest planted tau is 1 / 0.2 = 5 ns). Then it drives the same four
entry points a user runs (``basicrta_torch.cli``: ``contacts``,
``gibbs``, ``cluster``, ``kinetics``) and prints each stage's wall
seconds, and the planted slowest tau beside the median tau of the
residues with events. That comparison is printed, not a gate.

Every stage runs on the card unless ``--device cpu``.

Usage: python -m basicrta_torch.scripts.e2e_demo [--workdir DIR]
       [--frames 5000] [--nprot 120] [--nlip 60] [--niter 110000]
       [--ndevices N] [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np

W_TRUE = np.array([0.75, 0.25])
R_TRUE = np.array([2.0, 0.2])          # 1/ns; slowest tau 5 ns


def make_system(root: str, n_prot: int, n_lip: int, frames: int,
                ts: float, rng) -> None:
    """Write top.gro / traj.xtc / struct.pdb with planted kinetics."""
    from basicrta_torch.io.native import XTCWriter
    from basicrta_torch.io.topology import Topology, write_gro, write_pdb

    prot_at, lip_at = 4, 10
    box = np.array([150.0, 150.0, 100.0], np.float32)
    # protein residues on a grid in the membrane plane
    sites = np.stack([
        20.0 + 110.0 * (np.arange(n_prot) % 12) / 12.0,
        20.0 + 110.0 * (np.arange(n_prot) // 12) / 12.0,
        np.full(n_prot, 50.0)], axis=1).astype(np.float32)

    names, resids, resnames = [], [], []
    for r in range(n_prot):
        for a in range(prot_at):
            names.append(f"C{a}")
            resids.append(r + 1)
            resnames.append("TRP" if r % 7 == 0 else "LEU")
    for lip in range(n_lip):
        for a in range(lip_at):
            names.append(f"L{a}")
            resids.append(1000 + lip)
            resnames.append("CHOL")
    A = len(names)
    top = Topology(np.array(names), np.array(resids, np.int32),
                   np.array(resnames), np.zeros((A, 3), np.float32), box)
    write_gro(os.path.join(root, "top.gro"), top)
    write_pdb(os.path.join(root, "struct.pdb"), top)

    pos = np.empty((frames, A, 3), np.float32)
    # protein: small jitter around sites
    for r in range(n_prot):
        base = sites[r]
        offs = rng.normal(0.0, 0.4, (prot_at, 3)).astype(np.float32)
        pos[:, r * prot_at:(r + 1) * prot_at] = (
            base + offs + rng.normal(0.0, 0.15,
                                     (frames, prot_at, 3))).astype(
                                         np.float32)
    # lipids: alternate bound (at home site) / away, hyperexp bound times
    p0 = n_prot * prot_at
    for lip in range(n_lip):
        home = sites[lip % n_prot]
        away = home + np.array([0.0, 0.0, 35.0], np.float32)
        f = 0
        bound = bool(rng.integers(0, 2))
        center = np.empty((frames, 3), np.float32)
        while f < frames:
            if bound:
                comp = rng.choice(2, p=W_TRUE)
                dur_ns = rng.exponential(1.0 / R_TRUE[comp])
            else:
                dur_ns = rng.exponential(1.5)
            n = max(1, int(round(dur_ns / ts)))
            center[f:f + n] = home + [2.5, 0.0, 0.0] if bound else away
            f += n
            bound = not bound
        offs = rng.normal(0.0, 0.8, (lip_at, 3)).astype(np.float32)
        pos[:, p0 + lip * lip_at:p0 + (lip + 1) * lip_at] = (
            center[:, None, :] + offs
            + rng.normal(0.0, 0.2, (frames, lip_at, 3))).astype(np.float32)

    with XTCWriter(os.path.join(root, "traj.xtc")) as w:
        w.write(pos, (np.arange(frames) * ts).astype(np.float64),
                np.tile(box, (frames, 1)))


def stages(niter: int, device=None, ndevices=None):
    """(name, argv) of the four CLI stages; ``device='cpu'`` sends each to
    the CPU."""
    out = [
        ("contacts", ["contacts", "--top", "top.gro", "--traj", "traj.xtc",
                      "--sel1", "protein", "--sel2", "resname CHOL",
                      "--cutoff", "7.0", "--batch", "128"]),
        ("gibbs", ["gibbs", "--contacts", "contacts_7.0.npz",
                   "--niter", str(niter)]),
        ("cluster", ["cluster", "--cutoff", "7.0", "--niter", str(niter),
                     "--structure", "struct.pdb"]),
        ("kinetics", ["kinetics", "--gibbs",
                      f"basicrta-7.0/W1/gibbs_{niter}.npz",
                      "--contacts", "contacts_7.0.npz", "--wdensity"]),
    ]
    for name, argv in out:
        if device == "cpu":
            argv += (["--engine", "torch"] if name == "cluster"
                     else ["--device", "cpu"])
        if ndevices is not None and name in ("contacts", "gibbs"):
            argv += ["--ndevices", str(ndevices)]
    return out


def run(root, frames=5000, nprot=120, nlip=60, niter=110_000, device=None,
        ndevices=None, seed=7, out=print):
    """Build the system in ``root`` and run the four stages there.
    Returns ({stage: wall seconds}, planted slowest tau, median tau of the
    residues with a tau)."""
    from basicrta_torch.cli import main as cli
    from basicrta_torch.sampler.batch import resolve_engine

    resolve_engine(None, device)      # the card unless asked: raise first
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    make_system(root, nprot, nlip, frames, 0.1, rng)
    seconds = {"gen": time.perf_counter() - t0}
    out(f"[gen]      {seconds['gen']:6.1f}s  {frames} frames, {nprot} "
        f"residues, {nlip} lipids")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for name, argv in stages(niter, device, ndevices):
            t0 = time.perf_counter()
            cli(argv)
            seconds[name] = time.perf_counter() - t0
            out(f"[{name:8s}] {seconds[name]:6.1f}s")
        table = np.load("tausout.npy")     # [resid, tau, lo, hi]
    finally:
        os.chdir(cwd)
    taus = table[table[:, 1] > 0, 1]
    planted = float(1.0 / R_TRUE.min())
    median = float(np.median(taus)) if len(taus) else float("nan")
    out(f"planted slowest tau {planted:.2f} ns; median tau {median:.2f} ns "
        f"over {len(taus)} residues with events")
    return seconds, planted, median


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None,
                    help="where the system and results go (default: a new "
                         "temporary directory)")
    ap.add_argument("--frames", type=int, default=5000)
    ap.add_argument("--nprot", type=int, default=120)
    ap.add_argument("--nlip", type=int, default=60)
    ap.add_argument("--niter", type=int, default=110_000)
    ap.add_argument("--ndevices", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="every stage on the card (the default; raises "
                         "without one) or the CPU")
    args = ap.parse_args(argv)
    root = args.workdir or tempfile.mkdtemp(prefix="basicrta_e2e_")
    result = run(root, args.frames, args.nprot, args.nlip, args.niter,
                 args.device, args.ndevices)
    print("e2e OK:", root)
    return result


if __name__ == "__main__":
    main()
