"""Command-line interface of the port.

The subcommands of ``basicrta_tpu.cli``, from a trajectory file to tau and
on to what users look at::

    basicrta-torch contacts --top t.gro --traj t.xtc --sel1 protein \
        --sel2 "resname CHOL" --cutoff 7.0 [--device cuda|cpu] \
        [--ndevices N]
    basicrta-torch gibbs --contacts contacts_7.0.npz [--resid 313] \
        [--engine cuda|torch|collapsed] [--device cuda|cpu] \
        [--mode batched|sequential] [--ndevices N] [--multihost]
    basicrta-torch status --cutoff 7.0
    basicrta-torch cluster --cutoff 7.0 [--engine cuda|torch] \
        [--prot b2ar] [--structure s.pdb] [--all-clusters] [--diagnostics]
    basicrta-torch kinetics --gibbs basicrta-7.0/W313/gibbs_110000.npz \
        --contacts contacts_7.0.npz [--top_n N] [--wdensity] \
        [--device cuda|cpu]

All run on the card unless ``--device cpu`` / ``--engine torch`` asks for
the CPU. ``cluster`` writes every data file with or without matplotlib;
without it, each figure it did not draw gets one line on stderr.
"""

from __future__ import annotations

import argparse
import sys
import time


def _cmd_contacts(args):
    from basicrta_torch.config import ContactConfig
    from basicrta_torch.contacts.mapper import MapContacts, ProcessContacts
    from basicrta_torch.contacts.records import ContactMeta
    from basicrta_torch.io.universe import Universe

    cutoffs = args.cutoff
    bad = [c for c in cutoffs if c > args.map_cutoff]
    if bad:
        raise SystemExit(f"analysis cutoff(s) {bad} exceed the map cutoff "
                         f"{args.map_cutoff}; rows beyond it were never "
                         "recorded (raise --map-cutoff)")
    traj = args.traj if len(args.traj) > 1 else args.traj[0]
    u = Universe(args.top, traj, dt_ns=args.dt)
    idx1 = u.select_atoms(args.sel1)
    idx2 = u.select_atoms(args.sel2)
    upload = args.upload
    if upload == "auto":
        # XTC natively stores a 0.01 A fixed-point grid, so the u16 wire
        # format (<= ~0.002 A grid at typical boxes) adds nothing to an
        # XTC trajectory's error budget while halving the upload bytes;
        # any other format gets the exact f32 path (config.upload_dtype)
        upload = ("u16" if all(str(t).lower().endswith(".xtc")
                               for t in args.traj) else "f32")
    cfg = ContactConfig(map_cutoff=args.map_cutoff, cutoff=cutoffs[0],
                        frames_per_batch=args.batch, upload_dtype=upload)
    # ts=None unless --dt was given: MapContacts then infers the frame
    # interval from the FULL frame-time vector with a regularity check
    # (mapper.py); seeding it from u.timestep_ns() (frames 0-1 only)
    # would disable that validation for irregular strides
    meta = ContactMeta(top=args.top, traj=traj, sel1=args.sel1,
                       sel2=args.sel2, ts=args.dt)
    mapper = MapContacts(idx1, u.topology.resids[idx1], idx2,
                         u.topology.resids[idx2], cfg=cfg, meta=meta,
                         device=args.device, n_devices=args.ndevices)
    t0 = time.time()
    nframes = u.n_frames

    def progress(done):
        rate = done / max(time.time() - t0, 1e-9)
        print(f"\rcontacts: frame {done}/{nframes} ({rate:,.0f} frames/s)",
              end="", file=sys.stderr)

    ckpt_dir = "contacts.npz.ckpt" if args.checkpoint_every > 0 else None
    records = mapper.run(u.iter_batches(cfg.frames_per_batch),
                         progress_cb=progress, checkpoint_dir=ckpt_dir,
                         checkpoint_every=max(args.checkpoint_every, 1))
    print(file=sys.stderr)
    records.save("contacts.npz")
    print('Saved contacts as "contacts.npz"')
    # one scan serves any number of analysis cutoffs (the reference
    # reruns ProcessContacts per cutoff over the pickled map,
    # contacts.py:154-195; here each is a filter pass on the records)
    for cutoff in cutoffs:
        events = ProcessContacts(cutoff=cutoff).run(records)
        out = f"contacts_{cutoff}.npz"
        events.save(out)
        print(f'Saved contacts to "{out}"')
    if ckpt_dir is not None:
        # only now that every artifact is durably on disk
        MapContacts.remove_checkpoint(ckpt_dir)


def _cmd_gibbs(args):
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.protein.driver import ParallelGibbs

    burnin = args.burnin if args.burnin is not None else min(
        10_000, max(args.g, args.niter // 10))
    cfg = GibbsConfig(ncomp=args.ncomp, niter=args.niter, g=args.g,
                      burnin=burnin, n_chains=args.nchains, seed=args.seed)
    t0 = time.time()

    def progress(done, total):
        rate = done / max(time.time() - t0, 1e-9)
        print(f"\rgibbs: sweep {done}/{total} ({rate:,.0f} sweeps/s/lane)",
              end="", file=sys.stderr)

    if args.multihost:
        # joins the cluster before anything touches CUDA
        from basicrta_torch.parallel.distributed import initialize
        initialize()
    driver = ParallelGibbs(args.contacts, cfg=cfg)
    run_resids = args.resid
    rerun: set = set()
    if args.rerun_missing:
        # failure-detection sweep: only residues without results
        from basicrta_torch.protein.driver import ProcessProtein
        missing = ProcessProtein(cfg=cfg,
                                 cutoff=driver.cutoff).missing_residues()
        rerun |= set(missing)
        print(f"{len(missing)} missing residues"
              + (f": {' '.join(missing)}" if missing else ""),
              file=sys.stderr)
    if args.rerun_flagged:
        # convergence-recovery sweep over what cluster --diagnostics
        # flagged; combine with --nchains/--niter/--seed, else the
        # deterministic sampler reproduces the same chains
        flagged = _flagged_residues(args.rerun_flagged)
        rerun |= set(flagged)
        print(f"{len(flagged)} flagged residues"
              + (f": {' '.join(flagged)}" if flagged else ""),
              file=sys.stderr)
    if args.rerun_missing or args.rerun_flagged:
        if not rerun:
            print("nothing to rerun", file=sys.stderr)
            return
        labels = sorted(rerun, key=lambda s: int(s[1:]))
        run_resids = [int(lab[1:]) for lab in labels]
        print(f"rerunning {len(labels)} residues: {' '.join(labels)}",
              file=sys.stderr)
    if args.multihost:
        # every host runs the same command over its own residues with its
        # own cards; after --rerun-missing, so the rerun set is split too
        import numpy as np

        from basicrta_torch.parallel.distributed import (
            host_residue_partition)
        if run_resids is None:
            run_resids = np.unique(driver.events.sel1_resids)
        run_resids = host_residue_partition([int(r) for r in run_resids])
        if not run_resids:
            print("no residues for this host", file=sys.stderr)
            return

    def run():
        return driver.run(run_resids=run_resids, mode=args.mode,
                          engine=args.engine, device=args.device,
                          progress_cb=progress, n_devices=args.ndevices)

    if args.profile:
        results = _profiled(run, args.profile)
    else:
        results = run()
    print(file=sys.stderr)
    for label, g in results.items():
        lo, tau, hi = g.tau
        line = f"{label}: tau = {tau:.2f} ns  95% CI [{lo:.2f}, {hi:.2f}]"
        if args.nchains > 1:
            try:
                d = g.diagnostics()
                line += (f"  [R-hat {d['max_rhat']:.3f}, "
                         f"ESS {d['min_ess']:,.0f}]")
                if d["max_rhat"] > 1.1:
                    line += "  NOT CONVERGED"
            except ValueError as e:
                line += f"  [diagnostics unavailable: {e}]"
        print(line)


def _flagged_residues(path):
    """Labels a ``cluster --diagnostics`` archive (of either package)
    flagged; an archive without the 'flagged' key is screened again from
    its per-residue stats (NaN flags)."""
    import numpy as np
    try:
        with np.load(path) as z:
            if "flagged" in z.files:
                return [str(lab) for lab in z["flagged"]]
            return [str(lab) for lab, r, e in zip(
                z["labels"], z["max_rhat"], z["min_ess"])
                if not (r <= float(z["rhat_warn"])
                        and e >= float(z["ess_warn"]))]
    except (KeyError, AttributeError, IndexError) as e:
        raise SystemExit(
            f"{path} is not a diagnostics archive: expected a "
            f"diagnostics.npz from `cluster --diagnostics` with keys "
            f"flagged (or labels/max_rhat/min_ess/rhat_warn/ess_warn); "
            f"got {type(e).__name__}: {e}")


def _profiled(fn, outdir):
    """Run ``fn`` under torch.profiler (host and, with a card, device
    activities) and write its Chrome trace to ``outdir/gibbs_trace.json``
    (chrome://tracing, Perfetto)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "gibbs_trace.json")
    prof.export_chrome_trace(path)
    print(f"wrote {path}", file=sys.stderr)
    return out


def _draw(fn, what):
    """Draw one figure; without matplotlib say so on stderr instead."""
    try:
        fn()
    except ModuleNotFoundError as e:
        if e.name is None or not e.name.startswith("matplotlib"):
            raise
        print(f"{what} not drawn: matplotlib is not installed",
              file=sys.stderr)
        return
    print(f"wrote {what}")


def _cmd_cluster(args):
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.protein.driver import ProcessProtein

    pp = ProcessProtein(cfg=GibbsConfig(niter=args.niter), prot=args.prot,
                        cutoff=args.cutoff,
                        device="cpu" if args.engine == "torch" else "cuda")
    if args.reprocess:
        pp.reprocess()
    if not pp.collect_results():
        print(f"no residue results under basicrta-{args.cutoff}/ for "
              f"niter={args.niter}; run the gibbs subcommand first",
              file=sys.stderr)
        sys.exit(1)
    # every data file first: the figures need matplotlib, the data do not
    out = pp.write_data(all_clusters=args.all_clusters)
    print(f"wrote {out}")
    if args.all_clusters:
        print(f"wrote {out[:-4]}_all.npy")
    if args.diagnostics:
        path, flagged = pp.write_diagnostics()
        print(f"wrote {path}")
        if flagged:
            print(f"convergence warning ({len(flagged)} residues with "
                  "split-R-hat > 1.05 or bulk ESS < 100; rerun with more "
                  "chains/sweeps): " + " ".join(flagged), file=sys.stderr)
    if args.structure:
        print(f"wrote {pp.b_color_structure(args.structure)}")
    _draw(pp.plot_protein, "figs/t_slow.png")
    if args.all_clusters:
        _draw(pp.plot_taus_all, "figs/tau_clusters.png")


def _cmd_status(args):
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.protein.driver import ProcessProtein

    pp = ProcessProtein(cfg=GibbsConfig(niter=args.niter),
                        cutoff=args.cutoff)
    found = pp.collect_results()
    missing = set(pp.missing_residues())
    done = [k for k, v in found.items() if v is not None]
    skipped = [k for k, v in found.items()
               if v is None and k not in missing]
    print(f"done: {len(done)}  missing: {len(missing)}  "
          f"skipped: {len(skipped)}")
    if missing:
        print("missing:", " ".join(sorted(missing)))


def _cmd_kinetics(args):
    from basicrta_torch.kinetics.mapper import MapKinetics
    from basicrta_torch.sampler.gibbs import Gibbs

    g = Gibbs.load(args.gibbs)
    mk = MapKinetics(g, args.contacts, traj_format=args.traj_format,
                     device=args.device)
    for w in mk.create_traj(top_n=args.top_n):
        print(f"wrote {w}")
    if args.comp_trajs:
        for w in mk.write_component_trajs(step=args.step):
            print(f"wrote {w}")
    if args.wdensity:
        for w in mk.weighted_densities(step=args.step, top_n=args.top_n,
                                       filterP=args.filterP,
                                       xdim=args.grid_dim,
                                       ydim=args.grid_dim,
                                       zdim=args.grid_dim,
                                       delta=args.grid_delta):
            print(f"wrote {w}")


def build_parser() -> argparse.ArgumentParser:
    from basicrta_torch import __version__
    p = argparse.ArgumentParser(
        prog="basicrta-torch",
        description="Bayesian residence-time analysis on PyTorch/CUDA")
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("contacts", help="extract the contact map and "
                       "residence events from a trajectory")
    c.add_argument("--top", required=True)
    c.add_argument("--traj", required=True, nargs="+",
                   help="trajectory file, or several segment files read "
                        "as one continuous trajectory")
    c.add_argument("--sel1", required=True)
    c.add_argument("--sel2", required=True)
    c.add_argument("--cutoff", type=float, default=[7.0], nargs="+",
                   help="analysis cutoff(s) [A]; several values write one "
                        "event table each from the single scan")
    c.add_argument("--map-cutoff", type=float, default=10.0)
    c.add_argument("--dt", type=float, default=None,
                   help="frame interval [ns] for trajectories without a "
                        "time axis (DCD, mdcrd, time-less NetCDF)")
    c.add_argument("--batch", type=int, default=32,
                   help="trajectory frames per device batch")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the distance kernel runs: the card "
                        "(default; raises without one) or the CPU")
    c.add_argument("--ndevices", type=int, default=None,
                   help="shard frame batches over this many devices "
                        "(0: all visible cards; default: unsharded)")
    c.add_argument("--upload", choices=["auto", "f32", "u16"],
                   default="auto",
                   help="coordinate wire format for the device upload: "
                        "u16 halves bytes at a <=0.002 A grid error "
                        "(auto: u16 for XTC inputs, coarser than their "
                        "native 0.01 A storage grid; else exact f32)")
    c.add_argument("--checkpoint-every", type=int, default=0,
                   dest="checkpoint_every", metavar="FRAMES",
                   help="checkpoint the scan every FRAMES frames into "
                        "contacts.npz.ckpt/ and resume from it on rerun "
                        "(0: off)")
    c.set_defaults(fn=_cmd_contacts)

    g = sub.add_parser("gibbs", help="run Gibbs samplers for all residues")
    g.add_argument("--contacts", required=True)
    g.add_argument("--resid", type=int, default=None, nargs="*")
    g.add_argument("--niter", type=int, default=110_000)
    g.add_argument("--ncomp", type=int, default=15)
    g.add_argument("--g", type=int, default=100, help="thinning interval")
    g.add_argument("--burnin", type=int, default=None,
                   help="burn-in sweeps (default: min(10000, niter/10))")
    g.add_argument("--nchains", type=int, default=2,
                   help="independent chains per residue (default 2, for "
                        "split-R-hat/ESS; 1 is the reference's single "
                        "chain)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--engine", choices=["cuda", "torch", "collapsed"],
                   default=None,
                   help="sweep engine: the fused CUDA kernels on the card "
                        "(cuda, the default), their plain PyTorch versions "
                        "(torch, on the CPU unless --device cuda), or the "
                        "reference collapsed sweep (collapsed, the "
                        "counterpart of the JAX package's xla engine)")
    g.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the engine runs: the card (the default; "
                        "raises without one), or the CPU (the default of "
                        "--engine torch)")
    g.add_argument("--mode", choices=["batched", "sequential"],
                   default="batched",
                   help="every residue as lanes of one run (default), or "
                        "one residue after another")
    g.add_argument("--ndevices", type=int, default=None,
                   help="shard residue lanes over this many devices "
                        "(0: all visible cards; default: unsharded)")
    g.add_argument("--multihost", action="store_true",
                   help="join the cluster's process group (torchrun's "
                        "MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE) and "
                        "sample this host's residue subset (run the same "
                        "command on every host)")
    g.add_argument("--rerun-missing", action="store_true",
                   help="run only residues without results (failure-"
                        "detection sweep)")
    g.add_argument("--rerun-flagged", type=str, default=None,
                   metavar="DIAGNOSTICS_NPZ",
                   help="rerun only the residues a cluster --diagnostics "
                        "pass flagged as unconverged; combine with "
                        "--nchains/--niter/--seed to actually change the "
                        "chains")
    g.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to "
                        "DIR/gibbs_trace.json")
    g.set_defaults(fn=_cmd_gibbs)

    st = sub.add_parser("status", help="report per-residue result status")
    st.add_argument("--cutoff", type=float, required=True)
    st.add_argument("--niter", type=int, default=110_000)
    st.set_defaults(fn=_cmd_status)

    cl = sub.add_parser("cluster", help="aggregate tau across residues")
    cl.add_argument("--cutoff", type=float, required=True)
    cl.add_argument("--niter", type=int, default=110_000)
    cl.add_argument("--prot", type=str, default=None,
                    help="protein of the TM-helix bars under the tau "
                         "figure (an entry of data/tm_dict.json)")
    cl.add_argument("--structure", type=str, default=None,
                    help="write tau_bcolored.pdb: this structure with tau "
                         "in the b-factors")
    cl.add_argument("--reprocess", action="store_true")
    cl.add_argument("--engine", choices=["cuda", "torch"], default="cuda",
                    help="where --reprocess (or a residue without a saved "
                         "tau) post-processes: the card (default) or the "
                         "CPU")
    cl.add_argument("--all-clusters", action="store_true",
                    help="also write tau + CI for every non-noise cluster "
                         "(tausout_all.npy) and the stacked tau figure")
    cl.add_argument("--diagnostics", action="store_true",
                    help="write per-residue split-R-hat / bulk-ESS "
                         "convergence table (diagnostics.npz) and flag "
                         "unconverged residues")
    cl.set_defaults(fn=_cmd_cluster)

    k = sub.add_parser("kinetics", help="write component trajectories and "
                       "weighted densities")
    k.add_argument("--gibbs", required=True)
    k.add_argument("--contacts", required=True)
    k.add_argument("--top_n", type=int, default=None)
    k.add_argument("--step", type=int, default=1)
    k.add_argument("--wdensity", action="store_true")
    k.add_argument("--filterP", type=float, default=0.0,
                   help="zero membership weights below this before "
                        "density accumulation (reference kinetics.py:127)")
    k.add_argument("--comp-trajs", action="store_true",
                   help="also write per-component assigned-event "
                        "trajectories (comp{k}_traj.xtc)")
    k.add_argument("--traj-format", choices=("xtc", "trr", "dcd", "nc"),
                   default="xtc", dest="traj_format",
                   help="format of the reduced trajectories (nc = Amber "
                        "NetCDF)")
    k.add_argument("--grid-dim", type=float, default=40.0, dest="grid_dim",
                   help="density grid edge length [A] centered on the "
                        "residue (reference kinetics.py:167)")
    k.add_argument("--grid-delta", type=float, default=1.0,
                   dest="grid_delta", help="density grid resolution [A]")
    k.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the densities accumulate: the card "
                        "(default; raises without one) or the CPU")
    k.set_defaults(fn=_cmd_kinetics)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
