"""Command-line interface of the port.

Four subcommands of ``basicrta_tpu.cli``, from a trajectory file to tau::

    basicrta-torch contacts --top t.gro --traj t.xtc --sel1 protein \
        --sel2 "resname CHOL" --cutoff 7.0 [--device cuda|cpu]
    basicrta-torch gibbs --contacts contacts_7.0.npz [--resid 313] \
        [--engine cuda|torch]
    basicrta-torch status --cutoff 7.0
    basicrta-torch cluster --cutoff 7.0 [--engine cuda|torch]

All run on the card unless ``--device cpu`` / ``--engine torch`` asks for
the CPU.

``cluster`` writes the tau table (``tausout.npy``); figures wait for the
port of the plotting module.
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
                         device=args.device)
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

    driver = ParallelGibbs(args.contacts, cfg=cfg)
    results = driver.run(run_resids=args.resid, engine=args.engine,
                         progress_cb=progress)
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


def _cmd_cluster(args):
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.protein.driver import ProcessProtein

    pp = ProcessProtein(cfg=GibbsConfig(niter=args.niter),
                        cutoff=args.cutoff,
                        device="cpu" if args.engine == "torch" else "cuda")
    if args.reprocess:
        pp.reprocess()
    if not pp.collect_results():
        print(f"no residue results under basicrta-{args.cutoff}/ for "
              f"niter={args.niter}; run the gibbs subcommand first",
              file=sys.stderr)
        sys.exit(1)
    print(f"wrote {pp.write_data()}")


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
    g.add_argument("--engine", choices=["cuda", "torch"], default="cuda",
                   help="sweep engine: the fused CUDA kernels on the card "
                        "(default), or their plain PyTorch versions on the "
                        "CPU")
    g.set_defaults(fn=_cmd_gibbs)

    st = sub.add_parser("status", help="report per-residue result status")
    st.add_argument("--cutoff", type=float, required=True)
    st.add_argument("--niter", type=int, default=110_000)
    st.set_defaults(fn=_cmd_status)

    cl = sub.add_parser("cluster", help="aggregate tau across residues")
    cl.add_argument("--cutoff", type=float, required=True)
    cl.add_argument("--niter", type=int, default=110_000)
    cl.add_argument("--reprocess", action="store_true")
    cl.add_argument("--engine", choices=["cuda", "torch"], default="cuda",
                    help="where --reprocess (or a residue without a saved "
                         "tau) post-processes: the card (default) or the "
                         "CPU")
    cl.set_defaults(fn=_cmd_cluster)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
