"""Command-line interface of the port.

Three subcommands of ``basicrta_tpu.cli`` on the Gibbs main path::

    basicrta-torch gibbs --contacts contacts_7.0.npz [--resid 313] \
        [--engine cuda|torch]
    basicrta-torch status --cutoff 7.0
    basicrta-torch cluster --cutoff 7.0 [--engine cuda|torch]

Both run on the card unless ``--engine torch`` asks for the CPU.

``cluster`` writes the tau table (``tausout.npy``); figures wait for the
port of the plotting module.
"""

from __future__ import annotations

import argparse
import sys
import time


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
