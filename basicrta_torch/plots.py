"""Plotting: per-residue posterior figures and protein-level tau maps.

Port of ``basicrta_tpu.plots`` (reference util.py:123-454,694-1198;
gibbs.py:383-778; cluster.py:136-155), a lean, non-interactive (Agg)
implementation: every function writes PNG+PDF and returns the figure.
matplotlib is imported when a function first draws, not when this module
is imported: the card's machine has none, and no device path draws.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Optional

import numpy as np

_TM_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "tm_dict.json")


def _pyplot():
    """matplotlib's pyplot on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def load_tm_dict(path: Optional[str] = None) -> dict:
    """TM helix ranges; reads the bundled JSON or a user tm_dict.txt in the
    reference's Python-literal format (reference util.py:403-412)."""
    if path is None:
        path = _TM_JSON
    with open(path) as f:
        text = f.read()
    try:
        d = json.loads(text)
        d.pop("_comment", None)
        return d
    except json.JSONDecodeError:
        return ast.literal_eval(text)


def _save(fig, basename: Optional[str]):
    if basename:
        os.makedirs(os.path.dirname(basename) or ".", exist_ok=True)
        fig.savefig(f"{basename}.png", bbox_inches="tight", dpi=150)
        fig.savefig(f"{basename}.pdf", bbox_inches="tight")
    return fig


def plot_tau_stack(tables, basename="figs/tau_clusters", scale: float = 1.0):
    """Stacked per-cluster tau figure: every non-noise process of every
    residue as a point with its 95% CI, log tau axis (companion to the
    slowest-process plot_protein; reference gibbs.py:693-698 declares
    per-cluster taus as future work).

    Args:
        tables: {residue label: (C, 4) rows [cluster, ci_lo, tau, ci_hi]}
            as produced by ProcessProtein.get_taus_all().
    """
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5 * scale, 3 * scale))
    labels = sorted(tables, key=lambda s: int(str(s)[1:])
                    if str(s)[1:].isdigit() else 0)
    max_c = 0
    for lab in labels:
        resid = int(str(lab)[1:]) if str(lab)[1:].isdigit() else 0
        table = np.asarray(tables[lab]).reshape(-1, 4)
        for ci, lo, tau, hi in table:
            k = int(ci)
            max_c = max(max_c, k)
            color = f"C{k % 10}"
            ax.errorbar([resid], [tau],
                        yerr=[[max(tau - lo, 0.0)], [max(hi - tau, 0.0)]],
                        fmt=".", color=color, alpha=0.7, markersize=4)
    for k in range(max_c + 1):
        ax.plot([], [], ".", color=f"C{k % 10}", label=f"cluster {k}")
    ax.set_yscale("log")
    ax.set_xlabel("residue")
    ax.set_ylabel(r"$\tau$ [ns]")
    if max_c < 10:
        ax.legend(fontsize=6, ncol=2)
    return _save(fig, basename)


def plot_protein(residues, taus, bars, prot: Optional[str] = None,
                 label_cutoff: float = 3.0, ylim=None, scale: float = 1.0,
                 tm_path: Optional[str] = None, basename="figs/t_slow"):
    """Tau vs residue with error bars and TM-helix bars
    (reference util.py:403-454, cluster.py:136-155)."""
    plt = _pyplot()
    from matplotlib.patches import Rectangle

    resids = np.array([int(str(r)[1:]) if str(r)[0].isalpha() else int(r)
                       for r in residues])
    taus = np.asarray(taus)
    bars = np.asarray(bars)

    fig, axs = plt.subplots(2, 1, figsize=(4 * scale, 3 * scale),
                            sharex=True,
                            gridspec_kw={"height_ratios": [8, 1]})
    axs[0].plot(resids, taus, ".", color="C0")
    axs[0].errorbar(resids, taus, yerr=bars, fmt="none", color="C0",
                    alpha=0.5)
    if taus.size:
        for ind in np.where(taus > label_cutoff * taus.mean())[0]:
            axs[0].text(resids[ind], taus[ind], str(residues[ind]))
    axs[0].set_ylabel(r"$\tau$ [ns]")
    if ylim is not None:
        axs[0].set_ylim(ylim)
    axs[1].set_xlabel("residue")
    axs[1].set_yticks([])
    if prot is not None:
        try:
            helices = load_tm_dict(tm_path)[prot]["helices"]
            for rng in helices.values():
                axs[1].add_patch(Rectangle((rng[0], 0), rng[1] - rng[0], 1,
                                           color="C0"))
            axs[1].set_xlim(axs[0].get_xlim())
        except (FileNotFoundError, KeyError):
            import warnings
            warnings.warn("TM ranges unavailable; bars not drawn")
    fig.subplots_adjust(hspace=0.05)
    return _save(fig, basename)


def plot_surv(gibbs, remove_noise=False, scale=1.0, xlim=None,
              ylim=(1e-6, 5), basename=None):
    """Survival function with per-cluster exponential components
    (reference gibbs.py:717-778)."""
    plt = _pyplot()
    rp = gibbs.processed
    imaxs = rp.pindicator_values.max(axis=0)
    labels = np.unique(rp.labels)
    if remove_noise:
        labels = labels[imaxs[labels] >= gibbs.cfg.noise_cutoff]
    fig, ax = plt.subplots(figsize=(4 * scale, 3 * scale))
    ax.plot(gibbs.t, gibbs.s, ".", ms=3, label="data")
    for i in labels:
        w, r = gibbs.parameters[i]
        ax.plot(gibbs.t, w * np.exp(-r * gibbs.t), label=f"{i}",
                color=f"C{(i % 9) + 1}")
    ax.set_yscale("log")
    ax.set_ylim(ylim)
    if xlim:
        ax.set_xlim(xlim)
    ax.set_xlabel("$t$ [ns]")
    ax.set_ylabel("survival function $s$")
    ax.legend(title="cluster", fontsize=7)
    basename = basename or os.path.join(gibbs.savedir, "s_vs_t")
    return _save(fig, basename)


def plot_gibbs_traces(gibbs, chain=0, sparse=1, scale=1.5, basename=None):
    """Thinned weight/rate traces (reference gibbs.py:640-665)."""
    plt = _pyplot()
    W, R = gibbs.mcweights[chain], gibbs.mcrates[chain]
    fig, ax = plt.subplots(2, figsize=(4 * scale, 3 * scale), sharex=True)
    it = np.arange(W.shape[0])[::sparse]
    for k in range(W.shape[1]):
        ax[0].plot(it, W[::sparse, k], ".", ms=2)
        ax[1].plot(it, R[::sparse, k], ".", ms=2)
    ax[0].set_yscale("log")
    ax[0].set_ylabel(r"$\pi_k$")
    ax[1].set_yscale("log")
    ax[1].set_ylabel(r"$\lambda_k$ [ns$^{-1}$]")
    ax[1].set_xlabel("sample")
    basename = basename or os.path.join(gibbs.savedir, "plot_results")
    return _save(fig, basename)


def plot_cluster_scatter(gibbs, scale=2.0, remove_noise=False,
                         basename=None):
    """Posterior (weight, rate) pairs colored by cluster — the essential
    panel of the reference's mixture_and_plot figure set
    (reference util.py:1030-1124). ``remove_noise`` drops clusters whose
    membership probability never reaches the noise cutoff
    (reference gibbs.py:310-319)."""
    plt = _pyplot()
    rp = gibbs.processed
    labels = np.unique(rp.labels)
    if remove_noise:
        imaxs = rp.pindicator_values.max(axis=0)
        labels = labels[imaxs[labels] >= gibbs.cfg.noise_cutoff]
    fig, ax = plt.subplots(figsize=(4 * scale, 3 * scale))
    for i in labels:
        sel = rp.labels == i
        ax.plot(rp.data[sel, 1], rp.data[sel, 0], ".", ms=3,
                label=f"{i}", color=f"C{i % 10}")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel(r"$\lambda_k$ [ns$^{-1}$]")
    ax.set_ylabel(r"$\pi_k$")
    ax.legend(title="cluster", fontsize=7)
    basename = basename or os.path.join(gibbs.savedir,
                                        "weight_vs_rate_results_all")
    return _save(fig, basename)


def plot_tau_hist(gibbs, scale=1.0, basename=None):
    """Histogram of tau samples of the slowest non-noise cluster
    (reference gibbs.py:383-425)."""
    plt = _pyplot()
    rp = gibbs.processed
    imaxs = rp.pindicator_values.max(axis=0)
    non_noise = np.where(imaxs >= gibbs.cfg.noise_cutoff)[0]
    basename = basename or os.path.join(gibbs.savedir, "tau_hist")
    if non_noise.size == 0:
        # every cluster is noise (the AllNoiseError case, tau = 0):
        # emit the results-unavailable figure instead of crashing on
        # argmin of an empty set
        fig, ax = plt.subplots(figsize=(4 * scale, 3 * scale))
        ax.set_title("Results unavailable (all clusters are noise)")
        ax.set_xlabel(r"$\tau$ [ns]")
        ax.set_ylabel("count")
        return _save(fig, basename)
    slowest = non_noise[np.argmin(gibbs.parameters[non_noise, 1])]
    taus = 1.0 / rp.data[rp.labels == slowest, 1]
    fig, ax = plt.subplots(figsize=(4 * scale, 3 * scale))
    ax.hist(taus, bins=15, alpha=0.6, color=f"C{slowest % 10}")
    ax.set_xlabel(r"$\tau$ [ns]")
    ax.set_ylabel("count")
    return _save(fig, basename)


def plot_hist_results(gibbs, bins=15, scale=1.0, component=None,
                      basename=None):
    """Posterior weight/rate/tau histograms per cluster
    (reference gibbs.py:427-638, simplified layout); ``component``
    restricts to the given cluster id(s)."""
    plt = _pyplot()
    rp = gibbs.processed
    clusters = (np.unique(rp.labels) if component is None
                else np.atleast_1d(component))
    fig, axs = plt.subplots(1, 3, figsize=(9 * scale, 3 * scale))
    for i in clusters:
        sel = rp.labels == i
        axs[0].hist(rp.data[sel, 0], bins=bins, alpha=0.5, density=True,
                    label=f"{i}", color=f"C{i % 10}")
        axs[1].hist(rp.data[sel, 1], bins=bins, alpha=0.5, density=True,
                    color=f"C{i % 10}")
        axs[2].hist(1.0 / rp.data[sel, 1], bins=bins, alpha=0.5,
                    density=True, color=f"C{i % 10}")
    axs[0].set_xlabel(r"$\pi_k$")
    axs[1].set_xlabel(r"$\lambda_k$ [ns$^{-1}$]")
    axs[2].set_xlabel(r"$\tau$ [ns]")
    axs[0].set_ylabel("p")
    axs[0].legend(title="cluster", fontsize=7)
    basename = basename or os.path.join(gibbs.savedir, "hist_results")
    return _save(fig, basename)


# --------------------------------------------------------------------- #
# per-residue diagnostic family (reference util.py:170-400, 564-584)
# --------------------------------------------------------------------- #

def _cluster_posteriors(gibbs):
    """Per-cluster (weights_list, rates_list) from processed results —
    the analogue of the reference results object's .weights/.rates
    attributes (reference util.py:663-692 extract_data)."""
    rp = gibbs.processed
    labels = np.unique(rp.labels)
    w = [rp.data[rp.labels == i, 0] for i in labels]
    r = [rp.data[rp.labels == i, 1] for i in labels]
    return labels, w, r


def _figdir(gibbs) -> str:
    d = os.path.join(gibbs.savedir, "figs")
    os.makedirs(d, exist_ok=True)
    return d


def plot_results(gibbs, cond: str = "ml", scale=1.0, basename=None):
    """Survival function with the mixture fit from cluster point estimates
    (reference util.py:170-216): ``cond='ml'`` uses the tallest-histogram-
    bin estimate per cluster, ``cond='mean'`` posterior means."""
    plt = _pyplot()
    labels, wposts, rposts = _cluster_posteriors(gibbs)
    if cond == "mean":
        weights = np.array([w.mean() for w in wposts])
        rates = np.array([r.mean() for r in rposts])
    elif cond == "ml":
        weights, rates = [], []
        for w, r in zip(wposts, rposts):
            hw, ew = np.histogram(w, bins=10, density=True)
            hr, er = np.histogram(r, bins=10, density=True)
            weights.append(ew[hw.argmax()])
            rates.append(er[hr.argmax()])
        weights, rates = np.array(weights), np.array(rates)
    else:
        raise ValueError("only 'ml' and 'mean' point estimates exist")
    weights = weights / weights.sum()

    fig, ax = plt.subplots(figsize=(4 * scale, 3 * scale))
    ax.scatter(gibbs.t, gibbs.s, s=15, label="data")
    ax.plot(gibbs.t, np.inner(weights,
                              np.exp(np.outer(gibbs.t, -rates))),
            label="fit", color="y", ls="dashed", lw=3)
    for i, lab in enumerate(labels):
        ax.plot(gibbs.t, weights[i] * np.exp(-rates[i] * gibbs.t),
                label=f"Comp.{lab}", color=f"C{lab % 10}")
    ax.plot([], [], " ",
            label=rf"$\tau$={np.round(1 / rates.min(), 1)} ns")
    ax.set_yscale("log")
    ax.set_ylim(0.8 * gibbs.s[-2], 2)
    ax.set_xlim(-0.05 * gibbs.t[-2], 1.1 * gibbs.t[-2])
    ax.legend(fontsize=7)
    ax.set_xlabel("time (ns)")
    ax.set_ylabel("s")
    K = len(labels)
    basename = basename or os.path.join(_figdir(gibbs),
                                        f"k{K}-{cond}_results")
    return _save(fig, basename)


def all_post_hist(gibbs, wlims=None, rlims=None, scale=1.0):
    """Log-log posterior histograms of every cluster, one figure per
    attribute (reference util.py:218-242)."""
    plt = _pyplot()
    labels, wposts, rposts = _cluster_posteriors(gibbs)
    K = len(labels)
    figs = []
    for attr, posts, unit, lims in (("weights", wposts, "", wlims),
                                    ("rates", rposts, r" (ns$^{-1}$)",
                                     rlims)):
        fig, ax = plt.subplots(figsize=(4 * scale, 3 * scale))
        for lab, post in zip(labels, posts):
            ax.hist(post, density=True, bins=15, label=f"comp. {lab}",
                    alpha=0.5, color=f"C{lab % 10}")
        ax.legend(fontsize=7)
        ax.set_xlabel(f"{attr}{unit}")
        ax.set_ylabel("p")
        ax.set_xscale("log")
        ax.set_yscale("log")
        if lims:
            ax.set_xlim(lims[0])
            ax.set_ylim(lims[1])
        figs.append(_save(fig, os.path.join(
            _figdir(gibbs), f"k{K}-posterior_{attr}_comp-all")))
    return figs


def plot_post(gibbs, attr: str, comp=None, bins=None, scale=1.0):
    """Posterior histogram(s) of one attribute: overlay of the chosen
    components, or one figure per component (reference util.py:245-280)."""
    plt = _pyplot()
    labels, wposts, rposts = _cluster_posteriors(gibbs)
    posts = dict(weights=wposts, rates=rposts)[attr]
    unit = r" (ns$^{-1}$)" if attr == "rates" else ""
    K = len(labels)
    by_label = dict(zip(labels.tolist(), posts))
    if comp:
        fig, ax = plt.subplots(figsize=(4 * scale, 3 * scale))
        for i in comp:
            ax.hist(by_label[i], density=True, bins=bins or 50,
                    label=f"comp. {i}", color=f"C{i % 10}", alpha=0.6)
        ax.legend(fontsize=7)
        ax.set_xlabel(f"{attr[:-1]}{unit}")
        ax.set_ylabel("p")
        tag = "-".join(str(i) for i in comp)
        return _save(fig, os.path.join(
            _figdir(gibbs), f"k{K}-posterior_{attr}_comps-{tag}"))
    figs = []
    for i in labels:
        fig, ax = plt.subplots(figsize=(4 * scale, 3 * scale))
        ax.hist(by_label[i], density=True, bins=bins or 15,
                color=f"C{i % 10}")
        ax.set_xlabel(f"{attr[:-1]}{unit}")
        ax.set_ylabel("p")
        figs.append(_save(fig, os.path.join(
            _figdir(gibbs), f"k{K}-posterior_{attr}_comp-{i}")))
    return figs


def plot_trace(gibbs, attr: str, comp=None, chain=0, xrange=None,
               yrange=None, scale=1.0):
    """Raw thinned-chain traces of mcweights/mcrates columns
    (reference util.py:282-323)."""
    plt = _pyplot()
    tmp = dict(weights=gibbs.mcweights,
               rates=gibbs.mcrates)[attr][chain]
    K = tmp.shape[1]
    cols = comp if comp else range(K)
    fig, ax = plt.subplots(figsize=(4 * scale, 3 * scale))
    for j in cols:
        ax.plot(np.arange(tmp.shape[0]), tmp[:, j], label=f"Comp. {j}",
                color=f"C{j % 10}", lw=0.7)
    ax.set_xlabel("iteration")
    ax.set_ylabel(attr)
    ax.legend(fontsize=6, ncol=2)
    if xrange is not None:
        ax.set_xlim(xrange)
    if yrange is not None:
        ax.set_ylim(yrange)
    tag = ("" if not comp else
           "_comps-" + "-".join(str(i) for i in comp))
    return _save(fig, os.path.join(_figdir(gibbs),
                                   f"k{K}-trace_{attr}{tag}"))


def plot_r_vs_w(gibbs, rrange=None, wrange=None, scale=1.0):
    """Posterior rate-vs-weight scatter per cluster
    (reference util.py:1200-1227)."""
    plt = _pyplot()
    rp = gibbs.processed
    fig, ax = plt.subplots(figsize=(4 * scale, 3 * scale))
    for i in np.unique(rp.labels):
        sel = rp.labels == i
        ax.plot(rp.data[sel, 0], rp.data[sel, 1], ".", ms=3,
                label=f"{i}", color=f"C{i % 10}")
    ax.set_xscale("log")
    ax.set_yscale("log")
    if wrange:
        ax.set_xlim(wrange)
    if rrange:
        ax.set_ylim(rrange)
    ax.set_xlabel(r"$\pi_k$")
    ax.set_ylabel(r"$\lambda_k$ [ns$^{-1}$]")
    ax.legend(title="cluster", fontsize=7)
    return _save(fig, os.path.join(_figdir(gibbs), "r_vs_w"))


def make_residue_plots(gibbs, comps=None):
    """The reference's one-call per-residue figure set
    (reference util.py:384-400): both point-estimate fits, posterior
    histograms, and traces."""
    figs = [plot_results(gibbs, cond="mean"),
            plot_results(gibbs, cond="ml"),
            plot_post(gibbs, "weights", comp=comps),
            plot_post(gibbs, "rates", comp=comps),
            plot_trace(gibbs, "weights", comp=comps, yrange=[-0.1, 1.1]),
            plot_trace(gibbs, "rates", comp=comps, yrange=[-0.1, 6])]
    return figs


def collect_n_plot(resids=None, comps=None, cutoff: float = 7.0,
                   niter: int = 110_000, root: str = "."):
    """Load saved per-residue results and render the full diagnostic set
    for each (reference util.py:365-382): residue figure set, pooled
    posterior histograms, and the rate-vs-weight scatter."""
    from basicrta_torch.config import GibbsConfig
    from basicrta_torch.protein.driver import ProcessProtein
    from basicrta_torch.sampler.gibbs import Gibbs
    pp = ProcessProtein(cfg=GibbsConfig(niter=niter), cutoff=cutoff,
                        root=root)
    found = pp.collect_results()
    done = []
    for label, path in found.items():
        if path is None:
            continue
        if resids is not None and int(label[1:]) not in np.atleast_1d(
                resids):
            continue
        g = Gibbs.load(path)
        g.root = root
        make_residue_plots(g, comps)
        all_post_hist(g, rlims=[[1e-3, 10], [1e-2, 1e3]],
                      wlims=[[1e-4, 1.1], [1e-1, 1e4]])
        plot_r_vs_w(g, rrange=[1e-3, 10], wrange=[1e-4, 5])
        done.append(label)
    return done


def plot_hists(timelens, indicators, residues, outdir="result_check",
               scale=1.0):
    """Per-residue residence-time histograms weighted by component
    membership (reference util.py:564-584)."""
    plt = _pyplot()
    os.makedirs(outdir, exist_ok=True)
    figs = []
    for timelen, indicator, residue in zip(timelens, indicators, residues):
        indicator = np.asarray(indicator)
        ncomps = indicator.shape[0]
        fig, ax = plt.subplots(figsize=(4 * scale, 3 * scale))
        for i in range(ncomps):
            h, edges = np.histogram(timelen, density=True, bins=50,
                                    weights=indicator[i])
            m = 0.5 * (edges[1:] + edges[:-1])
            ax.plot(m, h, ".", label=i, alpha=0.5, color=f"C{i % 10}")
        ax.set_ylabel("p")
        ax.set_xlabel("time (ns)")
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_ylim(1e-6, 1)
        ax.legend(fontsize=7)
        figs.append(_save(fig, os.path.join(
            outdir, f"{residue}_hists_{ncomps}")))
    return figs


# --------------------------------------------------------------------- #
# mixture_and_plot: the train/validate/all panel sets
# (reference util.py:694-1198)
# --------------------------------------------------------------------- #

def mixture_and_plot(gibbs, chain=0, scale=2.0, sparse=1,
                     remove_noise=False, wlim=None, rlim=None):
    """Clustering-diagnostic figure sets over three sample subsets:
    *train* (samples with exactly lmode surviving components, used to fit
    the GMM), *validate* (the rest), and *all*.

    For each subset writes the combined 2x2 figure
    (``combined_results_{subset}``: rate histogram, weight trace,
    weight-vs-rate scatter, rate trace) plus the four individual figures
    (``result_hist_``, ``weight_results_``, ``rate_results_``,
    ``weight_vs_rate_results_{subset}``), PNG+PDF, ``_noiserm`` suffix
    with ``remove_noise``. Labels are already rate-sorted with noise last
    by processing (clustering.sort_labels_by_rate).

    Returns:
        (all_labels, presorts) like the reference.
    """
    plt = _pyplot()
    rp = gibbs.processed
    b = gibbs.cfg.burnin_samples
    W = np.asarray(gibbs.mcweights[chain])[b:]
    wcutoff = gibbs.cfg.wcutoff(len(gibbs.times))
    lens = (W > wcutoff).sum(axis=1)
    train_rows = lens == rp.lmode

    sample_idx = rp.inds[0]
    is_train = train_rows[sample_idx]
    weights, rates = rp.data[:, 0], rp.data[:, 1]
    labels = rp.labels
    uniq = np.unique(labels)
    if remove_noise:
        imaxs = rp.pindicator_values.max(axis=0)
        uniq = uniq[imaxs[uniq] >= gibbs.cfg.noise_cutoff]
    wmin, wmax = wlim if wlim is not None else (wcutoff, 2)
    rmin, rmax = rlim if rlim is not None else (rates.min(), 10)

    subsets = {"train": is_train, "validate": ~is_train,
               "all": np.ones_like(is_train)}
    suffix = "_noiserm" if remove_noise else ""
    for subset, mask in subsets.items():
        figc, axc = plt.subplots(2, 2, figsize=(4 * scale, 3 * scale))
        figh, axh = plt.subplots(figsize=(4, 3))
        figw, axw = plt.subplots(figsize=(4, 3))
        figr, axr = plt.subplots(figsize=(4, 3))
        figs, axs = plt.subplots(figsize=(4, 3))
        for i in uniq[::-1]:
            sel = mask & (labels == i)
            if not sel.any():
                continue
            color = f"C{i % 10}"
            r_i, w_i, it_i = rates[sel], weights[sel], sample_idx[sel]
            bins = np.linspace(r_i.min(), r_i.max(), 50)
            for ax in (axc[0, 0], axh):
                ax.hist(r_i, bins=bins, alpha=0.5, color=color,
                        label=f"{i}")
            for ax in (axc[0, 1], axw):
                ax.plot(it_i[::sparse], w_i[::sparse], ".", ms=2,
                        color=color, label=f"{i}")
            for ax in (axc[1, 1], axr):
                ax.plot(it_i[::sparse], r_i[::sparse], ".", ms=2,
                        color=color, label=f"{i}")
            for ax in (axc[1, 0], axs):
                ax.plot(r_i, w_i, ".", ms=2, color=color, label=f"{i}")
        for ax in (axc[0, 0], axh):
            ax.set_xscale("log")
            ax.set_xlabel(r"$\lambda_k$ [ns$^{-1}$]")
            ax.set_ylabel("count")
            ax.set_xlim(rmin, rmax)
        for ax in (axc[0, 1], axw):
            ax.set_yscale("log")
            ax.set_ylabel(r"$\pi_k$")
            ax.set_xlabel("sample")
            ax.set_ylim(wmin, wmax)
        for ax in (axc[1, 1], axr):
            ax.set_yscale("log")
            ax.set_ylabel(r"$\lambda_k$ [ns$^{-1}$]")
            ax.set_xlabel("sample")
            ax.set_ylim(rmin, rmax)
        for ax in (axc[1, 0], axs):
            ax.set_xscale("log")
            ax.set_yscale("log")
            ax.set_xlabel(r"$\lambda_k$ [ns$^{-1}$]")
            ax.set_ylabel(r"$\pi_k$")
            ax.set_xlim(rmin, rmax)
            ax.set_ylim(wmin, wmax)
        axh.legend(title="cluster", fontsize=6)
        figc.legend(*axc[0, 0].get_legend_handles_labels(),
                    loc="lower center", ncols=min(len(uniq), 6),
                    title="cluster", fontsize=6)
        figc.tight_layout(rect=(0, 0.07, 1, 1))
        base = gibbs.savedir
        _save(figc, os.path.join(base,
                                 f"combined_results_{subset}{suffix}"))
        _save(figh, os.path.join(base, f"result_hist_{subset}{suffix}"))
        _save(figw, os.path.join(base,
                                 f"weight_results_{subset}{suffix}"))
        _save(figr, os.path.join(base, f"rate_results_{subset}{suffix}"))
        _save(figs, os.path.join(
            base, f"weight_vs_rate_results_{subset}{suffix}"))
        plt.close("all")
    return rp.labels, rp.presorts


def check_results_placeholder(residue, times, ts, outdir="result_check"):
    """'Results unavailable' survival plot for residues without results
    (reference util.py:488-505)."""
    plt = _pyplot()
    from basicrta_torch.ops.surv import survival_function
    os.makedirs(outdir, exist_ok=True)
    t, s = survival_function(np.asarray(times), ts)
    fig, ax = plt.subplots(figsize=(4, 3))
    ax.scatter(t, s, label="data", s=8)
    ax.set_xlabel("t (ns)")
    ax.set_ylabel("s")
    ax.set_title("Results unavailable")
    ax.legend()
    return _save(fig, os.path.join(outdir, f"{residue}-s-vs-t"))
