"""Bucketed post-processing (``postprocess.batched``) of basicrta_torch
against the JAX package's ``process_residues_batched`` on hand-built,
well-separated posterior chains (two surviving components: rate 5.0
weight 0.7, rate 0.05 weight 0.3). The two packages draw different random
numbers, so they agree on what the data decide: lmode, the label
partition up to a permutation, and the votes' clusters."""

import numpy as np
import pytest
import torch

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.postprocess.batched import \
    process_residues_batched as jax_batched
from basicrta_torch.postprocess import batched
from basicrta_torch.postprocess import clustering as clu
from basicrta_torch.postprocess.clustering import process_samples

_CFG = GibbsConfig(ncomp=8, niter=6000, g=100, burnin=1000, gmm_n_init=8)


def _fake_chain(rng, S, K, live=((0.7, 5.0), (0.3, 0.05))):
    W = rng.uniform(1e-7, 1e-6, (S, K))
    R = rng.uniform(0.5, 2.0, (S, K))
    for k, (w, r) in enumerate(live):
        W[:, k] = w * np.exp(rng.normal(0.0, 0.05, S))
        R[:, k] = r * np.exp(rng.normal(0.0, 0.05, S))
    return W, R


def _fake_residue(rng, n_events, S=60, K=8, chains=1, **kw):
    Ws, Rs = zip(*[_fake_chain(rng, S, K, **kw) for _ in range(chains)])
    raw = np.where(rng.random(n_events) < 0.7,
                   rng.exponential(1.0 / 5.0, n_events),
                   rng.exponential(1.0 / 0.05, n_events))
    disc = np.maximum(np.round(raw / 0.1), 1.0) * 0.1
    values, counts = np.unique(disc, return_counts=True)
    return (np.stack(Ws), np.stack(Rs), values.astype(np.float64),
            counts.astype(np.float64))


@pytest.fixture(scope="module")
def items():
    rng = np.random.default_rng(42)
    return {f"R{i}": _fake_residue(rng, n)
            for i, n in enumerate([800, 1500, 3000, 5200, 9000])}


@pytest.fixture(scope="module")
def results(items):
    return (batched.process_residues_batched(items, _CFG, device="cpu"),
            jax_batched(items, _CFG))


def _same_partition(a, b):
    return len(set(zip(a.tolist(), b.tolist()))) == len(set(a.tolist()))


def _votes_agree(g, j, counts):
    """The data decide the votes: where a value carries many events both
    packages split them alike (a value seen once votes S times, so its
    fraction is Monte-Carlo noise), and the event-weighted mean gap is
    small."""
    gap = np.abs(g.pindicator_values - j.pindicator_values).max(1)
    assert gap[counts >= 20].max() < 0.05
    assert (gap * counts).sum() / counts.sum() < 0.01


def test_matches_jax(items, results):
    got, ref = results
    assert list(got) == list(items)
    for name in items:
        g, j = got[name], ref[name]
        assert g.lmode == j.lmode == 2
        assert _same_partition(g.labels, j.labels)
        np.testing.assert_array_equal(g.inds[0], j.inds[0])
        np.testing.assert_allclose(g.pindicator_values.sum(1), 1.0,
                                   atol=1e-5)
        _votes_agree(g, j, items[name][3])
        # relabelled by decreasing rate, the GMM's arbitrary label ids
        # drop out: the final labels are identical
        np.testing.assert_array_equal(g.labels, j.labels)


def test_agrees_with_the_per_residue_path(items, results):
    got, _ = results
    for name, (W, R, v, c) in items.items():
        one = process_samples(torch.Generator().manual_seed(0), W[0],
                              R[0], v, c, _CFG)
        assert one.lmode == got[name].lmode
        assert _same_partition(one.labels, got[name].labels)


def test_a_residue_is_independent_of_its_bucket_mates(items, results):
    got, _ = results
    alone = batched.process_residues_batched({"R2": items["R2"]}, _CFG,
                                             device="cpu")["R2"]
    rng = np.random.default_rng(7)
    mates = {"X": _fake_residue(rng, 2900), "R2": items["R2"],
             "Y": _fake_residue(rng, 3100)}
    crowd = batched.process_residues_batched(mates, _CFG,
                                             device="cpu")["R2"]
    for res in (alone, crowd):
        np.testing.assert_array_equal(res.labels, got["R2"].labels)
        np.testing.assert_array_equal(res.pindicator_values,
                                      got["R2"].pindicator_values)


def test_votes_keep_every_label_when_k_exceeds_ncomp():
    """Six live components in chains of K = 8 under cfg.ncomp = 4: the
    one-hot is built at the chain's K, so every event votes."""
    rng = np.random.default_rng(3)
    live = [(0.3, 5.0), (0.2, 1.0), (0.2, 0.3), (0.15, 0.1), (0.1, 0.03),
            (0.05, 0.01)]
    cfg = GibbsConfig(ncomp=4, niter=6000, g=100, burnin=1000, gmm_n_init=4)
    item = _fake_residue(rng, 4000, live=live)
    res = batched.process_residues_batched({"A": item}, cfg,
                                           device="cpu")["A"]
    assert res.lmode == 6
    np.testing.assert_allclose(res.pindicator_values.sum(1), 1.0, atol=1e-5)
    # all six clusters collect votes
    assert (res.pindicator_values.max(0) > 0).all()
    # with every component labelled, the votes count every event of every
    # sample
    W, R, v, c = item
    S = W.shape[1] - cfg.burnin_samples
    lab = np.zeros((1, S, 8), np.int64)
    lab[0, :, :6] = np.arange(6)
    votes = clu.votes_bucket(
        *(torch.as_tensor(x) for x in (
            W[:, cfg.burnin_samples:].astype(np.float32),
            R[:, cfg.burnin_samples:].astype(np.float32),
            v[None].astype(np.float32), c[None].astype(np.float32), lab)),
        [torch.Generator().manual_seed(1)])
    np.testing.assert_array_equal(votes.sum(-1)[0].numpy(), c * S)


def test_vote_chunks_cover_large_buckets():
    """S x V > 4M (2,100 samples x 2,048 padded values): the votes run in
    sample chunks, still count every event, and agree with the JAX
    package's chunked vote program."""
    rng = np.random.default_rng(11)
    cfg = GibbsConfig(ncomp=4, niter=221000, g=100, burnin=11000,
                      gmm_n_init=4)
    item = _fake_residue(rng, 60000, S=2210, K=4)
    W, R, v, c = item
    assert 512 < len(v) <= 2048
    S = W.shape[1] - cfg.burnin_samples
    assert S * batched._pad_size(len(v)) > 4_000_000
    got = batched.process_residues_batched({"A": item}, cfg,
                                           device="cpu")["A"]
    ref = jax_batched({"A": item}, cfg)["A"]
    assert got.lmode == ref.lmode == 2
    assert _same_partition(got.labels, ref.labels)
    _votes_agree(got, ref, c)
    # the chunked pass itself: with every component labelled, every event
    # of every sample votes once
    lab = np.zeros(W[:, cfg.burnin_samples:].shape, np.int64)
    votes = clu.votes_bucket(
        *(torch.as_tensor(x) for x in (
            W[:, cfg.burnin_samples:].astype(np.float32),
            R[:, cfg.burnin_samples:].astype(np.float32),
            v[None].astype(np.float32), c[None].astype(np.float32), lab)),
        [torch.Generator().manual_seed(2)], chunk_elems=1 << 20)
    # f32 vote sums hold integers exactly only below 2^24; the largest
    # value here collects 4.7e7 votes
    np.testing.assert_allclose(votes.sum(-1)[0].numpy(), c * S, rtol=1e-6)


def test_residue_generators_differ_by_name_and_stage():
    draws = {(n, s): torch.rand(4, generator=batched.residue_generator(
        _CFG, n, s, "cpu")) for n in ("A", "B") for s in (0, 1)}
    vals = [tuple(x.tolist()) for x in draws.values()]
    assert len(set(vals)) == 4
    again = torch.rand(4, generator=batched.residue_generator(_CFG, "A", 0,
                                                              "cpu"))
    assert torch.equal(again, draws[("A", 0)])
