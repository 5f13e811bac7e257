"""Empty GMM clusters in the port's post-processing against the JAX
package's: the seven cases of ``tests/test_postprocess_edges.py``, each run
through ``basicrta_torch.postprocess`` and ``basicrta_tpu.postprocess`` on
the same ``ClusterResult`` (that file's ``_result_with_empty_cluster``,
seeded with numpy).

Host numpy code in both packages, so the outputs are equal bit for bit:
the parameter rows (the empty cluster's NaN row included) and their
intervals, τ and its interval, the presorts, labels and permuted
membership, and the ``estimate_tau_all`` rows. Each case also keeps the
JAX test's own assertions on the port's output."""

import dataclasses

import numpy as np
import pytest

import test_postprocess_edges as je   # the JAX package's edge cases

from basicrta_tpu.postprocess import clustering as jc
from basicrta_tpu.postprocess import tau as jtau

from basicrta_torch.postprocess import clustering as tc
from basicrta_torch.postprocess import tau as ttau


def _pair(make=je._result_with_empty_cluster):
    """The JAX fixture's result, and its copy as the port's type."""
    theirs = make()
    mine = tc.ClusterResult(**{f.name: getattr(theirs, f.name)
                               for f in dataclasses.fields(theirs)})
    return mine, theirs


def _full_clusters():
    """The populated case of the JAX file's
    ``test_sort_labels_unchanged_for_full_clusters``."""
    rng = np.random.default_rng(3)
    labels = np.array([0] * 10 + [1] * 10 + [2] * 10, np.int32)
    rates = np.concatenate([rng.uniform(0.01, 0.02, 10),
                            rng.uniform(5.0, 8.0, 10),
                            rng.uniform(0.5, 0.7, 10)])
    data = np.stack([np.full(30, 0.3), rates], axis=1)
    pind = np.zeros((6, 3))
    pind[:2, 0] = 0.9
    pind[2:4, 1] = 0.9
    pind[4:, 2] = 0.2   # cluster 2 is noise
    return jc.ClusterResult(lmode=3, labels=labels,
                            inds=(np.arange(30), np.zeros(30, np.int64)),
                            data=data, pindicator_values=pind)


def _all_noise(res):
    res.pindicator_values = res.pindicator_values * 0.1   # all below 0.4
    return res


def test_estimate_params_nan_rows():
    mine, theirs = _pair()
    p, ci = ttau.estimate_params(mine)
    q, cj = jtau.estimate_params(theirs)
    np.testing.assert_array_equal(p, q)      # NaN == NaN in place
    np.testing.assert_array_equal(ci, cj)
    assert p.shape == (3, 2) and np.isnan(p[1]).all()
    assert np.isfinite(p[[0, 2]]).all()


def test_estimate_tau_skips_nan_cluster():
    mine, theirs = _pair()
    got = ttau.estimate_tau(mine, noise_cutoff=0.4)
    assert got == jtau.estimate_tau(theirs, noise_cutoff=0.4)
    lo, tau, hi = got
    assert 1.0 / 0.02 <= tau <= 1.0 / 0.01
    assert lo <= tau <= hi and np.isfinite(got).all()


@pytest.mark.parametrize("fn", ["estimate_tau", "estimate_tau_all"])
def test_all_noise_raises(fn):
    mine, theirs = (_all_noise(r) for r in _pair())
    msgs = []
    for mod, res in ((ttau, mine), (jtau, theirs)):
        with pytest.raises(mod.AllNoiseError) as e:
            getattr(mod, fn)(res, noise_cutoff=0.4)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert issubclass(ttau.AllNoiseError, RuntimeError)


def _sorted_equal(a, b):
    for f in ("presorts", "labels", "pindicator_values", "data"):
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_array_equal(x, y, err_msg=f)
        assert x.dtype == y.dtype, f


def test_sort_labels_treats_empty_as_noise():
    mine, theirs = _pair()
    a = tc.sort_labels_by_rate(mine, noise_cutoff=0.4)
    _sorted_equal(a, jc.sort_labels_by_rate(theirs, noise_cutoff=0.4))
    assert a.presorts.tolist() == [0, 2, 1]
    assert set(np.unique(a.labels)) == {0, 1}
    rates = a.data[:, 1]
    assert rates[a.labels == 0].mean() > rates[a.labels == 1].mean()
    assert a.pindicator_values[:, 2].max() == pytest.approx(0.05)


def test_sort_labels_unchanged_for_full_clusters():
    mine, theirs = _pair(_full_clusters)
    a = tc.sort_labels_by_rate(mine, noise_cutoff=0.4)
    _sorted_equal(a, jc.sort_labels_by_rate(theirs, noise_cutoff=0.4))
    assert a.presorts.tolist() == [1, 0, 2]


def test_tau_all_rows_and_order():
    mine, theirs = _pair()
    table = ttau.estimate_tau_all(mine, noise_cutoff=0.4)
    want = jtau.estimate_tau_all(theirs, noise_cutoff=0.4)
    np.testing.assert_array_equal(table, want)
    assert table.dtype == want.dtype and table.shape == (2, 4)
    assert list(table[:, 0]) == [2.0, 0.0]
    assert 1.0 / 0.02 <= table[0, 2] <= 1.0 / 0.01
    assert 1.0 / 8.0 <= table[1, 2] <= 1.0 / 5.0
    for _, lo, tau, hi in table:
        assert lo <= tau <= hi
    assert table[0, 1:].tolist() == list(
        ttau.estimate_tau(mine, noise_cutoff=0.4))


def test_sorted_result_gives_equal_tau():
    """The order ``process_gibbs`` runs them in: sort, then τ of every
    cluster, on the sorted result (the empty cluster last as noise)."""
    mine, theirs = _pair()
    a = tc.sort_labels_by_rate(mine, noise_cutoff=0.4)
    b = jc.sort_labels_by_rate(theirs, noise_cutoff=0.4)
    np.testing.assert_array_equal(ttau.estimate_tau_all(a, 0.4),
                                  jtau.estimate_tau_all(b, 0.4))
    assert ttau.estimate_tau(a, 0.4) == jtau.estimate_tau(b, 0.4)
