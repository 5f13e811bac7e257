"""``basicrta_torch.datafiles``: the same example datasets as the JAX
package's, bit for bit."""

import numpy as np
import pytest

from basicrta_torch import datafiles as td
from basicrta_tpu import datafiles as jd


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_times_equal_jax(seed):
    np.testing.assert_array_equal(td.synthetic_times(seed=seed),
                                  jd.synthetic_times(seed=seed))


def test_small_datasets_and_the_real_file(tmp_path, monkeypatch):
    np.testing.assert_array_equal(td.synthetic_times(5000, ts=0.25, seed=3),
                                  jd.synthetic_times(5000, ts=0.25, seed=3))
    np.testing.assert_array_equal(td.times, jd.times)
    with pytest.raises(AttributeError):
        td.no_such_dataset
    monkeypatch.delenv("BASICRTA_TIMES_NPY", raising=False)
    np.testing.assert_array_equal(td.load_times(prefer_real=False, n=2000),
                                  jd.synthetic_times(2000))
    path = tmp_path / "times.npy"
    np.save(path, np.arange(1.0, 6.0))
    monkeypatch.setenv("BASICRTA_TIMES_NPY", str(path))
    assert td.real_times_path() == str(path)
    np.testing.assert_array_equal(td.load_times(), np.arange(1.0, 6.0))
