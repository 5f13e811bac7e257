"""basicrta_torch.entry, the counterpart of the JAX package's
``__graft_entry__.py``: ``entry(device="cpu")`` runs one thinned block
pair of the collapsed engine's batched segment, ``dryrun_multichip`` runs
its six legs over 2 and 4 devices on the CPU, ``dryrun_multihost`` joins
two gloo processes on localhost, and the entry points raise without a
card unless asked for the CPU."""

import numpy as np
import pytest
import torch

from basicrta_torch import entry


def test_entry_on_the_cpu():
    fn, args = entry.entry(device="cpu")
    gen, state, values, counts = args
    assert values.shape == counts.shape == (8, 256)
    assert state.weights.shape == (8, 15)
    st, W, R = fn(*args)
    assert W.shape == R.shape == (8, 2, 15)
    assert torch.isfinite(W).all() and torch.isfinite(R).all()
    np.testing.assert_allclose(st.weights.sum(-1).numpy(), 1.0, atol=1e-5)
    # the same example arguments draw the same block again
    fn2, args2 = entry.entry(device="cpu")
    _, W2, _ = fn2(*args2)
    assert torch.equal(W, W2)


def test_entry_example_batch_equals_jax():
    """The example lanes are the JAX entry's: the same seeded values and
    counts, sorted into the same tiers."""
    import importlib.util
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "_graft_entry", os.path.join(repo, "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    for seed in (0, 1):
        for a, b in zip(entry._example_batch(8, 256, 15, seed),
                        graft._example_batch(8, 256, 15, seed)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_the_cpu(n):
    lines = []
    entry.dryrun_multichip(n, device="cpu", out=lines.append)
    assert [line.split(" OK")[0] for line in lines] == [
        "dryrun_multichip", "dryrun_multichip fused",
        "dryrun_multichip packed", "dryrun_multichip mixed",
        "dryrun_multichip postprocess", "dryrun_multichip contacts",
        "dryrun_multichip density"]
    assert f"over {n} devices" in lines[-1]


def test_dryrun_multihost_two_gloo_processes():
    lines = []
    entry.dryrun_multihost(device="cpu", out=lines.append)
    assert lines == ["dryrun_multihost OK: 2 hosts partitioned 5 residues "
                     "into a shared results tree"]


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA device"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        entry.dryrun_multihost()
