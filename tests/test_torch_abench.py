"""The port's kernel A/B entry point (``basicrta_torch.scripts.abench``) on
the CPU: its plain-version path runs ``full`` against ``tree_nat`` and
prints one table line per variant; the card is the default, and the JAX
package's variants that the port has no option for are refused."""

import pytest
import torch

from basicrta_torch.scripts import abench
from basicrta_torch.scripts.workload import make_workload


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small eager steps: with torch's intra-op threads, each step
    waits for threads that the suite's other workers keep busy. One
    thread here, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARGS = ["--device", "cpu", "--residues", "2", "--sweeps", "200", "--reps",
        "1", "--flagship-events", "3000", "--ncomp", "4"]


def test_abench_cpu_table(capsys):
    assert abench.main(ARGS + ["--variants", "full,tree_nat"]) == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 3 and "not the card" in lines[0]
    lanes = {f"R{i}#0": t for i, t in make_workload(2, flagship=3000).items()}
    n_buckets = len(abench.layout_batches(lanes, "mixed"))
    for line, name in zip(lines[1:], ("full", "tree_nat")):
        cols = line.split()
        assert cols[0] == name and cols[1] == "mixed"
        assert cols[-2:] == ["not", "measured"]
        per_bucket = [float(x) for x in cols[2:-3]]
        assert len(per_bucket) == n_buckets and min(per_bucket) > 0
        assert float(cols[-3].replace(",", "")) > 0


def test_abench_variants():
    assert abench.parse_variant("tree_nat") == dict(tree=True)
    assert abench.parse_variant("kmax4") == dict(layout="kmax4")
    for name in ("btrd_nat", "abl_empty", "conj_gk", "tree_sl", "kmax1"):
        with pytest.raises(ValueError, match="Not to port"):
            abench.parse_variant(name)


def test_abench_defaults_to_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert abench.main(["--residues", "2"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
