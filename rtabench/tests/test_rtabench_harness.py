"""The harness: discovery by name, the result line, the guard, the file."""

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from rtabench import harness

from rtabench.tests.tiny import run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def _bench():
    return harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def test_benchmark_file_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("rtabench/") and os.path.exists(
            os.path.join(harness.ROOT, c["file"]))
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
        assert NAME.match(w["traffic"]) and w["config"] in names
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(harness.PKG, "traffic",
                                           w["traffic"] + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert os.path.exists(os.path.join(harness.PKG, "metrics",
                                           m["name"] + ".py"))
    for w in cells:
        got = harness.cell_metrics(b, w, False)
        assert "setup_s" in got and len(got) >= 2, w
        layer = harness.cell_metrics(b, w, True)
        assert layer, w
        for m in b["per_layer"]:
            if m["name"] in layer:
                assert m["moves"] in got, (w, m["name"])


def test_result_line_keys_and_names(tmp_path):
    result, checks = run_tiny("w313.tau", tmp_path)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"residue_tau_s", "setup_s"}
    for name, m in result["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
        assert m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(checks) == set(result["checks"])
    json.dumps(result)


def test_traced_line_on_the_cpu_has_the_spans(tmp_path):
    result, _ = run_tiny("w313.tau", tmp_path, trace=True)
    # no device trace on the CPU: only the host spans' metric
    assert set(result["metrics"]) == {"sampling_s.residue"}
    assert "breakdown" not in result


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    pkg = tmp_path / "rtabench"
    shutil.copytree(harness.PKG, pkg,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    bench = _bench()
    with open(pkg / "configs" / "w313.json") as f:
        conf = json.load(f)
    conf["name"] = "w313b"
    (pkg / "configs" / "w313b.json").write_text(json.dumps(conf))
    with open(pkg / "traffic" / "tau.json") as f:
        traffic = json.load(f)
    (pkg / "traffic" / "tau2.json").write_text(json.dumps(traffic))
    (pkg / "metrics" / "jobs_run.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    bench["configs"].append({"name": "w313b", "source": "x",
                             "file": "rtabench/configs/w313b.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "w313b.tau2", "config": "w313b",
                               "traffic": "tau2", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "residue_tau_s":
            m["workloads"].append("w313b.tau2")
    bench["end_to_end"].append({"name": "jobs_run", "unit": "jobs",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["w313b.tau2"]})
    monkeypatch.setattr(harness, "PKG", str(pkg))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    result, _ = run_tiny("w313b.tau2", tmp_path, bench=bench)
    assert set(result["metrics"]) == {"residue_tau_s", "setup_s",
                                      "jobs_run"}
    assert result["metrics"]["jobs_run"]["value"] == result["attempted"]


def test_guard_names_whole_top_level_modules(monkeypatch):
    assert harness.forbidden_modules() == []
    for name in ("jaxtyping", "basicrta_tpu_extra", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "basicrta_tpu.cli",
                        types.ModuleType("basicrta_tpu.cli"))
    assert harness.forbidden_modules() == ["basicrta_tpu", "jax"]


def test_guard_refuses_the_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, **k: ({"correct": True}, {}))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    rc = harness.main(["--workload", "w313.tau", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "jaxlib" in out.err


def test_no_card_no_result():
    env = {k: v for k, v in os.environ.items()}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "-m", "rtabench", "--workload",
                        "w313.tau", "--seed", "1", "--seconds", "1"],
                       cwd=harness.ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_nothing_imports_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|basicrta_tpu|"
                     r"bench)(\s|\.|$)", re.M)
    for dirpath, _, files in os.walk(harness.PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f
    ref = os.path.join(harness.PKG, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            with open(os.path.join(ref, f)) as fh:
                assert "basicrta_torch" not in fh.read(), f


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(harness.PKG, tmp_path / "rtabench",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "rtabench", "--workload",
                        "w313.tau", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, "-m", "rtabench", "--workload",
                        "w313.tau", "--seed", "3", "--seconds", "1",
                        "--trace", "1"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert "segment_roofline" in line["metrics"]
