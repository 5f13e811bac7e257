"""The benchmark's runner: one cell, one seed, one process.

``python3 -m rtabench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs from the root of a checkout. It finds the cell in
``BENCHMARK.json``, its configuration in ``rtabench/configs/<name>.json``,
its traffic in ``rtabench/traffic/<name>.json`` (whose ``job`` names the
module of ``rtabench/jobs`` that runs it) and each metric in
``rtabench/metrics/<name>.py``, all by name: a cell, a traffic mix or a
metric is added with new files and entries, never an edit.

A run builds its inputs from the seed, warms up on them (set-up), then
runs whole jobs in a closed loop, one in flight, until the first job that
ends at or after ``--seconds`` (the window). It then reads the device's
memory peak, frees the program's state, and judges every job of the window
against the plain reference. The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error and the last key of that object.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types

START = time.perf_counter()
PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "basicrta_tpu")


def _cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(root, ".rtabench", "cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str):
    """(cell entry, configuration, traffic) of the cell ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; cells: "
                         f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(PKG, "traffic",
                                     f"{cell['traffic']}.json"))
    return cell, config, traffic


def cell_metrics(bench: dict, cell: str, trace: bool):
    """Names of the metrics the cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones. A metric without ``workloads`` belongs to
    every cell that reports the end-to-end metric it moves (end-to-end:
    every cell)."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e
                             else [])]


def metric_reader(name: str):
    """``read(run)`` of ``rtabench/metrics/<name>.py``."""
    path = os.path.join(PKG, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "rtabench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Top-level names of loaded modules the benchmark must not see."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def written_bytes():
    """Bytes this process has passed to ``write`` (Linux ``/proc/self/io``
    ``wchar``; files, and a little of the pipes), or None."""
    try:
        with open("/proc/self/io") as f:
            for ln in f:
                if ln.startswith("wchar:"):
                    return int(ln.split()[1])
    except OSError:
        return None
    return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: dict = None, workdir: str = None,
             config_override: dict = None, traffic_override: dict = None):
    """One run of one cell: (result dict, checks) with checks
    {name: (value, limit)}. ``device`` 'cpu' drives the program's plain
    versions (tests only; a measured run is on the card)."""
    import torch

    from rtabench.tracing import DeviceTrace, Spans, idle_gaps

    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic = find_cell(bench, workload)
    config = {**config, **(config_override or {})}
    traffic = {**traffic, **(traffic_override or {})}
    job = importlib.import_module(f"rtabench.jobs.{traffic['job']}")
    on_card = device != "cpu"
    workdir = workdir or os.path.join(ROOT, ".rtabench", "work", workload)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    spans = Spans()
    run = types.SimpleNamespace(
        cell=workload, config=config, traffic=traffic, seed=seed,
        device=device, on_card=on_card, workdir=workdir, spans=spans,
        trace=None, records=[], work={}, peak=None, trace_on=trace)
    try:
        t_start = time.perf_counter()
        state = job.setup(run)
        t_inputs = time.perf_counter()
        job.warm(run, state)
        if trace and on_card:
            DeviceTrace.warm()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        run.setup_s = time.perf_counter() - START
        print(f"set-up {run.setup_s:.3f} s: start and imports "
              f"{t_start - START:.3f}, inputs {t_inputs - t_start:.3f}, "
              f"warm-up {START + run.setup_s - t_inputs:.3f}",
              file=sys.stderr)
        run.written = [written_bytes()]
        if trace and hasattr(job, "instrument"):
            job.instrument(run, state)
        dtrace = DeviceTrace() if trace and on_card else None
        if dtrace:
            dtrace.start()
        t0 = time.perf_counter()
        while True:
            spans.job = len(run.records)
            with spans.span("job"):
                run.records.append(job.run_job(run, state, spans.job))
            if time.perf_counter() - t0 >= seconds:
                break
        run.window_s = time.perf_counter() - t0
        run.written.append(written_bytes())
        if dtrace:
            dtrace.stop()
            run.trace = dtrace
        spans.job = -1
        spans.restore()
        memory = (max(torch.cuda.max_memory_allocated(d)
                      for d in range(torch.cuda.device_count()))
                  if on_card else 0)
        names = cell_metrics(bench, workload, trace)
        if trace and hasattr(job, "account"):
            job.account(run, state)
        metrics = {}
        units = {m["name"]: m["unit"]
                 for m in bench["end_to_end"] + bench["per_layer"]}
        for name in names:
            value = metric_reader(name)(run)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
        breakdown = None
        if run.trace is not None:
            breakdown = {"device_ops": run.trace.top_ops(),
                         "idle_gaps": idle_gaps(run.trace, spans)}
        state.pop("program", None)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        checks, failed = job.check(run, state)
    finally:
        spans.restore()
        shutil.rmtree(workdir, ignore_errors=True)
    checks = {k: (float(v) if math.isfinite(v) else sys.float_info.max, lim)
              for k, (v, lim) in checks.items()}
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    result = {"correct": bool(correct), "attempted": len(run.records),
              "failed": int(failed), "metrics": metrics}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(memory)}
    if run.trace is not None:
        busy, _ = run.trace.busy()
        dev.update(busy_s=busy, window_s=run.trace.window_s)
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    if None not in run.written:
        print(f"written: {run.written[0]} bytes in set-up, "
              f"{run.written[1] - run.written[0]} in the window's "
              f"{len(run.records)} jobs", file=sys.stderr)
    return result, checks


def _card_clock() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m rtabench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_env(ROOT)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if cell is not None and torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), bench=bench)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the benchmark's process: "
              f"{found}", file=sys.stderr)
        return 3
    print(f"card: {_card_clock()}", file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0
