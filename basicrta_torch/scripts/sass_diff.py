"""Whether two trees' CUDA kernels compile to the same machine code.

Builds ``csrc/<source>`` of this package and the same file of another
checkout's ``basicrta_torch/csrc`` with the port's nvcc flags, disassembles
both with ``cuobjdump -sass`` and compares each kernel's instructions
(addresses and encodings left out), with its registers and stack frame
from ``cuobjdump -res-usage``. A change to a shared header
(``samplers.cuh``) that leaves a kernel's SASS identical cannot move that
kernel's time.

    python -m basicrta_torch.scripts.sass_diff OTHER_CSRC [--source sweep.cu]
        [--base CSRC]

``--base`` compares another tree's sources in place of this one's.
Kernels in an anonymous namespace carry a hash of the source's path in
their names; it is left out, so that two trees' kernels pair up.

Prints one JSON line a kernel (``kernel``, ``instructions`` and ``reg`` /
``stack`` as [this tree, other tree], ``identical``, ``changed``: lines of
the unified diff) and a summary line.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, Tuple

from basicrta_torch.sampler import cuda_sweep as cs

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_USAGE = re.compile(r"Function\s+([^\s:]+):\s*\n\s*REG:(\d+)\s+STACK:(\d+)")
_ANONYMOUS = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def _unhashed(text: str) -> str:
    return _ANONYMOUS.sub("_GLOBAL__N__", text)


def parse_sass(text: str) -> Dict[str, List[str]]:
    """{kernel: its instructions and labels, in order} of a
    ``cuobjdump -sass`` listing."""
    kernels: Dict[str, List[str]] = {}
    body = None
    for line in _unhashed(text).splitlines():
        m = _FUNCTION.match(line)
        if m:
            body = kernels.setdefault(m.group(1), [])
            continue
        if body is None:
            continue
        m = _INSTRUCTION.match(line) or _LABEL.match(line)
        if m:
            body.append(" ".join(m.group(1).split()))
    return kernels


def parse_usage(text: str) -> Dict[str, Tuple[int, int]]:
    """{kernel: (registers, stack bytes)} of ``cuobjdump -res-usage``."""
    return {m.group(1): (int(m.group(2)), int(m.group(3)))
            for m in _USAGE.finditer(_unhashed(text))}


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.path.dirname(cs._nvcc()), "cuobjdump")


def disassemble(source_path: str, workdir: str):
    """(SASS by kernel, usage by kernel) of one build of ``source_path``."""
    out = os.path.join(workdir, "lib.so")
    subprocess.run([cs._nvcc(), *cs._NVCC_FLAGS, "-o", out, source_path],
                   check=True, capture_output=True, text=True)
    tool = _cuobjdump()
    sass = subprocess.run([tool, "-sass", out], check=True,
                          capture_output=True, text=True).stdout
    usage = subprocess.run([tool, "-res-usage", out], check=True,
                           capture_output=True, text=True).stdout
    kernels = parse_sass(sass)
    if not kernels:
        raise RuntimeError("no kernel found in cuobjdump's listing:\n"
                           + "\n".join(sass.splitlines()[:40]))
    return kernels, parse_usage(usage)


def compare(this, other) -> List[dict]:
    """One row a kernel of either build."""
    (sass_a, use_a), (sass_b, use_b) = this, other
    rows = []
    for name in sorted(set(sass_a) | set(sass_b)):
        a, b = sass_a.get(name, []), sass_b.get(name, [])
        diff = [d for d in difflib.unified_diff(a, b, lineterm="", n=0)
                if d[:1] in "+-" and d[:3] not in ("+++", "---")]
        ua, ub = use_a.get(name, (None, None)), use_b.get(name, (None, None))
        rows.append(dict(kernel=name, instructions=[len(a), len(b)],
                         reg=[ua[0], ub[0]], stack=[ua[1], ub[1]],
                         identical=a == b, changed=len(diff)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc", help="another tree's basicrta_torch/csrc")
    ap.add_argument("--source", default="sweep.cu")
    ap.add_argument("--base", default=cs._CSRC,
                    help="the sources to compare (default: this tree's)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as da, \
            tempfile.TemporaryDirectory() as db:
        rows = compare(
            disassemble(os.path.join(args.base, args.source), da),
            disassemble(os.path.join(args.other_csrc, args.source), db))
    for row in rows:
        print(json.dumps(row))
    same = sum(r["identical"] for r in rows)
    print(f"sass_diff {args.source}: {same} of {len(rows)} kernels identical")
    return 0


if __name__ == "__main__":
    sys.exit(main())
