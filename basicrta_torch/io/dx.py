"""OpenDX grid export/import (replaces the gridData dependency).

Port of ``basicrta_tpu.io.dx``: the density pipeline exports OpenDX files
for VMD/PyMOL/Chimera (reference wdensity.py:361-627). Format per the
OpenDX "native files" specification: regular gridpositions/gridconnections
plus a rank-0 data array, three values per line. The writer keeps the JAX
package's header comment, so a grid written by either package is the same
bytes.
"""

from __future__ import annotations

import numpy as np


def write_dx(path: str, grid: np.ndarray, origin, delta,
             name: str = "density") -> str:
    """Write a 3D scalar grid.

    Args:
        grid: (nx, ny, nz) values.
        origin: (3,) coordinates of the first grid point [Angstrom].
        delta: scalar or (3,) grid spacing [Angstrom].
    """
    grid = np.asarray(grid)
    nx, ny, nz = grid.shape
    origin = np.asarray(origin, float)
    delta = np.broadcast_to(np.asarray(delta, float), (3,))
    with open(path, "w") as f:
        f.write("# OpenDX density written by basicrta_tpu\n")
        f.write(f"object 1 class gridpositions counts {nx} {ny} {nz}\n")
        f.write(f"origin {origin[0]:g} {origin[1]:g} {origin[2]:g}\n")
        f.write(f"delta {delta[0]:g} 0 0\n")
        f.write(f"delta 0 {delta[1]:g} 0\n")
        f.write(f"delta 0 0 {delta[2]:g}\n")
        f.write(f"object 2 class gridconnections counts {nx} {ny} {nz}\n")
        f.write(f"object 3 class array type double rank 0 items "
                f"{grid.size} data follows\n")
        flat = grid.ravel(order="C")
        for i in range(0, len(flat), 3):
            f.write(" ".join(f"{v:.10g}" for v in flat[i:i + 3]) + "\n")
        f.write('attribute "dep" string "positions"\n')
        f.write(f'object "{name}" class field\n')
        f.write('component "positions" value 1\n')
        f.write('component "connections" value 2\n')
        f.write('component "data" value 3\n')
    return path


def read_dx(path: str):
    """Read a 3D OpenDX scalar grid; returns (grid, origin, delta)."""
    counts = origin = None
    deltas = []
    values = []
    nitems = None
    with open(path) as f:
        for ln in f:
            s = ln.strip()
            if s.startswith("#") or not s:
                continue
            if s.startswith("object 1"):
                counts = [int(v) for v in s.split()[-3:]]
            elif s.startswith("origin"):
                origin = [float(v) for v in s.split()[1:4]]
            elif s.startswith("delta"):
                deltas.append([float(v) for v in s.split()[1:4]])
            elif "data follows" in s:
                nitems = int(s.split()[-3])
            elif nitems is not None and len(values) < nitems:
                try:
                    values.extend(float(v) for v in s.split())
                except ValueError:
                    pass
    grid = np.asarray(values[:nitems]).reshape(counts)
    delta = np.asarray([deltas[i][i] for i in range(3)])
    return grid, np.asarray(origin), delta
