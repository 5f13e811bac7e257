"""MD file I/O: topologies, trajectories, and density grids.

No MDAnalysis dependency: GRO/PDB/PSF/PRMTOP topologies and ``gmx dump``
renderings of TPR files parse in Python, XTC/TRR/DCD trajectories go
through the native C++ library (``native/mdio.cpp``, built with g++ at
first use), Amber NetCDF/mdcrd trajectories through scipy/pure-Python
readers, and OpenDX densities have a pure-Python writer. Host code
throughout: numpy and scipy only.
"""

from basicrta_torch.io.amber import (InpcrdReader, MDCRDReader, NCDFReader,
                                     read_prmtop)
from basicrta_torch.io.dx import read_dx, write_dx
from basicrta_torch.io.native import (XTCReader, XTCWriter, TRRReader,
                                      TRRWriter, DCDReader, DCDWriter,
                                      trajectory_writer)
from basicrta_torch.io.topology import (PDBModelReader, Topology, read_gro,
                                        read_pdb, read_psf, write_pdb)
from basicrta_torch.io.universe import Universe

__all__ = [
    "XTCReader", "XTCWriter", "TRRReader", "TRRWriter",
    "DCDReader", "DCDWriter", "trajectory_writer",
    "NCDFReader", "MDCRDReader",
    "PDBModelReader", "InpcrdReader",
    "Topology", "read_gro", "read_pdb", "read_psf", "read_prmtop",
    "write_pdb", "Universe", "read_dx", "write_dx",
]
