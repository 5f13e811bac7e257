"""``python -m basicrta_torch.cluster``: module entry point of the
``cluster`` subcommand (reference cluster.py:178-192). The aggregation
lives in :mod:`basicrta_torch.protein.driver`."""
import sys

from basicrta_torch.cli import main

if __name__ == "__main__":
    main(["cluster"] + sys.argv[1:])
