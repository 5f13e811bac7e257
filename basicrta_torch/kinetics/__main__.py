"""``python -m basicrta_torch.kinetics``: module entry point of the
``kinetics`` subcommand (reference kinetics.py:207-222)."""
import sys

from basicrta_torch.cli import main

if __name__ == "__main__":
    main(["kinetics"] + sys.argv[1:])
