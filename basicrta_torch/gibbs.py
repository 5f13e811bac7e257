"""``python -m basicrta_torch.gibbs``: module entry point of the ``gibbs``
subcommand (reference gibbs.py:781-795). The sampler itself lives in
:mod:`basicrta_torch.sampler.gibbs`."""
import sys

from basicrta_torch.cli import main

if __name__ == "__main__":
    main(["gibbs"] + sys.argv[1:])
