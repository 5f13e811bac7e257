"""``python -m basicrta_torch.contacts``: module entry point of the
``contacts`` subcommand (reference contacts.py:234-252)."""
import sys

from basicrta_torch.cli import main

if __name__ == "__main__":
    main(["contacts"] + sys.argv[1:])
