"""Command-line tools of the port, run as ``python -m basicrta_torch.scripts.<name>``."""
