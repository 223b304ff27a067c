"""Command-line entry points, run as ``python -m simclr_tpu_torch.scripts.<name>``."""
