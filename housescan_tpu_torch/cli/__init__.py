"""The command line: ``python -m housescan_tpu_torch.cli``."""

from housescan_tpu_torch.cli.main import main

__all__ = ["main"]
