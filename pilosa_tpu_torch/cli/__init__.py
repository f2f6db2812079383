"""Command line and config: ``python -m pilosa_tpu_torch.cli <command>``."""

from pilosa_tpu_torch.cli.config import Config, load

__all__ = ["Config", "load"]
