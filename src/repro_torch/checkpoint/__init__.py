"""Checkpoints in the reference's file format (``checkpoint/io.py``)."""
from repro_torch.checkpoint.io import (CorruptCheckpointError, load_checkpoint,
                                       load_fed_checkpoint, save_checkpoint,
                                       save_fed_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint",
           "save_fed_checkpoint", "load_fed_checkpoint",
           "CorruptCheckpointError"]
