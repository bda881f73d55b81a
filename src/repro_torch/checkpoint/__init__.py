"""Checkpointing of the port (atomic, async, keep-N)."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager, latest_step, restore, save,
)
