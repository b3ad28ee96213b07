"""Checkpointing of the port (see ``repro_torch.checkpoint.ckpt``)."""

from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
