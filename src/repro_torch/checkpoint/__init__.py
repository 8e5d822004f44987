"""Fault-tolerant checkpoints of parameter trees."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    list_checkpoints, restore_latest, save_checkpoint,
)
