"""Checkpointing for the port (`checkpoint.manager.CheckpointManager`)."""

from .manager import CheckpointManager  # noqa: F401
