"""Checkpointing of the port's train state (counterpart of
``repro.checkpoint``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
