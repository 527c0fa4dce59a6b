"""Async checkpoints of the port (counterpart of ``repro/checkpoint``)."""

from .manager import CheckpointManager  # noqa: F401
