"""The optimiser of the port (counterpart of ``repro/optim``)."""

from .adamw import AdamWConfig, apply_updates, global_norm, init_state, schedule  # noqa: F401
