"""Step builders of the port (serving now; training comes next)."""

from .step import make_prefill_step, make_serve_step  # noqa: F401
