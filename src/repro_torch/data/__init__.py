"""The input pipeline of the port (counterpart of ``repro/data``)."""

from .pipeline import Prefetcher, synth_batch  # noqa: F401
