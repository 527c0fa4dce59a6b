"""Hand-written Hopper kernels of the port and their plain versions.

``ops`` dispatches by device; ``mlstm_scan``, ``slstm_scan``,
``rglru_scan``, ``flash_attention`` and ``decode_attention`` hold the ctypes
wrappers (with their launch counts) and plain versions; ``ref`` holds the
plain versions; ``autograd`` gives each wrapper its backward, a recompute
through the plain version; ``_build`` compiles ``csrc/*.cu`` at first use.
"""
