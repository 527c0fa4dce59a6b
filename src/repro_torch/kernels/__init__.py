"""Hand-written Hopper kernels of the port and their plain versions.

``ops`` dispatches by device; ``mlstm_scan``, ``slstm_scan``,
``rglru_scan``, ``flash_attention`` and ``decode_attention`` hold the ctypes
wrappers (with their launch counts) and plain versions; ``ref`` holds the
plain versions; ``mlstm_scan`` and ``slstm_scan`` also hold their backward
kernels' wrappers; ``autograd`` gives the other wrappers their backward, a
recompute through the plain version; ``_build`` compiles ``csrc/*.cu`` at
first use.
"""
