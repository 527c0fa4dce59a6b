"""repro_torch: the PyTorch and CUDA port of ``repro`` for one NVIDIA H100.

It mirrors ``repro``'s module layout (``core``, ``configs``, ``models``,
``kernels``, ``train``) and never imports JAX or ``repro``. Entry points run
on the GPU unless the caller passes ``device="cpu"``; without a card they
raise. See ``device.py``.
"""
