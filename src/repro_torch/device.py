"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: a missing
card is an error, never a quiet fall back to the CPU. The plain fp32 path
must really be fp32, so TF32 is switched off for matmuls and cuDNN when this
module is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` means the GPU. Raises when a CUDA device is asked for (or
    defaulted to) and none is present; ``"cpu"`` and ``"meta"`` always
    resolve."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
