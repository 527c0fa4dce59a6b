"""What the flash attention scripts share (``flash_phases.py``,
``flash_knobs.py``): the card's name and power limit, the inputs, a build's
forward called through its C interface, CUDA-event timing, ptxas's lines
for one kernel instance, and the MMAs a key block of each route issues.
Imported by those scripts, which run it from this directory; needs a card.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: the routes a flash instance has taken, by the name scripts pass
ROUTES = {
    "3xtf32": "3xTF32, m16n8k8",
    "tf32": "TF32 on bf16 operands, m16n8k8",
    "bf16": "bf16, m16n8k16, P in two parts",
}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def inputs(h: int, kv: int, s: int, d: int, dtype, seed: int = 0,
           b: int = 1):
    """q (B, H, S, D) and k, v (B, KV, S, D) of ``dtype`` on the card,
    drawn from ``seed`` as (B,S,H,D) projections viewed as (B,H,S,D)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def randn(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).to("cuda").to(dtype)

    return (randn(b, s, h, d).transpose(1, 2),
            randn(b, s, kv, d).transpose(1, 2),
            randn(b, s, kv, d).transpose(1, 2))


def caller(lib: ctypes.CDLL, q, k, v, out, *, causal: bool = True,
           window: "int | None" = None):
    """A call of ``lib``'s forward for q's type (any build of
    ``flash_attention.cu``) on q, k and v into ``out``."""
    import torch
    fwd = lib.flash_attention_fwd_bf16 if q.dtype == torch.bfloat16 \
        else lib.flash_attention_fwd
    fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                    + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    b, h, s, d = q.shape
    kv = k.shape[1]

    def call():
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], b, h, kv, s, s, d, int(causal),
                  window or 0, d ** -0.5,
                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def max_active(lib: ctypes.CDLL, d: int, el: int) -> int:
    """Resident CTAs a SM of ``lib``'s instance at head dim d."""
    lib.flash_attention_max_active.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_max_active.restype = ctypes.c_int
    return lib.flash_attention_max_active(d, el)


def time_ms(fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after one, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_lines(log: str, kernel: str, d: int) -> list:
    """ptxas's register and spill lines for ``kernel<d>`` (its mangled name
    holds d as ILi<d>E) in an nvcc log."""
    out, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = kernel in line and f"ILi{d}E" in line
        elif on and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def mmas_per_block(route: str, d: int, keys: int = 32) -> "tuple[int, int]":
    """(QK^T, PV) MMAs a CTA issues on a key block when all 8 warps compute
    (warps skip blocks past their rows at the diagonal), by route: 3xtf32
    (m16n8k8, 3 for each fp32 product), tf32 (m16n8k8 on bf16 operands, 1
    for QK^T and 2 for PV) or bf16 (m16n8k16, 1 for QK^T and 2 for PV, P's
    two parts)."""
    if route == "3xtf32":
        per = 8 * (d // 8) * (keys // 8) * 3
        return per, per
    if route == "tf32":
        return 8 * (d // 8) * (keys // 8), 8 * (keys // 8) * (d // 8) * 2
    if route == "bf16":
        return 8 * (d // 16) * (keys // 8), 8 * (keys // 16) * (d // 8) * 2
    raise ValueError(f"no route {route!r}; one of {sorted(ROUTES)}")
