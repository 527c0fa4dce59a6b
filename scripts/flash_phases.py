#!/usr/bin/env python3
"""Where the flash attention kernel's time goes, phase by phase, on one
NVIDIA GPU.

    python3 scripts/flash_phases.py [--h 16 --kv 1 --s 4096 --d 256 \
        --window 2048]

Builds ``csrc/flash_attention.cu`` a second time with
``-DFLASH_PHASE_CLOCKS`` (``_build.load`` keeps it apart from the plain
build under ``build/kernels/``), in which lane 0 of the last warp of every
CTA sums the clock cycles of each phase of a key block: waiting for the
copies of K and V (with the two barriers a block), QK^T, the softmax (P
needs no relayout: the S accumulator is PV's A fragment), and PV. Runs it
causally at the given shape (the RecurrentGemma-9B prefill by default; q,
k, v as (B,S,H,D) projections viewed as (B,H,S,D)) and prints the cycles a
key block of each phase (the mean over the blocks the CTAs walk), the
m16n8k8 TF32 MMAs a CTA issues in each product there (3 for each fp32
product), their rate, and the kernel's time with and without the clocks
(CUDA events). The last line is a JSON object with the same numbers.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("wait for K/V", "QK^T", "softmax", "PV")


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=16)
    ap.add_argument("--kv", type=int, default=1)
    ap.add_argument("--s", type=int, default=4096)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--window", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    defines = ("FLASH_PHASE_CLOCKS",)
    lib = FK.bind(_build.load("flash_attention", defines))
    log = _build._target("flash_attention", defines).with_suffix(".log")
    spills = [line.strip() for line in log.read_text().splitlines()
              if re.search(r"[1-9]\d* bytes spill", line)]
    print(f"instrumented build: {len(spills)} ptxas line(s) with spills"
          + "".join(f"\n  {line}" for line in spills))
    lib.flash_attention_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.flash_attention_phase_cycles.restype = ctypes.c_int

    h, kv, s, d, win = args.h, args.kv, args.s, args.d, args.window
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def randn(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).to(dev)

    q = randn(1, s, h, d).transpose(1, 2)
    k = randn(1, s, kv, d).transpose(1, 2)
    v = randn(1, s, kv, d).transpose(1, 2)
    geo = FK.launch_geometry(1, h, kv, s, s, d, True, win)
    got = torch.empty_like(q)

    def clocked():
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), got.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *got.stride()[:3], 1, h, kv, s, s, d, 1, win, d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"instrumented launch failed: CUDA error {err}")

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    with torch.no_grad():
        ms = time_ms(lambda: FK.flash_attention(q, k, v, causal=True,
                                                window=win))
        want = FK.flash_attention(q, k, v, causal=True, window=win)
        sums = (ctypes.c_ulonglong * (len(PHASES) + 1))()
        lib.flash_attention_phase_cycles(sums)      # zero the counters
        clocked()
        torch.cuda.synchronize()
        if lib.flash_attention_phase_cycles(sums):
            raise RuntimeError("reading the phase clocks failed")
        if not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
            raise RuntimeError("the instrumented kernel computes otherwise")
        ms_clocked = time_ms(clocked)

    blocks = sums[len(PHASES)]
    per_block = [c / blocks for c in list(sums)[:len(PHASES)]]
    total = sum(per_block)
    # a CTA's m16n8k8 MMAs a key block when all 8 warps compute (warps skip
    # blocks past their rows at the diagonal): 3 per fp32 product
    mma = 8 * (d // 8) * 4 * 3
    mmas = [0, mma, 0, mma]
    print(f"shape (B,H,KV,S,D)={(1, h, kv, s, d)}, causal, window {win}: "
          f"{geo.rows} rows a CTA, {geo.ctas} CTAs x {geo.threads} threads, "
          f"{geo.ctas_per_sm} CTA(s) per SM on {geo.n_sms} SMs, {geo.waves} "
          f"wave(s); {blocks} key blocks of {FK.KEY_BLOCK} walked")
    print(f"kernel {ms:.4f} ms; with the clocks {ms_clocked:.4f} ms; "
          f"{total:.0f} cycles a key block, so "
          f"{total * blocks / geo.ctas_per_sm / geo.n_sms / ms / 1e6:.3f} "
          f"GHz over the kernel's time if the SMs were never idle")
    for name, cyc, m in zip(PHASES, per_block, mmas):
        rate = (f", {m / cyc:.3f} MMA a cycle a CTA (an SM's dense TF32 "
                f"peak is 1)" if m else "")
        print(f"  {name}: {cyc:.0f} cycles a key block "
              f"({100 * cyc / total:.1f}%), {m} MMAs{rate}")
    print(json.dumps({"shape": [1, h, kv, s, d], "window": win, "ms": ms,
                      "ms_clocked": ms_clocked, "blocks": blocks,
                      "cycles_per_block": dict(zip(PHASES, per_block)),
                      "mmas_per_block": dict(zip(PHASES, mmas)),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
