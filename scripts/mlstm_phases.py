#!/usr/bin/env python3
"""Where the mLSTM kernel's time goes, phase by phase, on one NVIDIA GPU.

    python3 scripts/mlstm_phases.py [--b 8 --h 4 --s 2048 --d 384]

Builds ``csrc/mlstm_scan.cu`` a second time with ``-DMLSTM_PHASE_CLOCKS``
(``_build.load`` keeps it apart from the plain build under
``build/kernels/``), in which thread 0 of every CTA sums the clock cycles
from one barrier to the next for each phase of a chunk.
Runs it at the given shape (the xLSTM-125M prefill by default) with the
column tile that ``mlstm_scan.launch_geometry`` picks, and prints the
cycles a chunk of each phase (the mean over CTAs), the FMAs each phase does
there, and the kernel's time with and without the clocks (CUDA events).
The last line is a JSON object with the same numbers.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("0 v tile, gates, wait for the copies of q and k",
          "1 scores QK^T, q.n", "2 W, denominators, q*inter, k*contrib, n",
          "3 readout [q|W] x [C;V]", "4 readout: summing the 16 K-slices",
          "5 write h, start copying the next q",
          "6 start copying the next k, state update C")


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--h", type=int, default=4)
    ap.add_argument("--s", type=int, default=2048)
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mlstm_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import mlstm_scan as MK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    defines = ("MLSTM_PHASE_CLOCKS",)
    lib = MK.bind(_build.load("mlstm_scan", defines))
    log = _build._target("mlstm_scan", defines).with_suffix(".log")
    spills = [line.strip() for line in log.read_text().splitlines()
              if re.search(r"[1-9]\d* bytes spill", line)]
    print(f"instrumented build: {len(spills)} ptxas line(s) with spills"
          + "".join(f"\n  {line}" for line in spills))
    lib.mlstm_scan_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.mlstm_scan_phase_cycles.restype = ctypes.c_int

    b, h, s, d = args.b, args.h, args.s, args.d
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def randn(*shape, shift=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) + shift
        return torch.from_numpy(a).to(dev)

    q, k, v = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
    ig, fg = randn(b, h, s), randn(b, h, s, shift=2.0)
    geo = MK.launch_geometry(b, h, d)
    got = torch.empty_like(q)

    def clocked():
        err = lib.mlstm_scan_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
            fg.data_ptr(), got.data_ptr(), b, h, s, d, geo.dv,
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
        ms = time_ms(lambda: MK.mlstm_scan(q, k, v, ig, fg))
        want = MK.mlstm_scan(q, k, v, ig, fg)
        sums = (ctypes.c_ulonglong * len(PHASES))()
        lib.mlstm_scan_phase_cycles(sums)          # zero the counters
        clocked()
        torch.cuda.synchronize()
        if lib.mlstm_scan_phase_cycles(sums):
            raise RuntimeError("reading the phase clocks failed")
        if not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
            raise RuntimeError("the instrumented kernel computes otherwise")
        ms_clocked = time_ms(clocked)

    chunks = s // MK.CHUNK
    per_chunk = [c / geo.grid / chunks for c in sums]
    total = sum(per_chunk)
    ell, dv = MK.CHUNK, geo.dv
    fmas = [0, ell * ell * d + ell * d, 0, ell * dv * (d + ell), 0, 0,
            d * dv * ell]
    print(f"shape (B,H,S,D)={(b, h, s, d)}, DV={dv}, {geo.grid} CTAs x "
          f"{geo.threads} threads, {geo.waves} wave(s), {chunks} chunks of "
          f"{ell} rows")
    print(f"kernel {ms:.4f} ms; with the clocks {ms_clocked:.4f} ms; "
          f"{total:.0f} cycles a chunk, so {total * chunks / ms / 1e6:.3f} "
          f"GHz over the kernel's time")
    for name, cyc, f in zip(PHASES, per_chunk, fmas):
        rate = f"{f / cyc:.1f} FMA a cycle" if f else "-"
        print(f"  phase {name}: {cyc:.0f} cycles a chunk "
              f"({100 * cyc / total:.1f}%), {f} FMAs, {rate}")
    print(json.dumps({"shape": [b, h, s, d], "dv": dv, "ms": ms,
                      "ms_clocked": ms_clocked,
                      "cycles_per_chunk": dict(zip(PHASES, per_chunk)),
                      "fmas_per_chunk": dict(zip(PHASES, fmas)),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
