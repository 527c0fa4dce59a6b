#!/usr/bin/env python3
"""Where the RG-LRU scan kernel's time goes, phase by phase, on one NVIDIA
GPU.

    python3 scripts/rglru_phases.py [--b 1 --s 4096 --w 4096]

Builds ``csrc/rglru_scan.cu`` a second time with ``-DRGLRU_PHASE_CLOCKS``
(``_build.load`` keeps it apart from the plain build under
``build/kernels/``), in which thread 0 (the scan warp) and thread 32 (a
worker) of every CTA sum the clock cycles of each phase of a tile: the
barrier that ends a tile (for the worker, with its wait for the copies of
the next tile), the scan, issuing the copies, storing y, the gates. Runs it
at the given shape (the RecurrentGemma-9B prefill by default, zero state)
and prints the cycles a tile of each phase for each of the two threads
(the mean over CTAs and tiles), the cycles a tile that the tile's bytes
take at 3.35 TB/s shared by the CTAs, and the kernel's time with and
without the clocks (CUDA events). The last line is a JSON object with the
same numbers.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("barrier (worker: and waiting for the next tile's copies)",
          "scan", "issue the copies", "store y", "gates", "last y tile")
PEAK_BYTES = 3.35e12


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--s", type=int, default=4096)
    ap.add_argument("--w", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rglru_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as RK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    lib = RK.bind(_build.load("rglru_scan", ("RGLRU_PHASE_CLOCKS",)))
    lib.rglru_scan_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.rglru_scan_phase_cycles.restype = ctypes.c_int

    b, s, w = args.b, args.s, args.w
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def randn(*shape, shift=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) + shift
        return torch.from_numpy(a).to(dev)

    x = randn(b, s, w)
    ag, ig = torch.sigmoid(randn(b, s, w)), torch.sigmoid(randn(b, s, w))
    lam = randn(w, shift=3.0)
    y, hl = torch.empty_like(x), x.new_empty(b, w)
    geo = RK.launch_geometry(b, s, w, device=dev)

    def launcher(library):
        def run():
            err = library.rglru_scan_fwd(
                x.data_ptr(), ag.data_ptr(), ig.data_ptr(), lam.data_ptr(),
                None, y.data_ptr(), hl.data_ptr(), b, s, w,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"rglru_scan launch failed: CUDA error "
                                   f"{err}")
        return run

    def time_ms(run):
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    plain_ms = time_ms(launcher(RK._lib()))
    per = geo.ctas * geo.n_tiles
    sm_hz = float(smi.split(",")[-1].split()[0]) * 1e6
    bytes_tile = geo.hbm_bytes / per
    resident = min(geo.ctas, geo.n_sms * geo.ctas_per_sm)
    byte_cycles = bytes_tile / (PEAK_BYTES / resident) * sm_hz
    print(f"shape (B,S,W)={(b, s, w)}: {geo.ctas} CTAs x {geo.threads} "
          f"threads, {geo.n_tiles} tiles of {geo.tile} steps, {geo.stages} "
          f"stages; kernel {plain_ms:.4f} ms; a tile's {bytes_tile:.0f} B at "
          f"3.35 TB/s shared by {resident} CTAs: {byte_cycles:.0f} cycles at "
          f"{sm_hz / 1e6:.0f} MHz")
    yp, _ = RK.plain(x, ag, ig, lam)
    sums = (ctypes.c_ulonglong * (2 * len(PHASES)))()
    lib.rglru_scan_phase_cycles(sums)             # zero the counters
    clocked = launcher(lib)
    clocked()
    torch.cuda.synchronize()
    err = lib.rglru_scan_phase_cycles(sums)
    if err:
        raise RuntimeError(f"reading the phase clocks failed: CUDA error "
                           f"{err}")
    max_err = (y - yp).abs().max().item()
    clocked_ms = time_ms(clocked)
    cycles = {who: [sums[i * len(PHASES) + p] / per
                    for p in range(len(PHASES))]
              for i, who in enumerate(("scan warp", "worker"))}
    print(f"with the clocks {clocked_ms:.4f} ms, max abs err {max_err:.3e}")
    for who, vals in cycles.items():
        print(f"  {who}: " + ", ".join(
            f"{name} {v:.0f}" for name, v in zip(PHASES, vals))
            + f"; {sum(vals):.0f} cycles a tile")
    result = {"card": smi, "shape": [b, s, w], "phases": PHASES,
              "byte_cycles_a_tile": byte_cycles, "ms": plain_ms,
              "clocked_ms": clocked_ms, "cycles_a_tile": cycles,
              "max_abs_err": max_err}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
