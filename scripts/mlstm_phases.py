#!/usr/bin/env python3
"""Where the mLSTM kernel's time goes, phase by phase, on one NVIDIA GPU.

    python3 scripts/mlstm_phases.py [--b 8 --h 4 --s 2048 --d 384]
    python3 scripts/mlstm_phases.py --backward [--s 512]

Builds ``csrc/mlstm_scan.cu`` a second time with ``-DMLSTM_PHASE_CLOCKS``
(``_build.load`` keeps it apart from the plain build under
``build/kernels/``), in which thread 0 of every CTA sums the clock cycles
from one barrier to the next for each phase of a chunk.
Runs it at the given shape (the xLSTM-125M prefill by default) with the
column tile that ``mlstm_scan.launch_geometry`` picks, and prints the
cycles a chunk of each phase (the mean over CTAs), the FMAs each phase does
there, and the kernel's time with and without the clocks (CUDA events).
With ``--backward`` it does the same for the backward kernel on the
training forward's saved states, at the train shape by default (S=512),
and first times the uninstrumented backward at every column tile that
fits (``tile_widths(d, backward=True)``), the one ``launch_geometry``
picks marked.
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
BWD_PHASES = ("0 rows of q, k, v, grad_h; n_c; gate scans",
              "1 G = grad_h / denom", "2 q.k and G.v partials, g",
              "3 W, P", "4 dq and dk planes, dC^T k partials",
              "5 dv, the dC and dn update")


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--h", type=int, default=4)
    ap.add_argument("--s", type=int, default=None,
                    help="2048 (the prefill) or, with --backward, 512")
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--backward", action="store_true",
                    help="the backward kernel at the train shape")
    args = ap.parse_args()
    if args.s is None:
        args.s = 512 if args.backward else 2048
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
    for name in ("mlstm_scan_phase_cycles", "mlstm_scan_bwd_phase_cycles"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int

    b, h, s, d = args.b, args.h, args.s, args.d
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def randn(*shape, shift=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) + shift
        return torch.from_numpy(a).to(dev)

    q, k, v = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
    ig, fg = randn(b, h, s), randn(b, h, s, shift=2.0)
    if args.backward:
        return backward_phases(args, lib, MK, (q, k, v, ig, fg),
                               randn(b, h, s, d))
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
        return _time_ms(fn, args.iters)

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


def _time_ms(fn, iters: int) -> float:
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


def backward_phases(args, lib, MK, inputs, grad_h) -> int:
    """``--backward``: the backward kernel's time at each tile that fits,
    then its cycles a chunk by phase at the tile ``launch_geometry``
    picks."""
    import torch
    b, h, s, d = args.b, args.h, args.s, args.d
    with torch.no_grad():
        out, states = MK._launch_train(*inputs)
    geo = MK.launch_geometry(b, h, d, backward=True)

    def launcher(library, dv):
        planes = [torch.empty(d // dv, b, h, s, d, device=out.device)
                  for _ in range(2)]
        dv_out = torch.empty_like(out)
        ptrs = [x.data_ptr() for x in (*inputs, out, grad_h, *states,
                                       *planes, dv_out)]

        def call():
            err = library.mlstm_scan_bwd(
                *ptrs, b, h, s, d, dv, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"backward launch failed: CUDA error {err}")
        return call, (*planes, dv_out)

    tiles = {}
    for dv in MK.tile_widths(d, backward=True):
        tiles[dv] = _time_ms(launcher(MK._lib(), dv)[0], args.iters)
    plain, want = launcher(MK._lib(), geo.dv)
    clocked, got = launcher(lib, geo.dv)
    sums = (ctypes.c_ulonglong * len(BWD_PHASES))()
    with torch.no_grad():
        plain()
        lib.mlstm_scan_bwd_phase_cycles(sums)      # zero the counters
        clocked()
        torch.cuda.synchronize()
        if lib.mlstm_scan_bwd_phase_cycles(sums):
            raise RuntimeError("reading the phase clocks failed")
        if not all(torch.allclose(g, w, rtol=1e-6, atol=1e-6)
                   for g, w in zip(got, want)):
            raise RuntimeError("the instrumented kernel computes otherwise")
        ms_clocked = _time_ms(clocked, args.iters)
    chunks = s // MK.CHUNK
    per_chunk = [c / geo.grid / chunks for c in sums]
    total = sum(per_chunk)
    ell, dv = MK.CHUNK, geo.dv
    fmas = [0, 0, 2 * ell * ell * d + ell * d, 0,
            3 * ell * d * dv + 2 * ell * ell * dv,
            ell * ell * dv + d * dv * ell + d * ell]
    print(f"backward, shape (B,H,S,D)={(b, h, s, d)}: " + ", ".join(
        f"DV={t} {ms:.4f} ms" + (" (picked)" if t == dv else "")
        for t, ms in tiles.items()))
    print(f"DV={dv}, {geo.grid} CTAs x {geo.threads} threads, {geo.waves} "
          f"wave(s), {chunks} chunks of {ell} rows; with the clocks "
          f"{ms_clocked:.4f} ms; {total:.0f} cycles a chunk, so "
          f"{total * chunks * geo.waves / tiles[dv] / 1e6:.3f} GHz over "
          f"the kernel's time")
    for name, cyc, f in zip(BWD_PHASES, per_chunk, fmas):
        rate = f"{f / cyc:.1f} FMA a cycle" if f else "-"
        print(f"  phase {name}: {cyc:.0f} cycles a chunk "
              f"({100 * cyc / total:.1f}%), {f} FMAs, {rate}")
    print(json.dumps({"shape": [b, h, s, d], "dv": dv, "ms_by_dv": tiles,
                      "ms_clocked": ms_clocked,
                      "cycles_per_chunk": dict(zip(BWD_PHASES, per_chunk)),
                      "fmas_per_chunk": dict(zip(BWD_PHASES, fmas)),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
