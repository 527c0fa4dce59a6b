#!/usr/bin/env python3
"""Times the RG-LRU scan kernel on one NVIDIA GPU, beside an older build of
it and beside the card's streaming rate for the same bytes.

    python3 scripts/rglru_bench.py [--parent PATH] [--rounds 2]
        [--out PATH]

Builds this tree's ``csrc/rglru_scan.cu``; with ``--parent``, also another
copy of that source (say, the parent commit's, from a ``git archive``),
compiled with the same flags into ``build/kernels/`` and called through the
same C interface. Every build is first held against the plain version
(rtol = atol = 3e-5) at the RecurrentGemma-9B shapes, then timed there in
turns (the parent, this tree, this tree, the parent, ``--rounds`` times),
by CUDA events over back-to-back launches and by replaying a CUDA graph of
them:
  prefill: B=1, S=4096, W=4096, zero state and h0;
  decode step: B=4, S=1, W=4096, h0.
Prints the card's name and power limit, this tree's launch geometry, the
byte bound (each byte once, 3.35 TB/s), the byte yardstick
``torch.addcmul(x, a_gate, i_gate, out=y)`` (it reads the same three
arrays and writes one: the card's practical streaming rate for these
bytes, not the function) and each build's achieved TB/s. The last line
is a JSON object with every number, also written to ``--out`` if given.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"prefill": (1, 4096, 4096, False), "prefill_h0": (1, 4096, 4096,
                                                             True),
          "decode": (4, 1, 4096, True)}
ITERS = {"prefill": 20, "prefill_h0": 20, "decode": 200}
TOL = 3e-5
PEAK_BYTES = 3.35e12


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another copy of rglru_scan.cu")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="a file for the JSON result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rglru_bench: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import cuda_ms, graph_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as RK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)

    builds = {"this": RK._lib()}
    if args.parent:                 # built with the same flags, bound raw
        lib = _build.load_copy(args.parent, "parent")
        lib.rglru_scan_fwd.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.rglru_scan_fwd.restype = ctypes.c_int
        builds["parent"] = lib

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def randn(*shape, shift=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) + shift
        return torch.from_numpy(a).to(dev)

    data = {}
    for name, (b, s, w, with_h0) in SHAPES.items():
        x = randn(b, s, w)
        ag, ig = torch.sigmoid(randn(b, s, w)), torch.sigmoid(randn(b, s, w))
        lam = randn(w, shift=3.0)
        h0 = randn(b, w) if with_h0 else None
        data[name] = (x, ag, ig, lam, h0, torch.empty_like(x),
                      x.new_empty(b, w))

    def runner(lib, name):
        x, ag, ig, lam, h0, y, hl = data[name]
        b, s, w = x.shape
        ptrs = [t.data_ptr() for t in (x, ag, ig, lam)] + [
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            hl.data_ptr()]

        def run():
            err = lib.rglru_scan_fwd(
                *ptrs, b, s, w, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"rglru_scan launch failed: CUDA error "
                                   f"{err}")
        return run

    result = {"card": smi, "builds": list(builds), "shapes": {}}
    for name, (b, s, w, with_h0) in SHAPES.items():
        x, ag, ig, lam, h0, y, hl = data[name]
        yp, hp = RK.plain(x, ag, ig, lam, h0)
        errs = {}
        for tag, lib in builds.items():
            y.zero_()
            runner(lib, name)()
            torch.cuda.synchronize()
            err = (y - yp).abs()
            ok = bool((err <= TOL + TOL * yp.abs()).all()) and bool(
                ((hl - hp).abs() <= TOL + TOL * hp.abs()).all())
            errs[tag] = err.max().item()
            print(f"{name} {(b, s, w)}{' h0' if with_h0 else ''} {tag}: "
                  f"max abs err {errs[tag]:.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                return 1
        geo = RK.launch_geometry(b, s, w, with_h0=with_h0, device=dev)
        print(f"  geometry: stripe {geo.stripe}, tile {geo.tile}, "
              f"{geo.stages} stages, {geo.threads} threads, {geo.ctas} "
              f"CTAs, {geo.ctas_per_sm} CTA(s)/SM on {geo.n_sms} SMs, "
              f"{geo.waves} wave(s), {geo.smem_bytes} B shared a CTA, "
              f"{geo.in_flight_per_sm} B in flight a SM, {geo.hbm_bytes} "
              f"HBM bytes")
        bound = geo.hbm_bytes / PEAK_BYTES * 1e3
        order = ["parent", "this", "this", "parent"] if "parent" in builds \
            else ["this", "this"]
        times = {tag: {"ms": [], "graph_ms": []} for tag in builds}
        for _ in range(args.rounds):
            for tag in order:
                run = runner(builds[tag], name)
                times[tag]["ms"].append(cuda_ms(run, ITERS[name]))
                times[tag]["graph_ms"].append(graph_ms(run, ITERS[name]))
        out = torch.empty_like(x)
        stream = {"ms": cuda_ms(lambda: torch.addcmul(x, ag, ig, out=out),
                                ITERS[name]),
                  "graph_ms": graph_ms(
                      lambda: torch.addcmul(x, ag, ig, out=out),
                      ITERS[name])}
        stream_bytes = 16 * x.numel()
        print(f"  bound {bound:.4f} ms; stream (addcmul) event "
              f"{stream['ms']:.4f} ms, graph {stream['graph_ms']:.4f} ms, "
              f"{stream_bytes / stream['graph_ms'] / 1e9:.3f} TB/s")
        for tag, tt in times.items():
            best = min(tt["graph_ms"])
            print(f"  {tag}: event ms {[round(v, 4) for v in tt['ms']]}, "
                  f"graph ms {[round(v, 4) for v in tt['graph_ms']]}, "
                  f"{geo.hbm_bytes / best / 1e9:.3f} TB/s at the best "
                  f"graph time, {bound / best:.3f} of the bound")
        result["shapes"][name] = {
            "b": b, "s": s, "w": w, "h0": with_h0, "max_abs_err": errs,
            "hbm_bytes": geo.hbm_bytes, "bound_ms": bound,
            "stream": stream, "times": times,
            "geometry": {"tile": geo.tile, "stages": geo.stages,
                         "threads": geo.threads, "ctas": geo.ctas,
                         "ctas_per_sm": geo.ctas_per_sm, "waves": geo.waves,
                         "smem_bytes": geo.smem_bytes,
                         "in_flight_per_sm": geo.in_flight_per_sm}}
        del out
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
