#!/usr/bin/env python3
"""Times the decode attention kernel on one NVIDIA GPU at the
RecurrentGemma-9B decode shape, beside an older build of it.

    python3 scripts/decode_bench.py [--parent PATH] [--out PATH]

Builds this tree's ``csrc/decode_attention.cu``; with ``--parent``, also
another copy of that source (say, the parent commit's, from a ``git
archive``), compiled with the same flags into ``build/kernels/`` and called
through the same C entry point (``decode_attention.call``). The shape is
B=4, H=16, KV=1, D=256, S=2048 with lengths (1, 700, 2048, 2048), fp32 and
bf16 caches. Every build is first held against the plain version (2e-5
fp32, 2e-2 bf16), then timed in turns (the parent, this tree, this tree,
the parent, twice) by CUDA-graph replay:
  warm: one cache, which stays in L2;
  cold: 12 caches in turn (201 MB in fp32), as a decode step's 12
        attention layers find theirs, divided by 12.
For this tree it also prints the launch geometry, the bound, the device
time of the split and the combine launch apart (``torch.profiler`` over
the cold calls, launched one by one), and the warm and cold times at other
lengths. The last line is a JSON object with every number, also written to
``--out`` if given.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, KV, S, D = 4, 16, 1, 2048, 256
LENGTHS = (1, 700, 2048, 2048)
OTHER_LENGTHS = ((2048,) * 4, (700,) * 4, (1,) * 4)
N_LAYERS = 12
ROUNDS = 2
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another copy of decode_attention.cu")
    ap.add_argument("--out", help="a file for the JSON result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_bench: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import bound, graph_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    builds = {"this": DK._lib()}
    if args.parent:
        builds["parent"] = DK.declare(_build.load_copy(args.parent, "parent"))
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, H, D, generator=gen, device=dev)
    caches = [tuple(torch.randn(B, S, KV, D, generator=gen, device=dev)
                    for _ in range(2)) for _ in range(N_LAYERS)]

    def times(lib, layers, lengths):
        """(warm, cold) ms a call by graph replay."""
        k, v = layers[0]

        def cold():
            for kk, vv in layers:
                DK.call(q, kk, vv, lengths, lib)
        return (graph_ms(lambda: DK.call(q, k, v, lengths, lib), 100),
                graph_ms(cold, 10) / N_LAYERS)

    result = {"card": smi, "builds": list(builds), "lengths": LENGTHS}
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    for dtype in ("float32", "bfloat16"):
        layers = [(a.to(getattr(torch, dtype)), b.to(getattr(torch, dtype)))
                  for a, b in caches]
        want = DK.plain(q, *layers[0], lengths)
        errs = {}
        for tag, lib in builds.items():
            errs[tag] = (DK.call(q, *layers[0], lengths, lib)
                         - want).abs().max().item()
            print(f"{dtype} cache, {tag}: max abs err {errs[tag]:.3e}")
            if not errs[tag] <= TOL[dtype]:
                print(f"decode_bench: {tag} is off by {errs[tag]}",
                      file=sys.stderr)
                return 1
        geo = DK.launch_geometry(B, H, KV, S, D, getattr(torch, dtype),
                                 LENGTHS)
        b_ms, b_by = bound(4.0 * sum(geo.valid(i) for i in range(B)) * KV
                           * geo.g * D, geo.hbm_bytes)
        print(f"  geometry: {geo.ctas} split CTAs ({geo.ctas_with_work} "
              f"with work), {geo.ctas_per_sm} a SM, {geo.smem_bytes} B "
              f"shared a CTA, {geo.hbm_bytes} HBM bytes; bound {b_ms:.4f} "
              f"ms ({b_by})")
        runs = {tag: [] for tag in builds}
        for _ in range(ROUNDS):
            for tag in order:
                runs[tag].append(times(builds[tag], layers, lengths))
        for tag, tt in runs.items():
            print(f"  {tag}: ms a call by graph replay, warm "
                  f"{[round(w, 4) for w, _ in tt]}, cold "
                  f"{[round(c, 4) for _, c in tt]}")
        # the split and the combine launch apart, on the device's clock
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                for kk, vv in layers:
                    DK.call(q, kk, vv, lengths, builds["this"])
            torch.cuda.synchronize()
        split = {part: sum(_device_us(e) for e in prof.key_averages()
                           if f"decode_{part}_kernel" in e.key)
                 / (5 * N_LAYERS) / 1e3 for part in ("split", "combine")}
        print(f"  this, cold, device ms a call: split "
              f"{split['split']:.4f}, combine {split['combine']:.4f}")
        result[dtype] = {"max_abs_err": errs, "bound_ms": b_ms,
                         "bound_by": b_by, "hbm_bytes": geo.hbm_bytes,
                         "times": runs, "device_ms": split}
    other = {}
    for lens in OTHER_LENGTHS:
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        other[str(lens)] = times(builds["this"], caches, ln)
        print(f"float32 cache, this, lengths {lens}: warm "
              f"{other[str(lens)][0]:.4f} ms, cold {other[str(lens)][1]:.4f}"
              f" ms")
    result["other_lengths"] = other
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
