#!/usr/bin/env python3
"""Where the flash attention kernel's time goes, phase by phase, on one
NVIDIA GPU.

    python3 scripts/flash_phases.py [--b 1 --h 16 --kv 1 --s 4096 --d 256 \
        --window 2048 --causal 1] [--dtype float32|bfloat16] \
        [--parent PATH [--parent-route 3xtf32|tf32|bf16]]

Builds ``csrc/flash_attention.cu`` a second time with
``-DFLASH_PHASE_CLOCKS`` (``_build.load`` keeps it apart from the plain
build under ``build/kernels/``), in which lane 0 of the last warp of every
CTA sums the clock cycles of each phase of a key block: waiting for the
copies of K and V (with the two barriers a block), QK^T, the softmax (P
needs no relayout: the S accumulator is PV's A fragment), and PV. Runs it
at the given shape (the RecurrentGemma-9B prefill by default, causal;
``--window 0`` for none, ``--causal 0`` for no mask, as HuBERT-XLarge's
``--b 8 --h 16 --kv 16 --s 1500 --d 80 --window 0 --causal 0``; q, k, v of
``--dtype`` as (B,S,H,D) projections viewed as (B,H,S,D)) and prints the cycles a key block of each phase (the
mean over the blocks the CTAs walk), the MMAs a CTA issues in each product
there (``flash_builds.mmas_per_block``: fp32 on the 3xtf32 route, bf16 on
the bf16 route), their rate a CTA and an SM (times the CTAs resident on
it) against an SM's dense peak of one such MMA a cycle, and the kernel's
time with and without the clocks (CUDA events). ``--parent PATH``
(another copy of ``flash_attention.cu``, e.g. from a ``git archive`` of
the parent under ``build/``) does the same for that copy first, in the
same process, counting MMAs by ``--parent-route`` (the tree's route by
default; ``tf32`` for a bf16 instance on m16n8k8 TF32), and counts the
output elements where the two copies differ. The last line is a JSON
object with the same numbers.
"""

import argparse
import json
import re
import sys

import flash_builds as fb

PHASES = ("wait for K/V", "QK^T", "softmax", "PV")
DEFINES = ("FLASH_PHASE_CLOCKS",)


def main() -> int:
    import ctypes

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--h", type=int, default=16)
    ap.add_argument("--kv", type=int, default=1)
    ap.add_argument("--s", type=int, default=4096)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--window", type=int, default=2048,
                    help="0 for no window")
    ap.add_argument("--causal", type=int, choices=(0, 1), default=1)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--parent", help="another copy of flash_attention.cu")
    ap.add_argument("--parent-route", choices=sorted(fb.ROUTES),
                    help="the route the parent's instance takes (default: "
                         "this tree's)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_phases: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FK

    smi = fb.card()
    print(smi)
    b, h, kv, s, d = args.b, args.h, args.kv, args.s, args.d
    causal = bool(args.causal)
    win = args.window if args.window > 0 else None
    tdt = getattr(torch, args.dtype)
    el = torch.empty((), dtype=tdt).element_size()
    route = "3xtf32" if args.dtype == "float32" else "bf16"
    q, k, v = fb.inputs(h, kv, s, d, tdt, b=b)
    geo = FK.launch_geometry(b, h, kv, s, s, d, causal, win, dtype=tdt)
    print(f"shape (B,H,KV,S,D)={(b, h, kv, s, d)}, {args.dtype}, "
          f"{'causal' if causal else 'non-causal'}, "
          f"window {win}: {geo.rows} rows a CTA, {geo.ctas} CTAs x "
          f"{geo.threads} threads, {geo.ctas_per_sm} CTA(s) per SM on "
          f"{geo.n_sms} SMs, {geo.waves} wave(s) (this tree's build)")

    def measure(name, route, plain_lib, clocked_lib, log=None):
        if log is not None:
            spills = [line.strip() for line in log.splitlines()
                      if re.search(r"[1-9]\d* bytes spill", line)]
            print(f"{name}: instrumented build, {len(spills)} ptxas "
                  f"line(s) with spills"
                  + "".join(f"\n  {line}" for line in spills))
        per_sm = fb.max_active(plain_lib, d, el)
        want, got = torch.empty_like(q), torch.empty_like(q)
        plain = fb.caller(plain_lib, q, k, v, want, causal=causal,
                          window=win)
        clocked = fb.caller(clocked_lib, q, k, v, got, causal=causal,
                            window=win)
        clocked_lib.flash_attention_phase_cycles.argtypes = [ctypes.c_void_p]
        clocked_lib.flash_attention_phase_cycles.restype = ctypes.c_int
        sums = (ctypes.c_ulonglong * (len(PHASES) + 1))()
        with torch.no_grad():
            ms = fb.time_ms(plain, args.iters)
            clocked_lib.flash_attention_phase_cycles(sums)  # zero them
            clocked()
            torch.cuda.synchronize()
            if clocked_lib.flash_attention_phase_cycles(sums):
                raise RuntimeError("reading the phase clocks failed")
            tol = 1e-6 if args.dtype == "float32" else 2.0 ** -7
            if not torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol):
                raise RuntimeError(f"{name}: the instrumented kernel "
                                   f"computes otherwise")
            ms_clocked = fb.time_ms(clocked, args.iters)
        blocks = sums[len(PHASES)]
        per_block = [c / blocks for c in list(sums)[:len(PHASES)]]
        total = sum(per_block)
        qk, pv = fb.mmas_per_block(route, d)
        mmas = [0, qk, 0, pv]
        print(f"{name} ({fb.ROUTES[route]}, {per_sm} CTA(s) a SM): kernel "
              f"{ms:.4f} ms; with the clocks {ms_clocked:.4f} ms; {blocks} "
              f"key blocks of {FK.KEY_BLOCK} walked; {total:.0f} cycles a "
              f"key block, so "
              f"{total * blocks / per_sm / geo.n_sms / ms / 1e6:.3f} GHz "
              f"over the kernel's time if the SMs were never idle")
        for phase, cyc, m in zip(PHASES, per_block, mmas):
            rate = (f", {m / cyc:.3f} MMA a cycle a CTA, {per_sm * m / cyc:.3f}"
                    f" an SM with all its CTAs in this phase (an SM's dense "
                    f"peak is 1)" if m else "")
            print(f"  {phase}: {cyc:.0f} cycles a key block "
                  f"({100 * cyc / total:.1f}%), {m} MMAs{rate}")
        outs[name] = want
        return {"route": fb.ROUTES[route], "ctas_per_sm": per_sm, "ms": ms,
                "ms_clocked": ms_clocked,
                "blocks": blocks,
                "cycles_per_block": dict(zip(PHASES, per_block)),
                "mmas_per_block": dict(zip(PHASES, mmas))}

    results, outs = {}, {}
    if args.parent:
        results["parent"] = measure(
            "parent", args.parent_route or route,
            _build.load_copy(args.parent, "parent"),
            _build.load_copy(args.parent, "parent", DEFINES))
    lib = FK.bind(_build.load("flash_attention", DEFINES))
    log = _build._target("flash_attention", DEFINES).with_suffix(".log")
    results["tree"] = measure(
        "this tree", route, FK.bind(_build.load("flash_attention")), lib,
        log.read_text())
    if args.parent:
        diff = (outs["parent"].float() - outs["this tree"].float()).abs()
        results["parent"]["differ_from_tree"] = int((diff > 0).sum())
        print(f"parent against this tree: {int((diff > 0).sum())} of "
              f"{diff.numel()} elements differ, max abs diff "
              f"{diff.max().item():.3e}")
    print(json.dumps({"shape": [b, h, kv, s, d], "dtype": args.dtype,
                      "causal": causal, "window": win, **results,
                      "card": smi,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
