#!/usr/bin/env python3
"""The bf16 flash instance's CTAs a SM, timed both ways in one run on one
NVIDIA GPU.

    python3 scripts/flash_knobs.py [--h 56 --kv 8 --s 4096 --d 128] \
        [--rounds 3]

The bf16 instance's launch bounds ask registers for 2 CTAs a SM at
D <= 128 (``bf16_min_ctas`` in ``csrc/flash_attention.cu``). This builds
the source as it is and an edited copy whose ``bf16_min_ctas`` asks for 1
(written under ``build/kernels/edited/`` and built by
``_build.load_copy``), prints each build's ptxas lines for the bf16
instance at ``--d`` (registers, spills) and its resident CTAs a SM on the
card, and holds its output at the Yi-34B prefill's shape (bf16, causal, no
window; q, k, v as (B,S,H,D) projections viewed as (B,H,S,D)) against the
fp32 kernel on the widened inputs within ``bf16_limit``. Then times the
builds by CUDA events in ``--rounds`` rounds, each in the order as-is,
edited, then the same backwards, and prints each build's mean and spread.
The last line is a JSON object with the same numbers.
"""

import argparse
import json
import sys

import flash_builds as fb

#: build name -> (text of the source, its replacement); each found once
EDITS = {"as is": None,
         "1 CTA/SM": ("  return d <= 128 ? 2 : 1;", "  return 1;")}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=56)
    ap.add_argument("--kv", type=int, default=8)
    ap.add_argument("--s", type=int, default=4096)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_knobs: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FK

    smi = fb.card()
    print(smi)
    h, kv, s, d = args.h, args.kv, args.s, args.d
    q, k, v = fb.inputs(h, kv, s, d, torch.bfloat16)
    wide = FK.flash_attention(q.float(), k.float(), v.float(), causal=True)
    limit = FK.bf16_limit(wide, v)
    src = _build.CSRC / "flash_attention.cu"

    calls, report = {}, {}
    for name, edit in EDITS.items():
        if edit is None:
            lib = _build.load("flash_attention")
            log = _build._target("flash_attention").with_suffix(".log")
        else:
            text = src.read_text()
            if text.count(edit[0]) != 1:
                raise RuntimeError(f"{name}: {edit[0]!r} is not in the "
                                   f"source exactly once")
            slug = name.replace("/", "-").replace(" ", "_")
            copy = _build.BUILD_DIR / "edited" / slug / src.name
            copy.parent.mkdir(parents=True, exist_ok=True)
            copy.write_text(text.replace(*edit))
            lib = _build.load_copy(copy, "edited")
            log = _build.copy_target(copy, "edited").with_suffix(".log")
        out = torch.empty_like(q)
        call = fb.caller(lib, q, k, v, out)
        call()
        torch.cuda.synchronize()
        share = ((out.float() - wide).abs() / limit).max().item()
        ptxas = fb.ptxas_lines(log.read_text(),
                               "flash_attention_bf16_kernel", d)
        per_sm = fb.max_active(lib, d, 2)
        print(f"{name}: {per_sm} CTA(s) a SM; largest share of the limit "
              f"{share:.4f} {'ok' if share <= 1 else 'FAIL'}; ptxas: "
              f"{'; '.join(ptxas) or 'not found'}")
        if share > 1:
            raise RuntimeError(f"{name}: outside the limit")
        calls[name] = call
        report[name] = {"edit": edit, "ctas_per_sm": per_sm,
                        "limit_share": share, "ptxas": ptxas, "ms": []}

    order = list(EDITS)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            report[name]["ms"].append(fb.time_ms(calls[name], args.iters))
    for name, r in report.items():
        ms = r["ms"]
        r["mean_ms"] = sum(ms) / len(ms)
        print(f"{name}: {r['mean_ms']:.4f} ms (min {min(ms):.4f}, max "
              f"{max(ms):.4f} over {len(ms)} timings) ({smi})")
    print(json.dumps({"shape": [1, h, kv, s, d], "builds": report,
                      "card": smi, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
