#!/usr/bin/env python3
"""Can flash attention run on TF32 tensor cores in split precision (3xTF32)
and still hold the port's limits? Answers it on one NVIDIA GPU before a
kernel is written, with the arithmetic in plain PyTorch.

    python3 scripts/flash_precision.py [--seed 0]

1. At RecurrentGemma-9B's attention shape (B=1, H=16, one KV head,
   S=4096, D=256, causal, window 2048; q, k, v as (B,S,H,D) projections
   viewed as (B,H,S,D), standard normal from the seed) it holds
   ``flash_attention_3xtf32`` and the CUDA kernel against the plain
   version, with the kernel tolerance rtol = atol = 2e-5.
2. It runs the RecurrentGemma-9B prefill (B=1, S=4096, random weights from
   the seed drawn by the card's generator, tokens from the seed) three
   times: with the plain versions of every kernel, with the CUDA kernels,
   and with the CUDA kernels but flash attention replaced by the 3xTF32
   emulation (``repro_torch.kernels.ops.flash_attention`` swapped in this
   process only). Each last-position logits row is held against the plain
   one, relative to the largest plain logit, beside the 1e-4 limit.

The last line is a JSON object with the numbers and the route the rule
picks: 3xTF32 if the emulation holds 2e-5 at the kernel shape and its
prefill error is at most 9.5e-5 (the error a 1-2 ulp change of the
embeddings gives the plain path), else fp32 SIMT.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_ATTN = 2e-5
TOL_PREFILL_REL = 1e-4
RULE_PREFILL_REL = 9.5e-5
S = 4096


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_precision: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import ops
    from repro_torch.models import Model

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("fp32 matmuls must run in full fp32 here")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    cfg = get_arch("recurrentgemma-9b")
    h, kv, hd, win = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.attn_window
    result = {"device": torch.cuda.get_device_name(0), "power": smi}

    # -- 1. the function at the kernel's shape -------------------------------
    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    q = randn(1, S, h, hd).transpose(1, 2)
    k = randn(1, S, kv, hd).transpose(1, 2)
    v = randn(1, S, kv, hd).transpose(1, 2)
    with torch.no_grad():
        want = FK.plain(q, k, v, causal=True, window=win)
        for name, got in (
                ("3xTF32 emulation", FK.flash_attention_3xtf32(
                    q, k, v, causal=True, window=win)),
                ("CUDA kernel", FK.flash_attention(q, k, v, causal=True,
                                                   window=win))):
            err = (got - want).abs()
            excess = (err / (TOL_ATTN + TOL_ATTN * want.abs())).max().item()
            print(f"{name} at (B,H,S,D)={(1, h, S, hd)}, KV={kv}, causal, "
                  f"window {win}: max abs err {err.max().item():.4e}, max "
                  f"rel err {(err.max() / want.abs().max()).item():.4e}, "
                  f"worst err / (atol + rtol|ref|) {excess:.4f} "
                  f"(tolerance rtol=atol={TOL_ATTN}) "
                  f"{'ok' if excess <= 1 else 'FAIL'}")
            result[name] = {"max_abs_err": err.max().item(),
                            "worst_ratio": excess}
    del q, k, v, want, got, err

    # -- 2. the prefill's logits ---------------------------------------------
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(1, S))).to(dev)
    kernel = ops.flash_attention
    emulated_calls = 0

    def emulated(q, k, v, *, causal=True, window=None, kernel_impl="hopper"):
        nonlocal emulated_calls
        if kernel_impl == "hopper" and q.is_cuda:
            emulated_calls += 1
            return FK.flash_attention_3xtf32(q, k, v, causal=causal,
                                             window=window)
        return kernel(q, k, v, causal=causal, window=window,
                      kernel_impl=kernel_impl)

    def last_logits(impl):
        with torch.no_grad():
            return Model(cfg, kernel_impl=impl).apply(
                params, {"tokens": tokens})[0][:, -1].clone()

    plain = last_logits("plain")
    scale = plain.abs().max()
    runs = {}
    for name in ("CUDA kernels", "CUDA kernels, flash as 3xTF32"):
        ops.flash_attention = emulated if "3xTF32" in name else kernel
        try:
            got = last_logits("hopper")
        finally:
            ops.flash_attention = kernel
        rel = ((got - plain).abs().max() / scale).item()
        runs[name] = rel
        print(f"prefill (B,S)={(1, S)} last-position logits, {name} vs "
              f"plain: relative {rel:.4e} (limit {TOL_PREFILL_REL}, rule "
              f"{RULE_PREFILL_REL}), finite {bool(torch.isfinite(got).all())}")
    n_attn = sum(kind == "lattn" for kind in cfg.layer_pattern)
    if emulated_calls != n_attn:
        raise RuntimeError(f"the emulation ran {emulated_calls} times, "
                           f"expected {n_attn}")
    result["prefill_rel"] = runs
    ok_shape = result["3xTF32 emulation"]["worst_ratio"] <= 1
    ok_prefill = runs["CUDA kernels, flash as 3xTF32"] <= RULE_PREFILL_REL
    result["route"] = "3xTF32" if ok_shape and ok_prefill else "fp32 SIMT"
    print(f"route: {result['route']} (kernel shape "
          f"{'holds' if ok_shape else 'fails'} {TOL_ATTN}; prefill "
          f"{'within' if ok_prefill else 'past'} {RULE_PREFILL_REL})")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
