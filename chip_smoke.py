#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (the quickest proof that
the port starts on the card).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. the card's name and power limit, then the build of every CUDA kernel
     (``src/repro_torch/kernels/csrc``) with its seconds and ptxas report;
  2. each kernel against its plain PyTorch version on the card, at the
     full-width prefill shapes of xLSTM-125M (B=8, S=2048), with errors
     against the stated tolerance, times and bounds; for the mLSTM also its
     launch geometry (column tile, CTAs, waves, shared memory), for the
     sLSTM its cluster geometry, its time a step and that of one chain
     alone;
  3. the prefill step at full width through the entry points a user calls,
     with the launch counts zeroed just before and read just after (10
     mLSTM and 2 sLSTM launches), held against the same model on the plain
     kernel versions;
  4. the decode Server at full width answering 6 short requests and one
     512-token request submitted as futures under plan("threads"); the
     long request's first token and its logits are held against the
     prefill step on the same prompt;
  5. xLSTM-125M training at full width (B=8, S=512, fp32, remat "none"):
     one train step's loss and every grad leaf with the kernels (their
     backward a recompute through the plain versions) against the plain
     path from the same params and batch, with the launch counts read after
     the forward (10 mLSTM, 2 sLSTM) and after the backward (none); the
     Trainer for 4 steps under plan("threads") with checkpoints at steps 2
     and 4, its loss curve held against the plain path's and the step-4
     checkpoint restored bit for bit; then the train step's times (forward
     with loss, backward with the optimiser), tokens/s, peak memory and the
     share of the backward spent recomputing each kernel's plain version;
  6. the Future API on the card, with phase 3's params: three prefills
     (B=8, S=2048) as futures under plan("cuda_async"), each with the host
     ms until future() returns, resolved() right then, the ms until
     value() against the direct call, its launch counts (10 mLSTM, 2
     sLSTM) and its tokens bit for bit phase 3's; a watcher waiting on
     device work while the main thread runs Python (the GIL is free); the
     same future_map of the prefill over 4 batches of B=2 on sequential,
     threads (2 workers), cuda_async and asyncio, each with its wall ms, 40
     mLSTM and 8 sLSTM launches and the sequential tokens bit for bit; a
     stream pipeline under cuda_async at max_in_flight=2 giving the same
     tokens; and the shared state: an exact state.add fold from 8 futures
     on threads, and state.get returning the live params.
Then the xLSTM model is freed and RecurrentGemma-9B (38 layers, d_model
4096, 10.4 B fp32 parameters, random from the seed) takes the card:
  2b. the RG-LRU scan, windowed flash attention and split-S decode
      attention against their plain versions at its full-width shapes,
      with times, bounds and, for attention, one PyTorch library call;
      for decode attention also its launch geometry (chunks, CTAs and
      those with work, CTAs a SM, waves, shared memory, bytes in flight,
      partial and HBM bytes), checked against the launch the kernel made,
      and its time by CUDA-graph replay both warm (one cache, in L2) and
      cold (the 12 attention layers' caches of a decode step in turn,
      201 MB in fp32);
      for the RG-LRU scan also its launch geometry (stripe, tile, stages,
      CTAs, waves, shared memory, bytes in flight a SM, HBM bytes), checked
      against the launch the kernel made, the decode step's shape and
      unaligned rows (W=203), and the byte yardstick
      torch.addcmul(x, a_gate, i_gate) with the TB/s of both; the small
      kernels are timed by CUDA-graph replay beside CUDA events; for flash
      attention also its launch geometry (rows a CTA, CTAs, waves, shared
      memory, K and V bytes read from L2) and both bounds, fp32 SIMT and
      3xTF32 on tensor cores (its route);
  3b. the prefill step at B=1, S=4096 (past the 2048 window), with the
      launch counts zeroed just before and read just after (26 rglru_scan
      and 12 flash_attention launches), held against the plain path with
      its attention summed in fp64 (``WidenedFlash(torch.float64)``);
  4b. the decode Server for this arch answering the same kind of traffic;
      one decode step at B=4 (26 rglru_scan and 12 decode_attention
      launches) is timed, and the 512-token request's decode-path logits
      are held against the prefill step.
Then RecurrentGemma is freed and Yi-9B (48 attn layers, d_model 4096, 32
heads over 4 KV heads of 128, d_ff 11008, vocab 64000; 8.83 B fp32
parameters, random from the seed on the card) takes it:
  2c. both attention kernels against their plain versions at its shapes:
      flash at B=1, S=4096, causal with no window; decode at B=4, S=4096,
      lengths (1, 1000, 4096, 4096), fp32 and bf16 caches; decode at
      yi-34b's grouping (56 heads over 8 KV heads, G=7); each with its
      launch geometry checked against the launch, its time (decode also
      warm and cold by graph replay, cold over the 48 layers' caches),
      its bounds and one PyTorch library call;
  3c. the prefill step at B=1, S=4096 (48 flash_attention launches and no
      other kernel), held against the plain path within 1e-4 of the
      largest logit, beside the 1-ulp yardstick;
  4c. the decode Server for yi-9b answering 6 short requests and one
      512-token request; one decode step at B=4 with every cache holding
      4096 positions (48 decode_attention launches) with its device time,
      wall time and idle share; the 512-token request's decode-path logits
      held against the prefill step.
Then Yi-9B is freed and Qwen1.5-MoE-A2.7B (24 moe layers, d_model 2048,
16 heads over 16 KV heads of 128, 60 routed experts padded to 64, top-4,
4 shared; 15.15 B fp32 parameters, random from the seed on the card)
takes it:
  2d. both attention kernels against their plain versions at its shapes
      (G=1): flash at B=1, S=4096, causal with no window; decode at B=4,
      S=4096, lengths (1, 1000, 4096, 4096), fp32 and bf16 caches, cold
      over the 24 layers' caches; as in 2c;
  3d. the prefill step at B=1, S=4096 (24 flash_attention launches and no
      other kernel), held against the plain path by the flip-aware rule
      (``hold_flip_rule``: every MoE layer's routing decisions are
      recorded, and the logits are held before p*, the first position
      where a decision differs), beside the 1-ulp yardstick, with the
      share of assignments dropped by capacity;
  4d. the decode Server for qwen2-moe-a2.7b answering 6 short requests and
      one 512-token request; one decode step at B=4 with every cache
      holding 4096 positions (24 decode_attention launches) with its
      device time, wall time and idle share; the 512-token request's
      decode-path logits at every step held by the same rule against a
      prefill that cannot drop (capacity factor n_experts), beside the
      assignments the real prefill drops on that prompt.
Then qwen2-moe is freed and DeepSeekMoE-16B (28 layers, a dense first
one; 64 routed experts, top-6, 2 shared; 16.38 B fp32 parameters) takes
it:
  3e. its prefill at B=1, S=4096 (28 flash_attention launches) held by the
      flip-aware rule, and one decode step at B=4 with every cache holding
      4096 positions (28 decode_attention launches), timed.
Then DeepSeekMoE-16B is freed and Yi-34B (60 attn layers, d_model 7168, 56
heads over 8 KV heads of 128, d_ff 20480, vocab 64000; 34.39 B parameters,
drawn from the seed on the card in bf16, 68.78 GB; nothing cut) takes it:
  2f. both attention kernels in bf16 at its shapes (G=7): flash at B=1,
      S=4096, causal with no window; decode at B=4, S=4096, lengths (1,
      1000, 4096, 4096), a bf16 q on a bf16 and on an fp32 cache; each as
      in 2c, and each against its fp32 kernel on the widened inputs:
      flash (bf16 tensor cores, P in two bf16 parts, its sums in another
      order) elementwise within one bf16 ulp plus 2^-14 max|v|, with the
      elements that differ printed (``hold_flash_bf16``), beside the
      share of that limit a control with P as one bf16 part takes (plain
      PyTorch, no limit); decode rounded to bf16, bit for bit; the flash
      bound beside its route's (1 + 2 bf16 products);
  3f. the prefill step at B=1, S=4096 (60 flash_attention launches on bf16
      q, k and v, and no other kernel), its logits held (a) against the
      same prefill with every flash_attention call's inputs widened to
      fp32 and its output rounded back (``WidenedFlash``) and (b) against
      the plain path, each within the 1-ulp bf16 yardstick of the same
      run, and (c) timed, with tokens/s and peak memory;
  4f. the decode Server for yi-34b on the bf16 tree (fp32 caches, bf16 q)
      answering 6 short requests and one 512-token request; one decode step
      at B=4 with every bf16 cache holding 4096 positions (60
      decode_attention launches) with its device time, wall time and idle
      share; the 512-token request's decode-path logits held against the
      prefill step within TOL_DECODE_REL_BF16, beside the yardstick.
Then Yi-34B is freed and MiniCPM3-4B (62 mla layers, d_model 2560, 40
heads, latents r_q 768 and r_kv 256, q.k at 64 + 32 dims and v at 64, d_ff
6400, vocab 73448; 4.26 B fp32 parameters, random from the seed on the
card; nothing cut) takes it. Its path runs no kernel, as the reference's
runs no Pallas kernel there:
  3g. the prefill step at B=1, S=4096 with every launch count 0, its
      last-position logits held against the same model summed in fp64
      (``mla_logits_fp64``) within 1e-4 of the largest logit, beside the
      1-ulp yardstick, and timed, with tokens/s and peak memory;
  4g. the decode Server for minicpm3-4b answering 6 short requests and one
      of 256 tokens (cut from 512 for time) through the absorbed-latent
      decode; one decode step at B=4 with every latent cache holding 4096
      positions (no launch) with its device time, wall time and idle
      share; the long request's decode-path logits held against the
      expanded prefill within 1e-3.
Then MiniCPM3-4B is freed and HuBERT-XLarge (48 attn layers, d_model 1280,
16 heads of 80, non-causal, the audio frontend; 0.959 B fp32 parameters,
random from the seed on the card; nothing cut) takes it, on B=8 clips of
S=1500 frames. An encoder has no decode step, so it has no Server phase:
  2h. flash attention at its shape (B=8, H=KV=16, S=1500, D=80,
      non-causal) in fp32 and in bf16, each as in 2c and 2f: against the
      plain version, the bf16 instance also against the fp32 kernel on
      the widened inputs within ``bf16_limit``; times, bounds and one
      library call;
  3h. the forward through ``make_prefill_step`` (48 flash_attention
      launches and no other kernel), timed, with frames/s and peak memory;
      its logits at every position and ``make_eval_step``'s loss held
      against the plain path with its attention in fp64 within 1e-4 of
      the largest logit and of the loss, beside the 1-ulp yardstick; then
      the same forward from the tree rounded to bf16 (48 launches on bf16
      q, k and v), held against its widened-kernel forward and against
      the plain path within HUBERT_BF16_YARDSTICKS of the 1-ulp bf16
      yardstick of the same run.
Each phase prints its seconds. The line before the last is a JSON object
with one entry per kernel, and one more for each attention kernel at
Yi-9B's, qwen2-moe's, Yi-34B's (bf16) and HuBERT-XLarge's (fp32 and bf16)
shapes; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero and prints no result.
"""

import gc
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
B, S = 8, 2048                   # full-width prefill shape
# H100 SXM data sheet: fp32 outside the tensor cores, dense TF32 and dense
# bf16 on them, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# tolerances: the kernel ones are tests/test_kernels.py's (mLSTM 5e-4,
# sLSTM 3e-5, as rtol and atol); model logits are compared relative to the
# largest logit, because fp32 sums taken in another order differ by about
# 1e-6 of the value at each of the 12 blocks
TOL_MLSTM = 5e-4
TOL_SLSTM = 3e-5
TOL_PREFILL_REL = 1e-4           # kernel path vs plain path, same algorithm
TOL_DECODE_REL = 1e-3            # recurrent decode vs chunkwise prefill
# RecurrentGemma: the RG-LRU tolerance is tests/test_kernels.py's 3e-5, the
# attention ones its _tol (2e-5 fp32, 2e-2 bf16)
TOL_RGLRU = 3e-5
TOL_ATTN = {"float32": 2e-5, "bfloat16": 2e-2}
RG_S = 4096                      # prefill length, twice the window
RG_DEC_B = 4                     # decode batch
RG_DEC_LENGTHS = (1, 700, 2048, 2048)
# Yi-9B: prefill length; decode batch and cache lengths; yi-34b's grouping
# (56 heads over 8 KV heads) for decode attention at a shorter cache
YI_S = 4096
YI_DEC_B = 4
YI_DEC_LENGTHS = (1, 1000, 4096, 4096)
YI34_H, YI34_KV, YI34_S = 56, 8, 1024
YI34_LENGTHS = (1, 300, 1024, 1024)
# the MoE family: prefill length, decode batch and cache lengths as Yi's;
# the flip-aware rule's floor on p*, the first position where a routing
# decision differs (S/8), and its cap on the share of decisions that differ
MOE_S = 4096
MOE_DEC_B = 4
MOE_DEC_LENGTHS = (1, 1000, 4096, 4096)
MIN_FIRST_FLIP = 1 / 8
MAX_FLIP_SHARE = 0.01
# Yi-34B in bf16 (phases 2f to 4f): prefill length; decode batch and cache
# lengths as Yi-9B's. The decode path against the prefill in bf16: every
# activation is rounded to 8 significant bits after each product, and the
# decode path's products (M = 1) sum in other orders than the prefill's, so
# over 60 random layers the two differ as far as rounding alone carries the
# model, which the 1-ulp yardstick (printed beside) measures at a few
# percent of the largest logit; the limit sits above that, while a decode
# path that drops a token, a position or a cache slot moves the logits by a
# large share of the largest. fp32's 1e-3 does not apply.
YI34_DEC_LENGTHS = (1, 1000, 4096, 4096)
TOL_DECODE_REL_BF16 = 0.1
# MiniCPM3-4B (phases 3g, 4g): prefill length, decode batch, the Server's
# long request; its path runs no kernel, so its fp32 prefill is held
# against the same model summed in fp64 (``mla_logits_fp64``) within
# TOL_PREFILL_REL, and its absorbed decode against the expanded prefill
# within TOL_DECODE_REL. The long request is cut from 512 tokens to 256:
# a decode step's wall is ~140-200 ms (host-bound, ~75 launches a layer
# over 62 layers), and at 512 tokens phase 4g alone took 193 s
MLA_S = 4096
MLA_DEC_B = 4
MLA_LONG = 256
# HuBERT-XLarge (phases 2h, 3h): B clips of S frames, eight 30-second clips
# at 20 ms a frame, the unit of offline transcription and labelling; 1500
# = 11 x 128 + 92 = 46 x 32 + 28, so every launch has a ragged query tile
# and a ragged key block. The fp32 forward's logits and eval loss are held
# against the plain path with its attention in fp64 within TOL_PREFILL_REL.
# The bf16 forward (the fp32 tree rounded to bf16) is held against its
# widened-kernel counterpart and against the plain path within
# HUBERT_BF16_YARDSTICKS times the 1-ulp bf16 yardstick of the same run:
# over 48 random bf16 layers any rounding difference grows to the
# yardstick's size (Yi-34B's read 0.82-0.84 of one yardstick over 60), so
# one yardstick would test the seed, while a kernel that drops keys or
# columns moves the logits by a large share of the largest
HUBERT_B, HUBERT_S = 8, 1500
HUBERT_BF16_YARDSTICKS = 2.0
# training (phase 5): examples/train_lm.py --full's batch and length;
# limits: the loss within 1e-4 relative, each grad leaf within 1e-3 of
# that leaf's largest plain grad (the mLSTM input-gate bias b_i on its
# block's w_i scale, see test_torch_train.py), the 4-step loss curve
# within 1e-3 relative at every step. The curve runs
# at lr 3e-5 (warmup 1), not train_lm.py's 6e-4: from the reference's
# init (loss ~300) the plain path against itself with the embeddings moved
# by one ulp drifts past 1e-3 by step 4 at 6e-4 and at 1e-4, so no
# implementation with other rounding could meet the limit there; at 3e-5
# that yardstick stays near 5e-5 while a zeroed or 10% scaled mLSTM
# backward moves the curve by 1e-2 and 2e-3 (scripts/train_divergence.py)
TRAIN_B, TRAIN_S, TRAIN_LR, TRAIN_STEPS = 8, 512, 3e-5, 4
TOL_TRAIN_LOSS_REL = 1e-4
TOL_TRAIN_GRAD_REL = 1e-3
TOL_TRAIN_CURVE_REL = 1e-3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


_last_mark = [time.perf_counter()]


def phase_done(name: str) -> None:
    """Prints the seconds since the previous phase ended."""
    now = time.perf_counter()
    print(f"phase {name}: {now - _last_mark[0]:.1f} s")
    _last_mark[0] = now


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
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


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph (after a warm-up on the capturing stream, which also builds
    the kernel), the graph replayed ``replays`` times between two events.
    Unlike :func:`cuda_ms`, the host's cost of a call is not in it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def bound(flops: float, nbytes: float,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels import mlstm_scan as MK
    from repro_torch.kernels import slstm_scan as SK
    from repro_torch.models import Model
    from repro_torch.serve import Server
    from repro_torch.train import make_prefill_step

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def randn(*shape, scale=1.0, shift=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * scale + shift
        return torch.from_numpy(a).to(dev)

    # -- 1. card and build ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)                   # the card's name and power limit
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {len(reports)} kernels in "
          f"{time.perf_counter() - t0:.1f} s")
    phase_done("1")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    check(not re.search(r"[1-9]\d* bytes spill", reports["flash_attention"]),
          "no flash_attention instance spills registers")

    # -- 2. kernels against their plain versions -----------------------------
    cfg = get_arch("xlstm-125m")
    H, D = cfg.xlstm.n_heads, cfg.xlstm.head_dim           # 4, 384
    NH, HD = cfg.xlstm.n_heads, cfg.d_model // cfg.xlstm.n_heads   # 4, 192
    kernels = {}

    q, k, v = randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D)
    ig, fg = randn(B, H, S), randn(B, H, S, shift=2.0)
    mgeo = MK.launch_geometry(B, H, D)
    print(f"mlstm_scan geometry: DV={mgeo.dv} columns of C a CTA, "
          f"{mgeo.grid} CTAs x {mgeo.threads} threads, {mgeo.ctas_per_sm} "
          f"CTA(s) per SM on {mgeo.n_sms} SMs, {mgeo.waves} wave(s), "
          f"{mgeo.smem_bytes} B of shared memory a CTA, chunk {MK.CHUNK}")
    out = MK.mlstm_scan(q, k, v, ig, fg)
    torch.cuda.synchronize()
    ref = MK.plain(q, k, v, ig, fg, cs=256)
    err = (out - ref).abs()
    # the function's floor, whatever the chunking: the recurrent form's
    # q.C readout and k (x) v update, D*D FMAs each a row
    flops = 4.0 * B * H * S * D * D
    nbytes = 4.0 * (4 * B * H * S * D + 2 * B * H * S)
    kernels["mlstm_scan"] = dict(
        name="mlstm_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/mlstm_scan.cu",
        replaces="src/repro/kernels/mlstm_scan.py:29",
        max_abs_err=err.max().item(),
        ms=cuda_ms(lambda: MK.mlstm_scan(q, k, v, ig, fg), 10),
        plain_ms=cuda_ms(lambda: MK.plain(q, k, v, ig, fg, cs=256), 3),
        library_ms=None)
    kernels["mlstm_scan"]["bound_ms"], kernels["mlstm_scan"]["bound_by"] = \
        bound(flops, nbytes)
    ok = bool((err <= TOL_MLSTM + TOL_MLSTM * ref.abs()).all())
    print(f"mlstm_scan (B,H,S,D)={(B, H, S, D)}: max abs err "
          f"{err.max().item():.3e}, max rel err "
          f"{(err.max() / ref.abs().max()).item():.3e} (tolerance rtol=atol="
          f"{TOL_MLSTM}) {'ok' if ok else 'FAIL'}")
    check(ok, "mlstm_scan kernel disagrees with its plain version")
    del q, k, v, ig, fg, out, ref, err

    zs = [randn(B, NH, S, HD) for _ in range(4)]
    rs = [randn(NH, HD, HD, scale=HD ** -0.5) for _ in range(4)]
    geo = SK.launch_geometry(B, NH, HD)
    print(f"slstm_scan geometry: clusters of {geo.cl} CTAs x {geo.threads} "
          f"threads, {geo.rb} batch rows a cluster, {geo.n_clusters} "
          f"clusters ({geo.grid} CTAs), at most {geo.max_active_clusters} "
          f"clusters resident, R in {SK.R_HELD_IN}")
    out = SK.slstm_scan(*zs, *rs)
    torch.cuda.synchronize()
    ref = SK.plain(*zs, *rs)
    err = (out - ref).abs()
    flops = 8.0 * B * NH * S * HD * HD
    nbytes = 4.0 * (5 * B * NH * S * HD + 4 * NH * HD * HD)
    kernels["slstm_scan"] = dict(
        name="slstm_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/slstm_scan.cu",
        replaces="src/repro/kernels/slstm_scan.py:29",
        max_abs_err=err.max().item(),
        ms=cuda_ms(lambda: SK.slstm_scan(*zs, *rs), 10),
        plain_ms=cuda_ms(lambda: SK.plain(*zs, *rs), 1, warmup=0),
        library_ms=None)
    kernels["slstm_scan"]["bound_ms"], kernels["slstm_scan"]["bound_by"] = \
        bound(flops, nbytes)
    ok = bool((err <= TOL_SLSTM + TOL_SLSTM * ref.abs()).all())
    print(f"slstm_scan (B,NH,S,HD)={(B, NH, S, HD)}: max abs err "
          f"{err.max().item():.3e}, max rel err "
          f"{(err.max() / ref.abs().max()).item():.3e} (tolerance rtol=atol="
          f"{TOL_SLSTM}) {'ok' if ok else 'FAIL'}")
    check(ok, "slstm_scan kernel disagrees with its plain version")
    print(f"  slstm_scan: {kernels['slstm_scan']['ms']:.4f} ms a launch, "
          f"{kernels['slstm_scan']['ms'] * 1e3 / S:.4f} us a step")
    # the floor the recurrence sets: one chain at HD=16, where the matvec is
    # negligible and a step is the cell update and the exchange of h
    one = [randn(1, 1, S, 16) for _ in range(4)] + [
        randn(1, 16, 16, scale=0.25) for _ in range(4)]
    ms_one = cuda_ms(lambda: SK.slstm_scan(*one), 10)
    print(f"  slstm_scan, one chain at HD=16 (latency of a step alone): "
          f"{ms_one:.4f} ms a launch, {ms_one * 1e3 / S:.4f} us a step")
    del zs, rs, out, ref, err, one
    for kr in kernels.values():
        print(f"  {kr['name']}: kernel {kr['ms']:.3f} ms, plain "
              f"{kr['plain_ms']:.3f} ms, bound {kr['bound_ms']:.3f} ms "
              f"({kr['bound_by']})")
    phase_done("2")

    # -- 3. prefill step at full width ---------------------------------------
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(SEED), device=dev)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(B, S))).to(dev)
    prefill = make_prefill_step(model)
    MK.launches = SK.launches = 0
    first = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    launches = {"mlstm_scan": MK.launches, "slstm_scan": SK.launches}
    print(f"prefill launches: {launches}")
    n_m = sum(kind == "mlstm" for kind in cfg.layer_pattern)
    n_s = sum(kind == "slstm" for kind in cfg.layer_pattern)
    check(launches == {"mlstm_scan": n_m, "slstm_scan": n_s},
          f"prefill must launch mlstm_scan {n_m}x and slstm_scan {n_s}x")
    check(tuple(first.shape) == (B, 1) and first.dtype == torch.int32,
          "prefill returns (B, 1) int32 tokens")
    for name, n in launches.items():
        kernels[name]["launches"] = n
    ms = cuda_ms(lambda: prefill(params, {"tokens": tokens}), 3)
    prefill_ms = ms
    print(f"prefill (B,S)={(B, S)}: {ms:.1f} ms, "
          f"{B * S / ms * 1e3:.0f} tokens/s")
    with torch.no_grad():
        got = model.apply(params, {"tokens": tokens})[0][:, -1]
        want = Model(cfg, kernel_impl="plain").apply(
            params, {"tokens": tokens})[0][:, -1]
    rel = ((got - want).abs().max() / want.abs().max()).item()
    ok = bool(torch.isfinite(got).all()) and rel <= TOL_PREFILL_REL
    print(f"prefill last-position logits, kernels vs plain: max abs diff "
          f"{(got - want).abs().max().item():.3e}, relative {rel:.3e} "
          f"(tolerance {TOL_PREFILL_REL}) {'ok' if ok else 'FAIL'}")
    check(ok, "prefill with the kernels disagrees with the plain path")
    print("kernels: " + json.dumps([{"name": n, "launches": kr["launches"]}
                                    for n, kr in kernels.items()]))
    del got, want
    phase_done("3")

    # -- 4. the Server at full width -----------------------------------------
    server = Server(smoke=False, slots=4, max_new=16, device=dev,
                    params=params)
    replies, long_prompt = serve_traffic(server, rng, cfg.vocab_size)

    step = server.step
    cache = model.init_cache(4, device=dev)
    tok = torch.zeros(4, 1, dtype=torch.int64, device=dev)
    ms = cuda_ms(lambda: step(params, cache, tok), 32)
    print(f"decode step (B=4): {ms:.2f} ms, {4 / ms * 1e3:.0f} tokens/s")

    hold_long_request(model, params, long_prompt, replies[6][0],
                      model.init_cache(1, device=dev))
    del server, step, cache, tok
    phase_done("4")

    # -- 5. xLSTM-125M training at full width --------------------------------
    training_phase(dev, cfg, params, smi)
    phase_done("5")

    # -- 6. the Future API on the card ---------------------------------------
    future_api_phase(dev, cfg, params, prefill, tokens, first, prefill_ms,
                     smi)
    del first, tokens, prefill
    phase_done("6")

    # -- RecurrentGemma-9B: free the xLSTM model first -----------------------
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    recurrentgemma_phases(dev, rng, kernels)

    # -- Yi-9B: free RecurrentGemma first ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    print(f"after RecurrentGemma is freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    gqa_phases(dev, rng, kernels, smi)

    # -- the MoE family: Yi-9B is freed when gqa_phases returns --------------
    gc.collect()
    torch.cuda.empty_cache()
    print(f"after Yi-9B is freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    moe_phases(dev, rng, kernels, smi)

    # -- Yi-34B in bf16: DeepSeekMoE-16B is freed when moe_phases returns ----
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"after deepseek-moe-16b is freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free")
    yi34_phases(dev, rng, kernels, smi)

    # -- MiniCPM3-4B: Yi-34B is freed when yi34_phases returns ---------------
    gc.collect()
    torch.cuda.empty_cache()
    print(f"after yi-34b is freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    minicpm3_phases(dev, rng, smi)

    # -- HuBERT-XLarge: MiniCPM3-4B is freed when minicpm3_phases returns ----
    gc.collect()
    torch.cuda.empty_cache()
    print(f"after minicpm3-4b is freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    hubert_phases(dev, rng, kernels, smi)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serve_traffic(server, rng, vocab: int,
                  long_len: int = 512) -> tuple[dict, list]:
    """Six 4-token requests and one of ``long_len`` tokens (drawn from
    ``rng``), submitted as futures under plan("threads") to ``server``'s
    running loop, each printed as it resolves; checks that each gets 16
    tokens.
    Returns the replies by request and the long prompt."""
    import repro_torch.core as rc
    rc.plan("threads", workers=4)
    loop = threading.Thread(target=server.serve_loop, daemon=True)
    loop.start()
    prompts = [rng.integers(0, vocab, size=4).tolist() for _ in range(6)]
    prompts.append(rng.integers(0, vocab, size=long_len).tolist())
    t0 = time.perf_counter()
    pending = {i: (server.submit(p), time.perf_counter())
               for i, p in enumerate(prompts)}
    replies = {}
    while pending:
        for i, (f, t_sub) in list(pending.items()):
            if rc.resolved(f):
                replies[i] = rc.value(f)
                print(f"request {i} (prompt {len(prompts[i])} tokens): "
                      f"{time.perf_counter() - t_sub:.3f} s -> "
                      f"{replies[i][:8]}")
                del pending[i]
        time.sleep(0.005)
    wall = time.perf_counter() - t0
    server.stop()
    loop.join(timeout=60)
    check(not loop.is_alive(), "serve loop stopped")
    rc.shutdown()
    check(len(replies) == 7 and all(len(r) == 16 for r in replies.values())
          and all(0 <= t < vocab for r in replies.values() for t in r),
          "the Server answers all 7 requests with 16 tokens each")
    print(f"server: 7 requests in {wall:.3f} s, "
          f"{7 * 16 / wall:.1f} generated tokens/s")
    return replies, prompts[-1]


def hold_long_request(model, params, long_prompt: list, server_first: int,
                      cache, tol: float = TOL_DECODE_REL,
                      yardstick: bool = False) -> None:
    """The long request's decode-path logits (its prompt fed a token at a
    time into ``cache``) against the prefill step's, within ``tol`` of the
    largest logit; with ``yardstick``, beside the plain path's prefill
    against itself with the embeddings moved by one ulp, on the same
    prompt (where ``tol`` was set from it); where the top-2 margin exceeds
    ``tol``, the Server's first token and the decode path's are the
    prefill step's."""
    import torch

    from repro_torch.models import Model
    from repro_torch.train import make_prefill_step
    long_toks = torch.tensor([long_prompt],
                             device=params["embed"]["table"].device)
    with torch.no_grad():
        pre_logits = model.apply(params,
                                 {"tokens": long_toks})[0][0, -1].clone()
        for t in range(len(long_prompt)):
            dec_logits, cache = model.decode_step(params, cache,
                                                  long_toks[:, t:t + 1])
    dec_logits = dec_logits[0, -1]
    pre_tok = int(make_prefill_step(model)(params, {"tokens": long_toks}))
    scale = pre_logits.abs().max().item()
    diff = (dec_logits - pre_logits).abs().max().item()
    top2 = pre_logits.topk(2).values
    margin = (top2[0] - top2[1]).item()
    ok = bool(torch.isfinite(dec_logits).all()) and diff <= tol * scale
    print(f"{len(long_prompt)}-token request: decode-path vs prefill logits "
          f"max abs diff {diff:.3e} (relative {diff / scale:.3e}, tolerance "
          f"{tol}, {diff / scale / tol:.3f} of it) {'ok' if ok else 'FAIL'}; "
          f"first token: server {server_first}, decode path "
          f"{int(dec_logits.argmax())}, prefill {pre_tok}, top-2 margin "
          f"{margin:.3e}")
    if yardstick:
        plain = Model(model.cfg, kernel_impl="plain")
        with torch.no_grad():
            want = plain.apply(params, {"tokens": long_toks})[0][0, -1]
            alt = plain.apply(one_ulp_moved(params),
                              {"tokens": long_toks})[0][0, -1]
        moved = (alt - want).abs().max().item() / want.abs().max().item()
        print(f"  yardstick: plain prefill with the embeddings moved by 1 "
              f"ulp, relative {moved:.3e} ({moved / tol:.3f} of the "
              f"tolerance)")
    check(ok, "decode-path logits disagree with the prefill step")
    if margin > tol * scale:
        check(server_first == pre_tok
              and int(dec_logits.argmax()) == pre_tok,
              "the Server's first token matches the prefill step")
    else:
        print("  top-2 margin below the tolerance: logits compared only")


def one_ulp_moved(params) -> dict:
    """``params`` with the first table the model reads moved by one ulp of
    its own type, away from zero: the yardstick's input, how far rounding
    alone carries a model. That table is the embedding table, or under the
    audio frontend the frames' projection ``frontend/proj``. An fp32
    embedding table is scaled by 1 + 2^-23 (one or two ulps, as every fp32
    phase has moved it); a bf16 table, since a scale by 1 + 2^-23 rounds
    back to it unchanged, and the projection in either type step each
    element to its next value (its integer view plus one)."""
    import torch

    def step(table):
        ints = torch.int16 if table.element_size() == 2 else torch.int32
        return (table.view(ints) + 1).view(table.dtype)

    if "frontend" in params:
        front = params["frontend"]
        return dict(params, frontend=dict(front, proj=step(front["proj"])))
    table = params["embed"]["table"]
    moved = (table * (1 + 2 ** -23) if table.dtype == torch.float32
             else step(table))
    return dict(params, embed={"table": moved})


class WidenedFlash:
    """While active (``with WidenedFlash(dtype)``), every call of
    ``repro_torch.kernels.ops.flash_attention`` (which the attention blocks
    look up at each call) takes its q, k and v widened to ``dtype`` and
    rounds its output back to q's type, with no argument added to the
    entry points: in fp32 (the default), the bf16 prefill's counterpart
    through the fp32 kernel; in fp64, the plain path's attention summed in
    fp64, whose result no summation order moves."""

    def __init__(self, dtype=None):
        self.dtype = dtype

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops
        self._flash = flash = ops.flash_attention
        dtype = torch.float32 if self.dtype is None else self.dtype

        def widened(q, k, v, **kw):
            return flash(q.to(dtype), k.to(dtype), v.to(dtype),
                         **kw).to(q.dtype)

        ops.flash_attention = widened
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels import ops
        ops.flash_attention = self._flash


def mlstm_b_i_scales(cfg, names) -> dict:
    """{b_i path: w_i path} for the mLSTM blocks: b_i's grad is the sum of
    dL/d i_raw over positions, which cancels to 1e-4 or less of w_i's
    (the same terms weighted by the conv output), so it is held on that
    scale."""
    kinds = dict(enumerate(cfg.layer_pattern))
    return {name: name[:-len("b_i")] + "w_i" for name in names
            if name.endswith("/b_i")
            and kinds[int(name.split("/")[2][1:])] == "mlstm"}


def training_phase(dev, cfg, params, smi: str) -> None:
    import tempfile

    import torch

    import repro_torch.core as rc
    from repro_torch.data import synth_batch
    from repro_torch.kernels import mlstm_scan as MK
    from repro_torch.kernels import slstm_scan as SK
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import (Trainer, TrainerConfig, init_train_state,
                                   make_train_step)
    from repro_torch.tree import leaves, map_with_path, tree_map

    B_, S_ = TRAIN_B, TRAIN_S
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             synth_batch(cfg, batch=B_, seq=S_, seed=SEED, step=0).items()}
    names = []
    map_with_path(lambda path, _: names.append(path), params)
    n_m = sum(kind == "mlstm" for kind in cfg.layer_pattern)
    n_s = sum(kind == "slstm" for kind in cfg.layer_pattern)

    # one train step with the kernels against the same step on the plain
    # path: the loss, every grad leaf, the launches forward and backward
    runs = {}
    for impl in ("hopper", "plain"):
        model = Model(cfg, kernel_impl=impl)
        leafs = tree_map(lambda p: p.detach().requires_grad_(True), params)
        MK.launches = SK.launches = 0
        loss, _ = model.loss(leafs, batch)
        torch.cuda.synchronize()
        fwd = {"mlstm_scan": MK.launches, "slstm_scan": SK.launches}
        grads = torch.autograd.grad(loss, list(leaves(leafs)))
        torch.cuda.synchronize()
        bwd = {"mlstm_scan": MK.launches - fwd["mlstm_scan"],
               "slstm_scan": SK.launches - fwd["slstm_scan"]}
        runs[impl] = (loss.item(), grads, fwd, bwd)
        del leafs, loss
    k_loss, k_grads, fwd, bwd = runs["hopper"]
    p_loss, p_grads, p_fwd, _ = runs.pop("plain")
    print(f"train step (B,S)={(B_, S_)} launches with the kernels: forward "
          f"{fwd}, backward {bwd}; plain path: forward {p_fwd}")
    check(fwd == {"mlstm_scan": n_m, "slstm_scan": n_s}
          and bwd == {"mlstm_scan": 0, "slstm_scan": 0},
          f"a train step must launch mlstm_scan {n_m}x and slstm_scan "
          f"{n_s}x in the forward and nothing in the backward")
    check(p_fwd == {"mlstm_scan": 0, "slstm_scan": 0},
          "the plain path launches no kernel")
    rel = abs(k_loss - p_loss) / abs(p_loss)
    ok = np.isfinite(k_loss) and rel <= TOL_TRAIN_LOSS_REL
    print(f"train step loss, kernels vs plain: {k_loss:.6f} vs {p_loss:.6f}, "
          f"relative {rel:.3e} (tolerance {TOL_TRAIN_LOSS_REL}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the train step's loss with the kernels disagrees with the "
              "plain path")
    p_by = dict(zip(names, p_grads))
    scale_of = mlstm_b_i_scales(cfg, names)
    errs = []
    for name, g, w in zip(names, k_grads, p_grads):
        diff = (g - w).abs().max().item()
        own = w.abs().max().item()
        scale = p_by[scale_of.get(name, name)].abs().max().item()
        errs.append((diff / max(scale, 1e-30), name, diff, own, scale))
    errs.sort(reverse=True)
    worst = errs[0]
    ok = all(torch.isfinite(g).all() for g in k_grads) and \
        worst[0] <= TOL_TRAIN_GRAD_REL
    print(f"train step grads, kernels vs plain, {len(names)} leaves: worst "
          f"{worst[1]}, max abs diff {worst[2]:.3e} over its scale "
          f"{worst[4]:.3e} = {worst[0]:.3e} (tolerance "
          f"{TOL_TRAIN_GRAD_REL}) {'ok' if ok else 'FAIL'}")
    for r, name, diff, own, scale in errs[1:4]:
        print(f"  next: {name} {r:.3e}")
    for r, name, diff, own, scale in errs:
        if name in scale_of:
            print(f"  {name}: max abs diff {diff:.3e}, {diff / own:.3e} of "
                  f"its own largest grad {own:.3e}, {r:.3e} of "
                  f"{scale_of[name].split('/')[-1]}'s {scale:.3e}")
    check(ok, "the train step's grads with the kernels disagree with the "
              "plain path")
    # yardstick for that limit: the plain path's grads with the embedding
    # table moved by one ulp, i.e. how far rounding alone carries them
    leafs = tree_map(lambda p: p.detach().requires_grad_(True),
                     one_ulp_moved(params))
    loss, _ = Model(cfg, kernel_impl="plain").loss(leafs, batch)
    y_grads = torch.autograd.grad(loss, list(leaves(leafs)))
    y_worst = max(((g - w).abs().max().item()
                   / max(p_by[scale_of.get(name, name)].abs().max().item(),
                         1e-30), name)
                  for name, g, w in zip(names, y_grads, p_grads))
    print(f"  yardstick: plain path with the embeddings moved by 1 ulp, "
          f"worst {y_worst[1]} {y_worst[0]:.3e}")
    del runs, k_grads, p_grads, p_by, leafs, loss, y_grads

    # the Trainer for 4 steps, kernels and plain from the same params
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    rc.plan("threads", workers=2)
    curves = {}
    with tempfile.TemporaryDirectory() as ckdir:
        for run in ("hopper", "plain", "plain, embeddings moved by 1 ulp"):
            impl = run.split(",")[0]
            trainer = Trainer(cfg, TrainerConfig(
                steps=TRAIN_STEPS, batch=B_, seq=S_, seed=SEED, log_every=1,
                ckpt_every=2, ckpt_dir=ckdir if run == "hopper" else None,
                device=dev, kernel_impl=impl), opt)
            state, _ = trainer.init_or_restore()
            if run != impl:
                table = state.params["embed"]["table"]
                state.params["embed"] = {"table": table * (1 + 2 ** -23)}
            MK.launches = SK.launches = 0
            t0 = time.perf_counter()
            state, history = trainer.run(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            curves[run] = [h["loss"] for h in history]
            print(f"Trainer, {run}: {TRAIN_STEPS} steps in {wall:.2f} s, "
                  f"losses {curves[run]}, launches mlstm_scan "
                  f"{MK.launches}, slstm_scan {SK.launches}")
            if run == "hopper":
                check((MK.launches, SK.launches)
                      == (TRAIN_STEPS * n_m, TRAIN_STEPS * n_s),
                      "the Trainer's steps launch the kernels")
                kept = sorted(os.listdir(ckdir))
                check(kept == ["step_00000002", "step_00000004"],
                      f"checkpoints at steps 2 and 4, found {kept}")
                template = init_train_state(Model(cfg).init(
                    torch.Generator(device=dev).manual_seed(SEED + 1),
                    device=dev))
                restored, step = trainer.ckpt.restore(template, 4)
                same = step == 4 and all(
                    a.dtype == b.dtype and a.device == b.device
                    and torch.equal(a, b)
                    for a, b in zip(leaves(restored), leaves(state)))
                print(f"  checkpoint of step 4 restored into a fresh "
                      f"template: params, m, v and step bit for bit "
                      f"{'ok' if same else 'FAIL'}")
                check(same, "the step-4 checkpoint restores the live state")
                del restored, template
            del trainer, state
    rc.shutdown()
    k_c, p_c = np.array(curves["hopper"]), np.array(curves["plain"])
    rel = np.abs(k_c - p_c) / np.abs(p_c)
    y_rel = np.abs(np.array(curves["plain, embeddings moved by 1 ulp"])
                   - p_c) / np.abs(p_c)
    ok = bool(np.isfinite(k_c).all() and np.isfinite(p_c).all()
              and (rel <= TOL_TRAIN_CURVE_REL).all())
    print(f"Trainer loss curves at lr {TRAIN_LR}, kernels vs plain, "
          f"relative per step {[float(f'{r:.3e}') for r in rel]} (tolerance "
          f"{TOL_TRAIN_CURVE_REL}) {'ok' if ok else 'FAIL'}; yardstick, "
          f"plain moved by 1 ulp: {[float(f'{r:.3e}') for r in y_rel]}")
    check(ok, "the Trainer's loss curve with the kernels disagrees with the "
              "plain path")

    # times: CUDA events, a warm-up step first
    state0 = init_train_state(params)

    def split_step(model):
        """The train step's parts as make_train_step runs them, timed:
        (forward with loss ms, backward and optimiser ms)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        leafs = tree_map(lambda p: p.detach().requires_grad_(True),
                         state0.params)
        loss, _ = model.loss(leafs, batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(leaves(leafs)))
        it = iter(grads)
        grads = tree_map(lambda _: next(it), leafs)
        adamw.apply_updates(opt, state0.params, grads, state0.opt)
        ev[2].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    times = {}
    for impl in ("hopper", "plain"):
        model = Model(cfg, kernel_impl=impl)
        step_fn = make_train_step(model, opt)
        torch.cuda.reset_peak_memory_stats()
        step_fn(state0, batch)                      # warm-up
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        iters = 3
        ms = cuda_ms(lambda: step_fn(state0, batch), iters, warmup=0)
        parts = [split_step(model) for _ in range(iters)]
        fwd_ms = sum(p[0] for p in parts) / iters
        bwd_ms = sum(p[1] for p in parts) / iters
        times[impl] = (ms, fwd_ms, bwd_ms)
        print(f"train step (B,S)={(B_, S_)}, {impl}: {ms:.1f} ms "
              f"({B_ * S_ / ms * 1e3:.0f} tokens/s); forward with loss "
              f"{fwd_ms:.1f} ms, backward and optimiser {bwd_ms:.1f} ms; "
              f"peak memory {peak / 1e9:.2f} GB ({smi})")

    # the share of the kernels' backward spent in the recompute through
    # each plain version, at the train step's shapes
    H, D = cfg.xlstm.n_heads, cfg.xlstm.head_dim
    NH, HD = cfg.xlstm.n_heads, cfg.d_model // cfg.xlstm.n_heads
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def rand(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + shift).requires_grad_(True)

    cases = {
        "mlstm_scan": (MK, n_m, [rand(B_, H, S_, D) for _ in range(3)]
                       + [rand(B_, H, S_), rand(B_, H, S_, shift=2.0)]),
        "slstm_scan": (SK, n_s, [rand(B_, NH, S_, HD) for _ in range(4)]
                       + [rand(NH, HD, HD, scale=HD ** -0.5)
                          for _ in range(4)])}
    recompute_ms = 0.0
    for name, (mod, count, args) in cases.items():
        out = getattr(mod, name)(*args)
        g = torch.randn(out.shape, generator=gen, device=dev)
        ms = cuda_ms(lambda: torch.autograd.grad(out, args, g,
                                                 retain_graph=True), 2)
        recompute_ms += count * ms
        print(f"  {name} backward (recompute through the plain version and "
              f"its autograd) at {tuple(args[0].shape)}: {ms:.2f} ms a "
              f"call, {count} calls a step = {count * ms:.1f} ms, "
              f"{count * ms / times['hopper'][2]:.3f} of the kernel step's "
              f"backward and optimiser ({smi})")
        del out, g, args
    print(f"  recompute share of the kernel step's backward and optimiser: "
          f"{recompute_ms / times['hopper'][2]:.3f} "
          f"({recompute_ms:.1f} of {times['hopper'][2]:.1f} ms)")
    del state0, batch
    gc.collect()
    torch.cuda.empty_cache()


def _close(name: str, got, want, tol: float) -> float:
    """Max abs error, printed and checked as rtol=atol=tol."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all())
    print(f"  {name}: max abs err {err.max().item():.3e} on values up to "
          f"{want.abs().max().item():.3e} (tolerance rtol=atol={tol}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: the kernel disagrees with its plain version")
    return err.max().item()


def future_api_phase(dev, cfg, params, prefill, tokens, first,
                     prefill_ms: float, smi: str) -> None:
    """Phase 6: the xLSTM prefill driven through the port's Future API on
    the card — one prefill as a cuda_async future, the same future_map on
    the four backends, a stream pipeline, and the shared state."""
    import torch

    import repro_torch.core as rc
    from repro_torch.core import state
    from repro_torch.kernels import mlstm_scan as MK
    from repro_torch.kernels import slstm_scan as SK
    from repro_torch.tree import leaves

    n_m = sum(kind == "mlstm" for kind in cfg.layer_pattern)
    n_s = sum(kind == "slstm" for kind in cfg.layer_pattern)

    def launches():
        return {"mlstm_scan": MK.launches, "slstm_scan": SK.launches}

    # 1. one prefill (B=8, S=2048) as a future under plan("cuda_async")
    batch = {"tokens": tokens}
    rc.plan("cuda_async")
    direct = []
    for _ in range(3):              # the direct call on the host's clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        direct.append((time.perf_counter() - t0) * 1e3)
    overheads = []
    for i in range(3):
        torch.cuda.synchronize()
        MK.launches = SK.launches = 0
        t0 = time.perf_counter()
        f = rc.future(lambda: prefill(params, batch))
        submit_ms = (time.perf_counter() - t0) * 1e3
        at_submit = rc.resolved(f)
        got = rc.value(f)
        value_ms = (time.perf_counter() - t0) * 1e3
        counts = launches()
        print(f"cuda_async prefill future {i} (B,S)={(B, S)}: future() "
              f"returned in {submit_ms:.3f} ms, resolved() then "
              f"{at_submit}, value() at {value_ms:.3f} ms; direct call "
              f"{direct[i]:.3f} ms on the host's clock, {prefill_ms:.3f} ms "
              f"by events in phase 3; launches {counts}")
        check(counts == {"mlstm_scan": n_m, "slstm_scan": n_s},
              f"the prefill future launches mlstm_scan {n_m}x and "
              f"slstm_scan {n_s}x")
        check(torch.equal(got, first),
              "the cuda_async prefill's tokens are phase 3's bit for bit")
        overheads.append(value_ms - direct[i])
    print(f"  Future layer overhead, value() against the direct call: "
          f"{', '.join(f'{o:.3f}' for o in overheads)} ms ({smi})")
    del got, f

    # the watcher parks in event.synchronize(): the main thread keeps
    # running Python meanwhile (the GIL is released)
    f = rc.future(lambda: torch.cuda._sleep(600_000_000))
    fired = threading.Event()
    rc.active_backend().add_done_callback(f._handle, lambda h: fired.set())
    gaps, last, n = [], time.perf_counter(), 0
    while not fired.is_set():
        now = time.perf_counter()
        gaps.append(now - last)
        last, n = now, n + 1
    print(f"  watcher waiting on ~0.3 s of device work: the main thread ran "
          f"{n} loop iterations, longest gap {max(gaps) * 1e3:.3f} ms")
    check(max(gaps) < 0.05 and n > 1000,
          "the main thread runs Python while a watcher waits")
    rc.value(f)
    rc.shutdown()

    # 2. the same future_map on every backend: 4 batches of B=2, S=2048
    rng6 = np.random.default_rng(SEED)
    batches = [{"tokens": torch.from_numpy(rng6.integers(
        0, cfg.vocab_size, size=(2, S))).to(dev)} for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        prefill(params, b)
    torch.cuda.synchronize()
    print(f"future_map of the prefill over 4 batches (B,S)={(2, S)}; four "
          f"direct calls take {(time.perf_counter() - t0) * 1e3:.3f} ms")
    maps = {}
    for name, kw in (("sequential", {}), ("threads", {"workers": 2}),
                     ("cuda_async", {}), ("asyncio", {})):
        rc.plan(name, **kw)
        rc.value(rc.future(lambda: None))      # start the backend's thread
        torch.cuda.synchronize()
        MK.launches = SK.launches = 0
        t0 = time.perf_counter()
        toks = rc.future_map(lambda b: prefill(params, b), batches)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = launches()
        rc.shutdown()
        maps[name] = toks
        same = all(torch.equal(a, b)
                   for a, b in zip(toks, maps["sequential"]))
        print(f"  {name}: {wall:.3f} ms, launches {counts}, tokens bit for "
              f"bit the sequential ones: {same}")
        check(counts == {"mlstm_scan": 4 * n_m, "slstm_scan": 4 * n_s},
              f"future_map on {name} launches each kernel once a block a "
              f"batch")
        check(len(toks) == 4 and same,
              f"future_map on {name} gives the sequential tokens")

    # 3. a stream pipeline under cuda_async, at most 2 in flight
    rc.plan("cuda_async")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = rc.stream(batches, max_in_flight=2)
    toks = s.map(lambda b: prefill(params, b)).collect()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rc.shutdown()
    same = all(torch.equal(a, b) for a, b in zip(toks, maps["sequential"]))
    print(f"stream(batches, max_in_flight=2).map(prefill).collect() under "
          f"cuda_async: {wall:.3f} ms, peak_in_flight "
          f"{s.stats['peak_in_flight']}, {s.stats['dispatched']} chunks, "
          f"tokens equal the map's: {same}")
    check(len(toks) == 4 and same and s.stats["peak_in_flight"] <= 2,
          "the stream gives the map's tokens within its in-flight bound")

    # 4. shared state: an exact fold from 8 futures, and the live params
    rc.plan("threads", workers=4)
    state.reset()
    fs = [rc.future(lambda: state.add("tokens", 2 * S)) for _ in range(8)]
    rc.value(fs)
    folded = state.read("tokens")
    print(f"state.add from 8 futures on threads: {folded} "
          f"(value, version); want ({8 * 2 * S}, 8)")
    check(folded == (8 * 2 * S, 8), "the state fold is exact")
    state.put("params", params)
    live = rc.value(rc.future(lambda: state.get("params")))
    print(f"state.get('params') is the live dict of "
          f"{sum(p.numel() for p in leaves(params)) / 1e6:.1f} M "
          f"parameters, on the driver and in a future: "
          f"{state.get('params') is params and live is params}")
    check(state.get("params") is params and live is params,
          "state.get returns the live params")
    state.reset()
    rc.shutdown()
    del maps, toks, batches, live


def kernel_modules() -> dict:
    """Each kernel's wrapper module, whose ``launches`` counts its kernel's
    launches, by kernel name."""
    from repro_torch.kernels import decode_attention as DK
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import mlstm_scan as MK
    from repro_torch.kernels import rglru_scan as RK
    from repro_torch.kernels import slstm_scan as SK
    return {"mlstm_scan": MK, "slstm_scan": SK, "rglru_scan": RK,
            "flash_attention": FK, "decode_attention": DK}


def zero_counts() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in kernel_modules().items()}


def recurrentgemma_phases(dev, rng, kernels: dict) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as DK
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import rglru_scan as RK
    from repro_torch.models import Model
    from repro_torch.serve import Server
    from repro_torch.train import make_prefill_step

    counters = kernel_modules()

    def randn(*shape, scale=1.0, shift=0.0):
        a = rng.standard_normal(shape, dtype=np.float32) * scale + shift
        return torch.from_numpy(a).to(dev)

    cfg = get_arch("recurrentgemma-9b")
    W, H, KV, HD = cfg.rglru.lru_width, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    win = cfg.attn_window

    # -- 2b. the RecurrentGemma kernels against their plain versions ---------
    print(f"recurrentgemma-9b kernels at full width (S={RG_S}, W={W}, H={H}, "
          f"KV={KV}, D={HD}, window {win}):")
    x = randn(1, RG_S, W)
    ag, ig = torch.sigmoid(randn(1, RG_S, W)), torch.sigmoid(randn(1, RG_S, W))
    lam = randn(W, shift=3.0)
    h0 = randn(1, W)
    rgeo = RK.launch_geometry(1, RG_S, W, device=dev)
    print(f"  rglru_scan geometry: a stripe of {rgeo.stripe} channels a CTA, "
          f"tiles of {rgeo.tile} steps in a ring of {rgeo.stages} stages, "
          f"{rgeo.ctas} CTAs x {rgeo.threads} threads, {rgeo.ctas_per_sm} "
          f"CTA(s) per SM on {rgeo.n_sms} SMs, {rgeo.waves} wave(s), "
          f"{rgeo.smem_bytes} B of shared memory a CTA, "
          f"{rgeo.in_flight_per_sm} B in flight a SM, {rgeo.hbm_bytes} B "
          f"through HBM, {16 if rgeo.vec else 4}-byte copies")
    errs = []
    for label, init in (("zero state", None), ("h0", h0)):
        y, hl = RK.rglru_scan(x, ag, ig, lam, init)
        torch.cuda.synchronize()
        check(RK.last_launch() == rgeo.plan,
              f"rglru_scan launched {RK.last_launch()}, its geometry says "
              f"{rgeo.plan}")
        yp, hp = RK.plain(x, ag, ig, lam, init)
        errs.append(_close(f"rglru_scan (B,S,W)={(1, RG_S, W)}, {label}, y",
                           y, yp, TOL_RGLRU))
        errs.append(_close(f"rglru_scan {label}, h_last", hl, hp, TOL_RGLRU))
    del y, hl, yp, hp
    # the decode step's shape, and rows that are not 16-byte aligned, drawn
    # from a generator of their own so that the later phases see the same
    # numbers as before these checks existed
    extra = np.random.default_rng(SEED + 1)

    def extra_randn(*shape, shift=0.0):
        a = extra.standard_normal(shape, dtype=np.float32) + shift
        return torch.from_numpy(a).to(dev)

    for b_, s_, w_ in ((RG_DEC_B, 1, W), (2, 65, 203)):
        args = (extra_randn(b_, s_, w_),
                torch.sigmoid(extra_randn(b_, s_, w_)),
                torch.sigmoid(extra_randn(b_, s_, w_)),
                extra_randn(w_, shift=3.0), extra_randn(b_, w_))
        y, hl = RK.rglru_scan(*args)
        torch.cuda.synchronize()
        want = RK.launch_geometry(b_, s_, w_, with_h0=True, device=dev)
        check(RK.last_launch() == want.plan,
              f"rglru_scan launched {RK.last_launch()} at {(b_, s_, w_)}, "
              f"its geometry says {want.plan}")
        yp, hp = RK.plain(*args)
        errs.append(_close(f"rglru_scan (B,S,W)={(b_, s_, w_)}, h0, "
                           f"{16 if want.vec else 4}-byte copies, y", y, yp,
                           TOL_RGLRU))
        errs.append(_close(f"rglru_scan {(b_, s_, w_)}, h_last", hl, hp,
                           TOL_RGLRU))
        if s_ == 1:
            dargs = args                  # the decode step's, timed below
    n_el = RG_S * W
    y_out = torch.empty_like(x)
    kernels["rglru_scan"] = dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:25",
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: RK.rglru_scan(x, ag, ig, lam), 20),
        graph_ms=graph_ms(lambda: RK.rglru_scan(x, ag, ig, lam), 20),
        stream_ms=graph_ms(lambda: torch.addcmul(x, ag, ig, out=y_out), 20),
        plain_ms=cuda_ms(lambda: RK.plain(x, ag, ig, lam), 5),
        library_ms=None)
    # per element: 3 inputs read, y written; ~10 flops of gate algebra and
    # recurrence; lambda read and h_last written once per channel
    kr = kernels["rglru_scan"]
    kr["bound_ms"], kr["bound_by"] = bound(10.0 * n_el, rgeo.hbm_bytes)
    print(f"  rglru_scan (B,S,W)={(1, RG_S, W)}: kernel {kr['ms']:.4f} ms by "
          f"events, {kr['graph_ms']:.4f} ms by graph replay, "
          f"{rgeo.hbm_bytes / kr['graph_ms'] / 1e9:.3f} TB/s; byte "
          f"yardstick torch.addcmul(x, a_gate, i_gate) "
          f"{kr['stream_ms']:.4f} ms by graph replay, "
          f"{16 * n_el / kr['stream_ms'] / 1e9:.3f} TB/s; bound "
          f"{kr['bound_ms']:.4f} ms ({kr['bound_by']})")
    dgeo = RK.launch_geometry(RG_DEC_B, 1, W, with_h0=True, device=dev)
    d_ms = cuda_ms(lambda: RK.rglru_scan(*dargs), 100)
    d_graph = graph_ms(lambda: RK.rglru_scan(*dargs), 100)
    print(f"  rglru_scan decode step (B,S,W)={(RG_DEC_B, 1, W)}, h0: "
          f"{dgeo.ctas} CTAs x {dgeo.threads} threads, {dgeo.smem_bytes} B "
          f"of shared memory a CTA; kernel {d_ms:.4f} ms by events, "
          f"{d_graph:.4f} ms by graph replay; bound "
          f"{bound(10.0 * RG_DEC_B * W, dgeo.hbm_bytes)[0]:.4f} ms (bytes)")
    del x, ag, ig, lam, h0, y, hl, yp, hp, y_out, args, dargs

    # q, k, v as the model holds them: (B,S,H,D) projections viewed as
    # (B,H,S,D)
    q = randn(1, RG_S, H, HD).transpose(1, 2)
    k = randn(1, RG_S, KV, HD).transpose(1, 2)
    v = randn(1, RG_S, KV, HD).transpose(1, 2)
    fgeo = FK.launch_geometry(1, H, KV, RG_S, RG_S, HD, True, win)
    print(f"  flash_attention geometry: {fgeo.rows} query rows a CTA, "
          f"{fgeo.ctas} CTAs x {fgeo.threads} threads, {fgeo.ctas_per_sm} "
          f"CTA(s) per SM on {fgeo.n_sms} SMs, {fgeo.waves} wave(s), "
          f"{fgeo.smem_bytes} B of shared memory a CTA; {fgeo.key_rows} K "
          f"and as many V rows, {fgeo.l2_bytes} B, read from L2")
    out = FK.flash_attention(q, k, v, causal=True, window=win)
    torch.cuda.synchronize()
    ref = FK.plain(q, k, v, causal=True, window=win)
    err = _close(f"flash_attention (B,H,S,D)={(1, H, RG_S, HD)}, KV={KV}, "
                 f"causal, window {win}", out, ref, TOL_ATTN["float32"])
    del out, ref
    pos = torch.arange(RG_S, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)
    pairs = int(mask.sum())               # visible (q, k) pairs per head
    kernels["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:28",
        max_abs_err=err,
        ms=cuda_ms(lambda: FK.flash_attention(q, k, v, causal=True,
                                              window=win), 5),
        plain_ms=cuda_ms(lambda: FK.plain(q, k, v, causal=True, window=win),
                         2),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), 5))
    # the kernel's route: each fp32 product as three TF32 MMAs (3xTF32)
    flops, nbytes = 4.0 * HD * pairs * H, 4.0 * (2 * H + 2 * KV) * RG_S * HD
    fp32_ms, fp32_by = bound(flops, nbytes)
    kernels["flash_attention"]["bound_ms"], \
        kernels["flash_attention"]["bound_by"] = bound(3 * flops, nbytes,
                                                       PEAK_TF32_FLOPS)
    print(f"  flash_attention: {pairs} visible (q, k) pairs per head, "
          f"{flops / 1e9:.1f} GFLOP; bound as fp32 SIMT {fp32_ms:.4f} ms "
          f"({fp32_by}), as 3xTF32 on tensor cores "
          f"{kernels['flash_attention']['bound_ms']:.4f} ms "
          f"({kernels['flash_attention']['bound_by']})")
    del q, k, v, mask

    lengths = torch.tensor(RG_DEC_LENGTHS, dtype=torch.int32, device=dev)
    q = randn(RG_DEC_B, H, HD)
    kc, vc = randn(RG_DEC_B, win, KV, HD), randn(RG_DEC_B, win, KV, HD)
    # one cache for each attention layer of a decode step (201 MB in fp32,
    # more than the 50 MB L2), so that each call finds its cache cold, as a
    # step between weight GEMMs does; drawn by a generator of their own
    n_a = sum(kind == "lattn" for kind in cfg.layer_pattern)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    layer_caches = [tuple(torch.randn(RG_DEC_B, win, KV, HD, generator=gen,
                                      device=dev) for _ in range(2))
                    for _ in range(n_a)]
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        kd, vd = kc.to(tdt), vc.to(tdt)
        caches = [(a.to(tdt), b.to(tdt)) for a, b in layer_caches]
        geo = DK.launch_geometry(RG_DEC_B, H, KV, win, HD, tdt,
                                 RG_DEC_LENGTHS)
        print(f"  decode_attention geometry, {dtype} cache: chunks of "
              f"{geo.ch} positions, {geo.ctas} split CTAs x {geo.threads} "
              f"threads ({geo.ctas_with_work} with work for lengths "
              f"{RG_DEC_LENGTHS}), {geo.ctas_per_sm} CTA(s) per SM by shared "
              f"memory on {geo.n_sms} SMs, {geo.waves} wave(s), "
              f"{geo.smem_bytes} B of shared memory a CTA, "
              f"{geo.in_flight_per_sm} B in flight a SM, "
              f"{geo.partial_bytes} B of partials, {geo.hbm_bytes} B through "
              f"HBM, {16 if geo.vec else 8}-byte copies, "
              f"{geo.combine_ctas} combine CTAs")
        out = DK.decode_attention(q, kd, vd, lengths)
        torch.cuda.synchronize()
        check(DK.last_launch() == geo.plan,
              f"decode_attention launched {DK.last_launch()}, its geometry "
              f"says {geo.plan}")
        err = _close(f"decode_attention (B,S,KV,D)="
                     f"{(RG_DEC_B, win, KV, HD)} {dtype} cache, lengths "
                     f"{RG_DEC_LENGTHS}", out, DK.plain(q, kd, vd, lengths),
                     TOL_ATTN[dtype])

        def warm():
            DK.decode_attention(q, kd, vd, lengths)

        def cold():
            for kk, vv in caches:
                DK.decode_attention(q, kk, vv, lengths)

        ms = cuda_ms(warm, 50)
        plain_ms = cuda_ms(lambda: DK.plain(q, kd, vd, lengths), 10)
        g_ms, cold_ms = graph_ms(warm, 100), graph_ms(cold, 10) / n_a
        b_ms, b_by = bound(4.0 * geo.kv * sum(geo.valid(i)
                                              for i in range(geo.b))
                           * geo.g * HD, geo.hbm_bytes)
        print(f"  decode_attention {dtype} cache: kernel {ms:.4f} ms by "
              f"events; by graph replay warm (one cache) {g_ms:.4f} ms, "
              f"cold ({n_a} caches in turn) {cold_ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if dtype == "float32":       # the Server's cache type
            kmask = (torch.arange(win, device=dev)[None, :]
                     < lengths[:, None])[:, None, None, :]
            kernels["decode_attention"] = dict(
                name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:27",
                max_abs_err=err, ms=ms, graph_ms=g_ms,
                cold_graph_ms=cold_ms, plain_ms=plain_ms,
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
                    attn_mask=kmask, enable_gqa=True), 50),
                bound_ms=b_ms, bound_by=b_by)
    del q, kc, vc, kd, vd, out, caches, layer_caches
    for name in ("rglru_scan", "flash_attention", "decode_attention"):
        kr = kernels[name]
        graph = f" ({kr['graph_ms']:.4f} by graph replay)" \
            if "graph_ms" in kr else ""
        if "cold_graph_ms" in kr:
            graph = (f" ({kr['graph_ms']:.4f} warm, {kr['cold_graph_ms']:.4f} "
                     f"cold by graph replay)")
        print(f"  {name}: kernel {kr['ms']:.4f} ms{graph}, plain "
              f"{kr['plain_ms']:.4f} ms, bound {kr['bound_ms']:.4f} ms "
              f"({kr['bound_by']}), library {kr['library_ms']}")
    phase_done("2b")

    # -- 3b. the prefill step at full width ----------------------------------
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    print(f"recurrentgemma-9b: {model.param_count() / 1e9:.3f} B parameters "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(1, RG_S))).to(dev)
    prefill = make_prefill_step(model)
    n_r = sum(kind == "rglru" for kind in cfg.layer_pattern)
    n_a = sum(kind == "lattn" for kind in cfg.layer_pattern)
    zero_counts()
    first = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"prefill launches: {launches}")
    check(launches == dict.fromkeys(counters, 0) | {"rglru_scan": n_r,
                                                    "flash_attention": n_a},
          f"prefill must launch rglru_scan {n_r}x and flash_attention "
          f"{n_a}x and nothing else")
    check(tuple(first.shape) == (1, 1) and first.dtype == torch.int32,
          "prefill returns (1, 1) int32 tokens")
    kernels["rglru_scan"]["launches"] = launches["rglru_scan"]
    kernels["flash_attention"]["launches"] = launches["flash_attention"]
    ms = cuda_ms(lambda: prefill(params, {"tokens": tokens}), 2)
    print(f"prefill (B,S)={(1, RG_S)}: {ms:.1f} ms, "
          f"{RG_S / ms * 1e3:.0f} tokens/s")
    # the plain path sums its attention in fp64 (rounded back to fp32 at
    # each layer's output): a reference whose result no row blocking or
    # GEMM order of the plain flash version moves, since this check sits
    # near its limit (ROADMAP note R2)
    plain = Model(cfg, kernel_impl="plain")
    with torch.no_grad():
        # clones, so the 4.2 GB logits of each run are freed
        got = model.apply(params, {"tokens": tokens})[0][:, -1].clone()
        with WidenedFlash(torch.float64):
            want = plain.apply(params, {"tokens": tokens})[0][:, -1].clone()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    ok = bool(torch.isfinite(got).all()) and rel <= TOL_PREFILL_REL \
        and got.abs().max().item() <= cfg.logits_softcap
    print(f"prefill last-position logits, kernels vs plain (attention in "
          f"fp64): max abs diff {(got - want).abs().max().item():.3e}, "
          f"relative {rel:.3e} (tolerance {TOL_PREFILL_REL}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "prefill with the kernels disagrees with the plain path")
    # yardstick for that tolerance: the plain path against itself with the
    # embedding table moved by one or two ulps, i.e. how far 38 random fp32
    # layers carry a rounding difference on their own
    with torch.no_grad(), WidenedFlash(torch.float64):
        alt = plain.apply(one_ulp_moved(params),
                          {"tokens": tokens})[0][:, -1].clone()
    moved_rel = ((alt - want).abs().max() / want.abs().max()).item()
    print(f"  yardstick: plain path with the embeddings moved by 1-2 ulps, "
          f"relative {moved_rel:.3e}")
    del alt
    print(f"peak device memory so far: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del got, want, first
    torch.cuda.empty_cache()
    phase_done("3b")

    # -- 4b. the Server at full width ----------------------------------------
    server = Server("recurrentgemma-9b", smoke=False, slots=4, max_new=16,
                    device=dev, params=params)
    replies, long_prompt = serve_traffic(server, rng, cfg.vocab_size)

    # one decode step at B=4 with every local-attention ring buffer full
    step = server.step
    cache = model.init_cache(RG_DEC_B, max_seq=2 * win, device=dev,
                             dtype=torch.float32)
    for stage in cache:
        for block in stage.values():
            if "pos" in block:
                block["pos"].fill_(2 * win)
    tok = torch.zeros(RG_DEC_B, 1, dtype=torch.int64, device=dev)
    zero_counts()
    step(params, cache, tok)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"decode step launches: {launches}")
    check(launches == dict.fromkeys(counters, 0) | {"rglru_scan": n_r,
                                                    "decode_attention": n_a},
          f"a decode step must launch rglru_scan {n_r}x and "
          f"decode_attention {n_a}x and nothing else")
    kernels["decode_attention"]["launches"] = launches["decode_attention"]
    ms = cuda_ms(lambda: step(params, cache, tok), 16)
    print(f"decode step (B={RG_DEC_B}, window full): {ms:.2f} ms, "
          f"{RG_DEC_B / ms * 1e3:.0f} tokens/s")
    del cache

    hold_long_request(model, params, long_prompt, replies[6][0],
                      model.init_cache(1, max_seq=len(long_prompt),
                                       device=dev, dtype=torch.float32))
    phase_done("4b")


def flash_case(dev, randn, h, kv, s, hd, smi: str,
               dtype: str = "float32", b: int = 1,
               causal: bool = True) -> dict:
    """Flash attention at a prefill's shape (B=``b``, causal or not, no
    window), q, k and v of ``dtype`` drawn by ``randn`` as the model holds
    them ((B,S,H,D) viewed as (B,H,S,D)): the launch against its geometry,
    the error, the kernel's, the plain version's and one library call's
    times, both bounds; in bf16 also the kernel against the fp32 kernel on
    the widened inputs, within ``bf16_limit`` (``hold_flash_bf16``).
    Returns a kernel entry without its name and launches."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FK
    tdt = getattr(torch, dtype)
    q = randn(b, s, h, hd).to(tdt).transpose(1, 2)
    k = randn(b, s, kv, hd).to(tdt).transpose(1, 2)
    v = randn(b, s, kv, hd).to(tdt).transpose(1, 2)
    fgeo = FK.launch_geometry(b, h, kv, s, s, hd, causal, None, dtype=tdt)
    print(f"  flash_attention geometry ({dtype}): {fgeo.rows} query rows a "
          f"CTA, {fgeo.ctas} CTAs x {fgeo.threads} threads, {fgeo.ctas_per_sm} "
          f"CTA(s) per SM on {fgeo.n_sms} SMs, {fgeo.waves} wave(s), "
          f"{fgeo.smem_bytes} B of shared memory a CTA, tiles in the order "
          f"{fgeo.order[:3]}...; {fgeo.key_rows} K and as many V rows, "
          f"{fgeo.l2_bytes} B, read from L2")
    out = FK.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    check(FK.last_launch() == fgeo.plan,
          f"flash_attention launched {FK.last_launch()}, its geometry says "
          f"{fgeo.plan}")
    shape = f"(B,H,S,D)={(b, h, s, hd)}, KV={kv}"
    mask = "causal" if causal else "non-causal"
    ref = FK.plain(q, k, v, causal=causal)
    err = _close(f"flash_attention {shape}, {dtype}, {mask}, no window",
                 out, ref, TOL_ATTN[dtype])
    if dtype != "float32":
        # the fp32 kernel on the widened inputs: held against the plain
        # version at fp32's tolerance, then the bf16 kernel against it
        qf, kf, vf = q.float(), k.float(), v.float()
        wide = FK.flash_attention(qf, kf, vf, causal=causal)
        _close(f"flash_attention {shape}, float32 on the widened inputs",
               wide, FK.plain(qf, kf, vf, causal=causal),
               TOL_ATTN["float32"])
        hold_flash_bf16(out, wide, v)
        # the control, printed without a limit: the same arithmetic with P
        # rounded once to bf16, as a route on one bf16 PV product keeps it
        one = FK.flash_attention_bf16_2part(q, k, v, causal=causal,
                                            parts=1)
        share = ((one.float() - wide).abs()
                 / FK.bf16_limit(wide, v)).max().item()
        print(f"  control, P as one bf16 part (plain PyTorch on the same "
              f"inputs): largest share of the limit {share:.4f}")
        del qf, kf, vf, wide, one
    del out, ref
    # visible (q, k) pairs per head
    pairs = s * (s + 1) // 2 if causal else s * s
    el = q.element_size()
    flops = 4.0 * hd * pairs * h * b
    nbytes = el * (2 * h + 2 * kv) * s * hd * b
    fp32_ms, fp32_by = bound(flops, nbytes)
    fa = dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:28",
        max_abs_err=err,
        ms=cuda_ms(lambda: FK.flash_attention(q, k, v, causal=causal), 5),
        plain_ms=cuda_ms(lambda: FK.plain(q, k, v, causal=causal), 2),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), 5))
    if dtype == "float32":
        fa["bound_ms"], fa["bound_by"] = bound(3 * flops, nbytes,
                                               PEAK_TF32_FLOPS)
        route = "as 3xTF32 on tensor cores"
    else:
        # bf16 operands multiply exactly on the tensor cores at the bf16
        # rate; the kernel's route (QK^T one bf16 product, PV two for P's
        # two parts, so 1.5x the flops at the bf16 rate) is printed beside
        # it as a note
        fa["bound_ms"], fa["bound_by"] = bound(flops, nbytes,
                                               PEAK_BF16_FLOPS)
        route_ms, _ = bound(1.5 * flops, nbytes, PEAK_BF16_FLOPS)
        route = (f"its route (1 + 2 bf16 products) {route_ms:.4f} ms; the "
                 f"bound, as bf16 on tensor cores at "
                 f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s,")
    print(f"  flash_attention: {pairs} visible (q, k) pairs per head, "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; kernel "
          f"{fa['ms']:.4f} ms, plain {fa['plain_ms']:.4f} ms, library "
          f"(scaled_dot_product_attention, is_causal={causal}) "
          f"{fa['library_ms']:.4f} ms; bound as fp32 SIMT {fp32_ms:.4f} ms "
          f"({fp32_by}), {route} {fa['bound_ms']:.4f} ms ({fa['bound_by']}) "
          f"({smi})")
    return fa


def hold_flash_bf16(got, wide, v) -> None:
    """The bf16 flash kernel's output against the fp32 kernel's on the
    widened inputs (``wide``, unrounded): every element within
    ``bf16_limit`` (one bf16 ulp of |wide| plus 2^-14 max|v|), with the
    elements that differ from ``wide`` rounded, the largest distance from
    it in bf16 ulps where one ulp of |wide| is at least the limit's 2^-14
    max|v| (nearer 0 ulps shrink to nothing and the absolute term holds:
    there the largest difference is printed) and the largest share of the
    limit printed beside."""
    import torch

    from repro_torch.kernels import flash_attention as FK

    def ordered(x):    # bf16 bits on one integer line, -0 beside +0
        bits = x.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    want = wide.to(torch.bfloat16)
    differ = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    large = FK.bf16_ulp(wide) >= 2.0 ** -14 * v.float().abs().max()
    ulps = int((ordered(got) - ordered(want))[large].abs().max())
    near_zero = (got.float() - wide)[~large].abs().max().item() \
        if (~large).any() else 0.0
    share = ((got.float() - wide).abs()
             / FK.bf16_limit(wide, v)).max().item()
    print(f"  flash_attention bf16 against the fp32 kernel on the widened "
          f"inputs: {differ} of {got.numel()} elements differ from it "
          f"rounded, at most {ulps} bf16 ulp(s) apart where one ulp of "
          f"|wide| is at least 2^-14 max|v| ({int(large.sum())} elements), "
          f"at most {near_zero:.3e} apart elsewhere; largest share of the "
          f"limit (1 bf16 ulp + 2^-14 max|v|) {share:.4f} "
          f"{'ok' if share <= 1 else 'FAIL'}")
    check(share <= 1, "flash_attention: the bf16 kernel is within one bf16 "
          "ulp plus 2^-14 max|v| of the fp32 kernel on the widened inputs")


def hold_bits(name: str, got, wide) -> None:
    """A bf16 kernel's output against its fp32 kernel's on the widened
    inputs (``wide``), rounded to bf16: zero elements may differ."""
    import torch
    want = wide.to(torch.bfloat16)
    differ = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    print(f"  {name} bf16 against the fp32 kernel on the widened inputs, "
          f"rounded: {differ} of {got.numel()} elements differ "
          f"{'ok' if differ == 0 else 'FAIL'}")
    check(differ == 0, f"{name}: the bf16 kernel is the fp32 kernel on the "
          f"widened inputs, rounded, bit for bit")


def decode_case(dev, randn, b, h, kv, s, hd, lengths, dtype: str,
                n_caches: int, smi: str, q_dtype: str = "float32") -> dict:
    """One decode shape, q (of ``q_dtype``) and the cache (of ``dtype``)
    drawn by ``randn``: the launch against its geometry, the error, times
    by events and by graph replay (warm: one cache; cold: each of
    ``n_caches`` caches in turn), the plain version's and one library
    call's times, the byte bound; for a bf16 q also the kernel against the
    fp32 q's result, rounded to bf16, bit for bit. Returns a kernel entry
    without its name and launches."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as DK
    tdt, qdt = getattr(torch, dtype), getattr(torch, q_dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    qd = randn(b, h, hd).to(qdt)
    kd = randn(b, s, kv, hd).to(tdt)
    vd = randn(b, s, kv, hd).to(tdt)
    geo = DK.launch_geometry(b, h, kv, s, hd, tdt, lengths, q_dtype=qdt)
    print(f"  decode_attention geometry (B,H,KV,S,D)="
          f"{(b, h, kv, s, hd)}, G={geo.g}, {q_dtype} q, {dtype} cache: "
          f"{geo.ctas} "
          f"split CTAs x {geo.threads} threads ({geo.ctas_with_work} "
          f"with work for lengths {lengths}), {geo.ctas_per_sm} CTA(s) "
          f"per SM by shared memory on {geo.n_sms} SMs, {geo.waves} "
          f"wave(s), {geo.smem_bytes} B of shared memory a CTA, "
          f"{geo.hbm_bytes} B through HBM, {geo.combine_ctas} combine "
          f"CTAs")
    out = DK.decode_attention(qd, kd, vd, ln)
    torch.cuda.synchronize()
    check(DK.last_launch() == geo.plan,
          f"decode_attention launched {DK.last_launch()}, its geometry "
          f"says {geo.plan}")
    per_sm = DK.max_active(h, kv, hd, tdt, geo.vec, q_dtype=qdt)
    check(1 <= per_sm <= geo.ctas_per_sm,
          f"decode_attention: {per_sm} CTAs a SM on the card, the "
          f"geometry's shared memory allows {geo.ctas_per_sm}")
    check(out.dtype == qdt, f"decode_attention returns q's type {qdt}")
    tol = TOL_ATTN["float32" if dtype == q_dtype == "float32"
                   else "bfloat16"]
    e = _close(f"decode_attention (B,S,KV,D)={(b, s, kv, hd)}, H={h}, "
               f"{q_dtype} q, {dtype} cache, lengths {lengths}", out,
               DK.plain(qd, kd, vd, ln), tol)
    if q_dtype != "float32":
        # the fp32 q's result: held against the plain version at fp32's
        # tolerance, then the bf16 q's result against it
        qf = qd.float()
        wide = DK.decode_attention(qf, kd, vd, ln)
        _close(f"decode_attention (B,S,KV,D)={(b, s, kv, hd)}, H={h}, "
               f"float32 q (the bf16 q widened), {dtype} cache", wide,
               DK.plain(qf, kd, vd, ln), TOL_ATTN["float32"])
        hold_bits("decode_attention", out, wide)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    caches = [tuple(torch.randn(b, s, kv, hd, generator=gen,
                                device=dev).to(tdt) for _ in range(2))
              for _ in range(n_caches)]

    def warm():
        DK.decode_attention(qd, kd, vd, ln)

    def cold():
        for kk, vv in caches:
            DK.decode_attention(qd, kk, vv, ln)

    kmask = (torch.arange(s, device=dev)[None, :]
             < ln[:, None])[:, None, None, :]
    # the library call takes one dtype, the wider of q's and the cache's:
    # the other is widened first, outside its time
    wide = torch.float32 if torch.float32 in (tdt, qdt) else torch.bfloat16
    kf, vf = (c.transpose(1, 2).to(wide) for c in (kd, vd))
    ql = qd.to(wide)
    entry = dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:27",
        max_abs_err=e, ms=cuda_ms(warm, 50),
        graph_ms=graph_ms(warm, 100),
        cold_graph_ms=graph_ms(cold, 4) / n_caches,
        plain_ms=cuda_ms(lambda: DK.plain(qd, kd, vd, ln), 10),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            ql[:, :, None], kf, vf, attn_mask=kmask, enable_gqa=True),
            20))
    entry["bound_ms"], entry["bound_by"] = bound(
        4.0 * kv * sum(geo.valid(i) for i in range(b)) * geo.g * hd,
        geo.hbm_bytes)
    print(f"  decode_attention (B,H,KV,S)={(b, h, kv, s)} {q_dtype} q, "
          f"{dtype} cache: kernel {entry['ms']:.4f} ms by events; by graph "
          f"replay warm (one cache) {entry['graph_ms']:.4f} ms, cold "
          f"({n_caches} caches in turn) {entry['cold_graph_ms']:.4f} "
          f"ms; plain {entry['plain_ms']:.4f} ms, library "
          f"{entry['library_ms']:.4f} ms, bound {entry['bound_ms']:.4f} "
          f"ms ({entry['bound_by']}) ({smi})")
    return entry


def time_decode_step(step, params, cache, tok, label: str, smi: str,
                     steps: int = 8) -> None:
    """A decode step's device time (its kernels summed by
    ``torch.profiler``), its wall time under the profiler and without it,
    and the device's idle share, after two warm-up steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step(params, cache, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(params, cache, tok)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    rows = [(e.key, max(getattr(e, "self_device_time_total", 0.0),
                        getattr(e, "self_cuda_time_total", 0.0)))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    device = sum(us for _, us in rows) / steps / 1e3
    del prof
    t0 = time.perf_counter()
    for _ in range(steps):
        step(params, cache, tok)
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t0) / steps * 1e3
    b = tok.shape[0]
    if device > 0:
        print(f"decode step ({label}): device {device:.3f} ms; wall "
              f"{wall:.3f} ms under the profiler (idle share "
              f"{1 - device / wall:.3f}), {bare:.3f} ms without it (idle "
              f"share {1 - device / bare:.3f}), {b / bare * 1e3:.0f} "
              f"tokens/s ({smi})")
        for key, us in sorted(rows, key=lambda r: -r[1])[:4]:
            print(f"  {us / steps / 1e3:9.3f} ms a step  {key[:80]}")
    else:
        print(f"decode step ({label}): wall {bare:.3f} ms, "
              f"{b / bare * 1e3:.0f} tokens/s; device time not measured "
              f"(the profiler saw no kernels) ({smi})")


def gqa_phases(dev, rng, kernels: dict, smi: str) -> None:
    """Phases 2c, 3c and 4c: Yi-9B at full width and full depth."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve import Server
    from repro_torch.train import make_prefill_step

    counters = kernel_modules()

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    cfg = get_arch("yi-9b")
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_a = sum(kind == "attn" for kind in cfg.layer_pattern)

    # -- 2c. both attention kernels at Yi-9B's shapes ------------------------
    print(f"yi-9b kernels at full width (S={YI_S}, H={H}, KV={KV}, G="
          f"{H // KV}, D={HD}, causal, no window):")
    kernels["flash_attention@yi-9b"] = dict(
        name="flash_attention@yi-9b",
        **flash_case(dev, randn, H, KV, YI_S, HD, smi))
    for dtype in ("float32", "bfloat16"):
        entry = decode_case(dev, randn, YI_DEC_B, H, KV, YI_S, HD,
                            YI_DEC_LENGTHS, dtype, n_a, smi)
        if dtype == "float32":         # the Server's cache type
            kernels["decode_attention@yi-9b"] = dict(
                name="decode_attention@yi-9b", **entry)
        gc.collect()
        torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        decode_case(dev, randn, YI_DEC_B, YI34_H, YI34_KV, YI34_S, HD,
                    YI34_LENGTHS, dtype, 4, smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("2c")

    # -- 3c. the prefill step at full width and full depth -------------------
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    print(f"yi-9b: {model.param_count() / 1e9:.3f} B parameters drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(1, YI_S))).to(dev)
    prefill = make_prefill_step(model)
    zero_counts()
    first = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"prefill launches: {launches}")
    check(launches == dict.fromkeys(counters, 0) | {"flash_attention": n_a},
          f"prefill must launch flash_attention {n_a}x and nothing else")
    check(tuple(first.shape) == (1, 1) and first.dtype == torch.int32,
          "prefill returns (1, 1) int32 tokens")
    kernels["flash_attention@yi-9b"]["launches"] = n_a
    ms = cuda_ms(lambda: prefill(params, {"tokens": tokens}), 2)
    print(f"prefill (B,S)={(1, YI_S)}: {ms:.1f} ms, "
          f"{YI_S / ms * 1e3:.0f} tokens/s ({smi})")
    plain = Model(cfg, kernel_impl="plain")
    with torch.no_grad():
        # clones, so that the 1 GB logits of each run are freed
        got = model.apply(params, {"tokens": tokens})[0][0, -1].clone()
        want = plain.apply(params, {"tokens": tokens})[0][0, -1].clone()
    scale = want.abs().max().item()
    rel = (got - want).abs().max().item() / scale
    top2 = want.topk(2).values
    margin = (top2[0] - top2[1]).item()
    ok = bool(torch.isfinite(got).all()) and rel <= TOL_PREFILL_REL
    print(f"prefill last-position logits, kernels vs plain: max abs diff "
          f"{(got - want).abs().max().item():.3e}, relative {rel:.3e} "
          f"(tolerance {TOL_PREFILL_REL}, {rel / TOL_PREFILL_REL:.3f} of "
          f"it) {'ok' if ok else 'FAIL'}; first token: kernels "
          f"{int(first)}, plain {int(want.argmax())}, top-2 margin "
          f"{margin:.3e}")
    check(ok, "prefill with the kernels disagrees with the plain path")
    if margin > TOL_PREFILL_REL * scale:
        check(int(first) == int(want.argmax()) == int(got.argmax()),
              "the prefill step's first token is the plain path's")
    else:
        print("  top-2 margin below the tolerance: logits compared only")
    # yardstick for that tolerance: the plain path against itself with the
    # embedding table moved by one ulp, i.e. how far 48 random fp32
    # layers carry a rounding difference on their own
    with torch.no_grad():
        alt = plain.apply(one_ulp_moved(params),
                          {"tokens": tokens})[0][0, -1].clone()
    moved_rel = (alt - want).abs().max().item() / scale
    print(f"  yardstick: plain path with the embeddings moved by 1 ulp, "
          f"relative {moved_rel:.3e} ({moved_rel / TOL_PREFILL_REL:.3f} of "
          f"the tolerance)")
    print(f"peak device memory so far: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del got, want, alt, first, tokens
    torch.cuda.empty_cache()
    phase_done("3c")

    # -- 4c. the Server for yi-9b at full width ------------------------------
    server = Server("yi-9b", smoke=False, slots=4, max_new=16, device=dev,
                    params=params)
    replies, long_prompt = serve_traffic(server, rng, cfg.vocab_size)

    # one decode step at B=4 with every cache holding YI_S positions
    step = server.step
    cache = model.init_cache(YI_DEC_B, max_seq=YI_S, device=dev,
                             dtype=torch.float32)
    for stage in cache:
        for block in stage.values():
            block["pos"].fill_(YI_S)
    tok = torch.zeros(YI_DEC_B, 1, dtype=torch.int64, device=dev)
    zero_counts()
    step(params, cache, tok)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"decode step launches: {launches}")
    check(launches == dict.fromkeys(counters, 0) | {"decode_attention": n_a},
          f"a decode step must launch decode_attention {n_a}x and nothing "
          f"else")
    kernels["decode_attention@yi-9b"]["launches"] = n_a
    time_decode_step(step, params, cache, tok,
                     f"B={YI_DEC_B}, caches of {YI_S} full", smi)
    del cache

    hold_long_request(model, params, long_prompt, replies[6][0],
                      model.init_cache(1, max_seq=len(long_prompt),
                                       device=dev, dtype=torch.float32))
    phase_done("4c")


class RoutingLog:
    """While active (``with RoutingLog() as log``), every call of the
    port's MoE routing (``repro_torch.models.moe.route``, which
    ``moe_apply`` looks up at each call) records its decisions on the
    device: each position's top-k experts (sorted), whether each of those
    assignments had a slot, and its top-k margin (the k-th routing
    probability less the (k+1)-th)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from repro_torch.models import moe as MOE
        self._route = route = MOE.route

        def recording(router, x, dims):
            r = route(router, x, dims)
            probs = torch.softmax(x.float() @ router, -1)
            top = torch.topk(probs, dims.top_k + 1, dim=-1).values
            idx, order = r.gate_idx.sort(-1)
            self.calls.append((idx, r.within.gather(-1, order),
                               top[..., -2] - top[..., -1]))
            return r

        MOE.route = recording
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import moe as MOE
        MOE.route = self._route

    def layers(self, n_layers: int) -> list:
        """Each MoE layer's decisions over the whole sequence: a prefill
        makes one call a layer, decode steps one a layer a step, joined
        here along S."""
        import torch
        check(len(self.calls) % n_layers == 0,
              f"{len(self.calls)} routing calls for {n_layers} MoE layers")
        return [tuple(torch.cat(parts, 1)
                      for parts in zip(*self.calls[i::n_layers]))
                for i in range(n_layers)]


def routing_diff(got: list, want: list) -> tuple:
    """Two runs' decisions, layer by layer: (p*, the first position at
    which any layer's top-k set or capacity mask differs, S if none does;
    the (layer, row, position) decisions that differ; all of them; the
    smallest top-k margin of ``want`` among those that differ)."""
    import torch
    diff = torch.stack([(gi != wi).any(-1) | (gw != ww).any(-1)
                        for (gi, gw, _), (wi, ww, _) in zip(got, want)])
    margins = torch.stack([m for _, _, m in want])
    count = int(diff.sum())
    where = diff.any(0).any(0).nonzero()
    p_star = int(where[0]) if len(where) else diff.shape[-1]
    margin = float(margins[diff].min()) if count else float("nan")
    return p_star, count, diff.numel(), margin


def err_by_position(got, want):
    """(S,) for (S, V) logits: the largest |got - want| at each position
    over that position's largest |want|."""
    return (got - want).abs().amax(-1) / want.abs().amax(-1)


def hold_flip_rule(label: str, err, flips: tuple, tol: float,
                   yardstick: tuple) -> None:
    """The flip-aware rule. Routing is causal and the capacity count runs
    in position order, so logits before p*, the first position where a
    decision differs, see no flip: there they are held within ``tol`` of
    each position's largest logit; p* is at least S/8 and at most 1% of
    the decisions differ. Where nothing differs this is the whole-sequence
    logits check. ``yardstick`` is (p*, differing, all, margin, err) of the
    plain path against itself with the embeddings moved by one ulp."""
    import torch
    p_star, count, total, margin = flips
    s = err.shape[0]
    before = err[:p_star].max().item() if p_star else 0.0
    ok = (bool(torch.isfinite(err).all()) and before <= tol
          and p_star >= s * MIN_FIRST_FLIP
          and count <= MAX_FLIP_SHARE * total)
    print(f"{label}: routing first differs at p*={p_star} of {s} "
          f"positions (at least {int(s * MIN_FIRST_FLIP)}), {count} of "
          f"{total} (layer, position) decisions differ (at most "
          f"{MAX_FLIP_SHARE:.0%}), smallest top-k margin among them "
          f"{margin:.3e}; logits before p* within {before:.3e} of each "
          f"position's largest ({before / tol:.3f} of the {tol} limit), "
          f"whole sequence {err.max().item():.3e} {'ok' if ok else 'FAIL'}")
    y_p, y_count, y_total, y_margin, y_err = yardstick
    y_before = y_err[:y_p].max().item() if y_p else 0.0
    print(f"  yardstick, plain path with the embeddings moved by 1 ulp: "
          f"p*={y_p}, {y_count} of {y_total} decisions differ, smallest "
          f"margin {y_margin:.3e}; logits before p* {y_before:.3e} "
          f"({y_before / tol:.3f} of the limit), whole sequence "
          f"{y_err.max().item():.3e}")
    check(ok, f"{label}: the flip-aware rule")


def moe_prefill_phase(cfg, model, params, tokens, smi: str) -> int:
    """The prefill step at B=1 through the entry point a user calls (one
    flash_attention launch a layer and no other kernel) and its time; then
    the kernel path's logits at every position against the plain path's by
    the flip-aware rule, with the share of assignments dropped by capacity
    and the 1-ulp yardstick. Returns the flash_attention launches."""
    import torch

    from repro_torch.models import Model
    from repro_torch.models.moe import capacity
    from repro_torch.train import make_prefill_step

    s = tokens.shape[1]
    n_a = len(cfg.layer_pattern)          # attention in every layer
    n_moe = sum(kind == "moe" for kind in cfg.layer_pattern)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(model)
    zero_counts()
    first = prefill(params, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"prefill launches: {launches}")
    check(launches == dict.fromkeys(launches, 0) | {"flash_attention": n_a},
          f"prefill must launch flash_attention {n_a}x and nothing else")
    check(tuple(first.shape) == (1, 1) and first.dtype == torch.int32,
          "prefill returns (1, 1) int32 tokens")
    ms = cuda_ms(lambda: prefill(params, batch), 2)
    print(f"prefill (B,S)={(1, s)}: {ms:.1f} ms, {s / ms * 1e3:.0f} "
          f"tokens/s ({smi})")
    plain = Model(cfg, kernel_impl="plain")
    with torch.no_grad():
        # only the (S, V) logits of the plain run are kept beside the
        # params; each other run is reduced to a number a position
        with RoutingLog() as want_log:
            want = plain.apply(params, batch)[0][0]
        with RoutingLog() as got_log:
            got = model.apply(params, batch)[0][0]
        err = err_by_position(got, want)
        got_last = got[-1].clone()
        del got
        with RoutingLog() as alt_log:
            alt = plain.apply(one_ulp_moved(params), batch)[0][0]
        alt_err = err_by_position(alt, want)
        del alt
    want_dec, got_dec = want_log.layers(n_moe), got_log.layers(n_moe)
    dropped = sum(int((~w).sum()) for _, w, _ in got_dec)
    assigned = sum(w.numel() for _, w, _ in got_dec)
    print(f"  (token, k) assignments dropped by capacity "
          f"({capacity(cfg.moe, s)} slots an expert), summed over {n_moe} "
          f"MoE layers: {dropped} of {assigned} ({dropped / assigned:.4f})")
    flips = routing_diff(got_dec, want_dec)
    hold_flip_rule("prefill logits, kernels vs plain", err, flips,
                   TOL_PREFILL_REL,
                   (*routing_diff(alt_log.layers(n_moe), want_dec), alt_err))
    last = want[-1]
    scale = last.abs().max().item()
    top2 = last.topk(2).values
    margin = (top2[0] - top2[1]).item()
    print(f"  first token: kernels {int(first)}, plain {int(last.argmax())}, "
          f"top-2 margin {margin:.3e}")
    if flips[0] == s and margin > TOL_PREFILL_REL * scale:
        check(int(first) == int(last.argmax()) == int(got_last.argmax()),
              "the prefill step's first token is the plain path's")
    print(f"peak device memory so far: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del want, last, err, alt_err, want_log, got_log, alt_log
    torch.cuda.empty_cache()
    return n_a


def moe_decode_step(cfg, model, params, smi: str) -> int:
    """One decode step at B=MOE_DEC_B with every cache holding MOE_S
    positions: one decode_attention launch a layer and no other kernel,
    then its device time, wall time and idle share. Returns the
    decode_attention launches."""
    import torch

    from repro_torch.train import make_serve_step
    n_a = len(cfg.layer_pattern)
    step = make_serve_step(model)
    cache = model.init_cache(MOE_DEC_B, max_seq=MOE_S, device=params[
        "embed"]["table"].device, dtype=torch.float32)
    for stage in cache:
        for block in stage.values():
            block["pos"].fill_(MOE_S)
    tok = torch.zeros(MOE_DEC_B, 1, dtype=torch.int64,
                      device=cache[0]["b0"]["pos"].device)
    zero_counts()
    step(params, cache, tok)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"decode step launches: {launches}")
    check(launches == dict.fromkeys(launches, 0) | {"decode_attention": n_a},
          f"a decode step must launch decode_attention {n_a}x and nothing "
          f"else")
    time_decode_step(step, params, cache, tok,
                     f"B={MOE_DEC_B}, caches of {MOE_S} full", smi)
    del cache
    torch.cuda.empty_cache()
    return n_a


def hold_long_request_moe(cfg, model, params, long_prompt: list,
                          server_first: int) -> None:
    """The long request's decode-path logits, kept at every step of its
    prompt fed a token at a time into a fresh cache, against a prefill that
    cannot drop (``capacity_factor`` = n_experts: S·k slots an expert),
    by the flip-aware rule with TOL_DECODE_REL, beside the assignments
    that the real prefill drops on that prompt. A decode step (S=1) has
    one slot an expert and never drops; a prefill of the real config
    may."""
    import dataclasses

    import torch

    from repro_torch.models import Model
    from repro_torch.models.moe import capacity
    n_moe = sum(kind == "moe" for kind in cfg.layer_pattern)
    nodrop_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    s = len(long_prompt)
    dev = params["embed"]["table"].device
    toks = torch.tensor([long_prompt], device=dev)
    batch = {"tokens": toks}
    with torch.no_grad():
        with RoutingLog() as pre_log:
            pre = Model(nodrop_cfg).apply(params, batch)[0][0]
        cache = model.init_cache(1, max_seq=s, device=dev,
                                 dtype=torch.float32)
        rows = []
        with RoutingLog() as dec_log:
            for t in range(s):
                logits, cache = model.decode_step(params, cache,
                                                  toks[:, t:t + 1])
                rows.append(logits[0, 0])
        dec = torch.stack(rows)
        del rows, cache
        err = err_by_position(dec, pre)
        plain = Model(nodrop_cfg, kernel_impl="plain")
        with RoutingLog() as yw_log:
            yw = plain.apply(params, batch)[0][0]
        with RoutingLog() as ya_log:
            ya = plain.apply(one_ulp_moved(params), batch)[0][0]
        y_err = err_by_position(ya, yw)
        del yw, ya
        with RoutingLog() as real_log:
            model.apply(params, batch)
    flips = routing_diff(dec_log.layers(n_moe), pre_log.layers(n_moe))
    hold_flip_rule(f"{s}-token request, decode path vs a prefill that "
                   f"cannot drop", err, flips, TOL_DECODE_REL,
                   (*routing_diff(ya_log.layers(n_moe), yw_log.layers(n_moe)),
                    y_err))
    real = real_log.layers(n_moe)
    dropped = sum(int((~w).sum()) for _, w, _ in real)
    print(f"  the real prefill ({capacity(cfg.moe, s)} slots an expert) "
          f"drops {dropped} of {sum(w.numel() for _, w, _ in real)} "
          f"(token, k) assignments on this prompt, summed over {n_moe} "
          f"layers")
    last = pre[-1]
    scale = last.abs().max().item()
    top2 = last.topk(2).values
    margin = (top2[0] - top2[1]).item()
    print(f"  first token: server {server_first}, decode path "
          f"{int(dec[-1].argmax())}, prefill {int(last.argmax())}, top-2 "
          f"margin {margin:.3e}")
    if flips[0] == s and margin > TOL_DECODE_REL * scale:
        check(server_first == int(last.argmax()) == int(dec[-1].argmax()),
              "the Server's first token matches the prefill's")
    else:
        print("  a decision differs or the top-2 margin is below the "
              "tolerance: logits compared only")


def moe_phases(dev, rng, kernels: dict, smi: str) -> None:
    """Phases 2d, 3d, 4d and 3e: Qwen1.5-MoE-A2.7B at full width and full
    depth, then DeepSeekMoE-16B."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve import Server

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    cfg = get_arch("qwen2-moe-a2.7b")
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_a = len(cfg.layer_pattern)

    # -- 2d. both attention kernels at qwen2-moe's shapes (G=1) --------------
    print(f"qwen2-moe-a2.7b kernels at full width (S={MOE_S}, H={H}, KV={KV}"
          f", G={H // KV}, D={HD}, causal, no window):")
    kernels["flash_attention@qwen2-moe-a2.7b"] = dict(
        name="flash_attention@qwen2-moe-a2.7b",
        **flash_case(dev, randn, H, KV, MOE_S, HD, smi))
    for dtype in ("float32", "bfloat16"):
        entry = decode_case(dev, randn, MOE_DEC_B, H, KV, MOE_S, HD,
                            MOE_DEC_LENGTHS, dtype, n_a, smi)
        if dtype == "float32":         # the Server's cache type
            kernels["decode_attention@qwen2-moe-a2.7b"] = dict(
                name="decode_attention@qwen2-moe-a2.7b", **entry)
        gc.collect()
        torch.cuda.empty_cache()
    phase_done("2d")

    # -- 3d. the prefill step at full width and full depth -------------------
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    print(f"qwen2-moe-a2.7b: {model.param_count() / 1e9:.3f} B parameters "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(1, MOE_S))).to(dev)
    kernels["flash_attention@qwen2-moe-a2.7b"]["launches"] = \
        moe_prefill_phase(cfg, model, params, tokens, smi)
    del tokens
    phase_done("3d")

    # -- 4d. the Server for qwen2-moe-a2.7b at full width --------------------
    server = Server("qwen2-moe-a2.7b", smoke=False, slots=4, max_new=16,
                    device=dev, params=params)
    replies, long_prompt = serve_traffic(server, rng, cfg.vocab_size)
    del server
    kernels["decode_attention@qwen2-moe-a2.7b"]["launches"] = \
        moe_decode_step(cfg, model, params, smi)
    hold_long_request_moe(cfg, model, params, long_prompt, replies[6][0])
    phase_done("4d")

    # -- 3e. DeepSeekMoE-16B: free qwen2-moe first ---------------------------
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"after qwen2-moe-a2.7b is freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    cfg = get_arch("deepseek-moe-16b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    print(f"deepseek-moe-16b: {model.param_count() / 1e9:.3f} B parameters "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(1, MOE_S))).to(dev)
    moe_prefill_phase(cfg, model, params, tokens, smi)
    del tokens
    moe_decode_step(cfg, model, params, smi)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("3e")


def yi34_phases(dev, rng, kernels: dict, smi: str) -> None:
    """Phases 2f, 3f and 4f: Yi-34B from bf16 parameters at full width and
    full depth."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve import Server
    from repro_torch.train import make_prefill_step, make_serve_step

    counters = kernel_modules()

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    cfg = get_arch("yi-34b")
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_a = sum(kind == "attn" for kind in cfg.layer_pattern)

    # -- 2f. both attention kernels at Yi-34B's shapes in bf16 ---------------
    print(f"yi-34b kernels at full width in bf16 (S={YI_S}, H={H}, KV={KV}, "
          f"G={H // KV}, D={HD}, causal, no window):")
    kernels["flash_attention@yi-34b-bf16"] = dict(
        name="flash_attention@yi-34b-bf16",
        **flash_case(dev, randn, H, KV, YI_S, HD, smi, dtype="bfloat16"))
    gc.collect()
    torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32"):
        entry = decode_case(dev, randn, YI_DEC_B, H, KV, YI_S, HD,
                            YI34_DEC_LENGTHS, dtype, n_a, smi,
                            q_dtype="bfloat16")
        if dtype == "bfloat16":        # the decode step's cache type below
            kernels["decode_attention@yi-34b-bf16"] = dict(
                name="decode_attention@yi-34b-bf16", **entry)
        gc.collect()
        torch.cuda.empty_cache()
    phase_done("2f")

    # -- 3f. the prefill step from bf16 parameters, full width and depth -----
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    print(f"yi-34b: {model.param_count() / 1e9:.3f} B bf16 parameters drawn "
          f"on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free")
    torch.cuda.reset_peak_memory_stats()
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(1, YI_S))).to(dev)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(model)
    zero_counts()
    first = prefill(params, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"prefill launches: {launches}")
    check(launches == dict.fromkeys(counters, 0) | {"flash_attention": n_a},
          f"prefill must launch flash_attention {n_a}x and nothing else")
    check(tuple(first.shape) == (1, 1) and first.dtype == torch.int32,
          "prefill returns (1, 1) int32 tokens")
    kernels["flash_attention@yi-34b-bf16"]["launches"] = n_a
    ms = cuda_ms(lambda: prefill(params, batch), 2)
    print(f"prefill (B,S)={(1, YI_S)} from bf16 parameters: {ms:.1f} ms, "
          f"{YI_S / ms * 1e3:.0f} tokens/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})")
    plain = Model(cfg, kernel_impl="plain")
    with torch.no_grad():
        # (a) the same prefill through the fp32 kernel on widened inputs,
        # held below (within the yardstick)
        got = model.apply(params, batch)[0][0]
        with WidenedFlash():
            wide = model.apply(params, batch)[0][0]
        differ = int((got != wide).sum())
        wide_diff = (got - wide).abs().max().item()
        del wide
        # (b) against the plain path, beside the 1-ulp bf16 yardstick
        want = plain.apply(params, batch)[0][0]
        scale = want.abs().max().item()
        diff = (got - want).abs().max().item()
        top1 = (got.argmax(-1) != want.argmax(-1)).float().mean().item()
        finite = bool(torch.isfinite(got).all())
        first_plain = int(want[-1].argmax())
        got_shape = got.shape
        del got
        alt = plain.apply(one_ulp_moved(params), batch)[0][0]
        moved = (alt - want).abs().max().item()
        moved_top1 = (alt.argmax(-1) != want.argmax(-1)).float().mean().item()
        del alt, want
    ok_a = wide_diff <= moved
    print(f"prefill logits (S, V)={tuple(got_shape)} against the same "
          f"prefill with each flash_attention call's inputs widened to fp32 "
          f"and its output rounded back: {differ} differ, max abs diff "
          f"{wide_diff:.3e} ({wide_diff / scale:.3e} of the largest logit), "
          f"{wide_diff / moved:.3f} of the 1-ulp yardstick "
          f"{'ok' if ok_a else 'FAIL'}")
    check(ok_a, "the bf16 prefill is within the 1-ulp yardstick of its "
          "widened-kernel counterpart")
    ok = finite and diff <= moved
    print(f"prefill logits, kernels vs plain: max abs diff {diff:.3e} "
          f"({diff / scale:.3e} of the largest logit {scale:.3e}), top-1 "
          f"token differs at {top1:.4f} of the positions; yardstick (plain "
          f"with the embeddings moved by 1 bf16 ulp): {moved:.3e} "
          f"({moved / scale:.3e}), top-1 differs at {moved_top1:.4f}; "
          f"kernels at {diff / moved:.3f} of the yardstick "
          f"{'ok' if ok else 'FAIL'}; first token: kernels {int(first)}, "
          f"plain {first_plain}")
    check(ok, "the bf16 prefill with the kernels is within the 1-ulp "
          "yardstick of the plain path")
    print(f"peak device memory so far: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del first, tokens, batch
    torch.cuda.empty_cache()
    phase_done("3f")

    # -- 4f. the Server for yi-34b from the bf16 tree ------------------------
    server = Server("yi-34b", smoke=False, slots=4, max_new=16, device=dev,
                    params=params)
    replies, long_prompt = serve_traffic(server, rng, cfg.vocab_size)
    del server

    # one decode step at B=4 with every bf16 cache holding YI_S positions
    step = make_serve_step(model)
    cache = model.init_cache(YI_DEC_B, max_seq=YI_S, device=dev,
                             dtype=torch.bfloat16)
    for stage in cache:
        for block in stage.values():
            block["pos"].fill_(YI_S)
    tok = torch.zeros(YI_DEC_B, 1, dtype=torch.int64, device=dev)
    zero_counts()
    step(params, cache, tok)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"decode step launches: {launches}")
    check(launches == dict.fromkeys(counters, 0) | {"decode_attention": n_a},
          f"a decode step must launch decode_attention {n_a}x and nothing "
          f"else")
    kernels["decode_attention@yi-34b-bf16"]["launches"] = n_a
    time_decode_step(step, params, cache, tok,
                     f"B={YI_DEC_B}, bf16 caches of {YI_S} full", smi)
    del cache
    torch.cuda.empty_cache()

    hold_long_request(model, params, long_prompt, replies[6][0],
                      model.init_cache(1, max_seq=len(long_prompt),
                                       device=dev, dtype=torch.float32),
                      tol=TOL_DECODE_REL_BF16, yardstick=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("4f")


def mla_logits_fp64(cfg, params, tokens):
    """The logits (B, S, V) of an ``mla`` model's prefill at positions
    0..S-1 with every product, sum, norm and softmax taken in fp64 on the
    parameters' device, written here apart from the port's layers (which
    widen to fp32 at most). Each block's parameters are widened when it
    runs and dropped after it, so at most one block's fp64 copy sits
    beside the model's tree. The RoPE angles are the model's constants,
    fp32 positions times fp32 frequencies as ``layers.apply_rope`` (and the
    reference) makes them; their cosines and sines are taken in fp64."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.layers import rope_freqs
    from repro_torch.tree import tree_map
    check(cfg.norm == "rmsnorm" and cfg.mlp_kind == "swiglu"
          and cfg.rope_kind == "rope" and not cfg.tie_embeddings
          and not cfg.logits_softcap
          and set(cfg.layer_pattern) == {"mla"},
          "the fp64 reference covers rmsnorm, swiglu, rope, mla blocks")
    f64, dims, eps = torch.float64, cfg.mla, cfg.norm_eps
    h, r_kv = dims.n_heads, dims.kv_lora_rank
    dn, dr, dv = dims.qk_nope_dim, dims.qk_rope_dim, dims.v_head_dim
    b, s = tokens.shape
    dev = tokens.device

    def norm(p, x):
        return (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
                * p["scale"])

    freqs = torch.from_numpy(rope_freqs(dr, cfg.rope_theta)).to(
        device=dev, dtype=torch.float32)
    ang = (torch.arange(s, device=dev).float()[:, None] * freqs).to(f64)
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]           # (S,1,dr/2)

    def rope(t):                                                # (B,S,*,dr)
        t1, t2 = t.chunk(2, -1)
        return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], -1)

    future = torch.ones(s, s, dtype=torch.bool, device=dev).triu(1)
    x = params["embed"]["table"][tokens].to(f64)
    for (pattern, repeat), sp in zip(cfg.stages, params["stages"]):
        for r in range(repeat):
            for bi in range(len(pattern)):
                lp = tree_map(lambda t: (t[r] if repeat > 1 else t).to(f64),
                              sp[f"b{bi}"])
                a, m = lp["attn"], lp["mlp"]
                hx = norm(lp["ln1"], x)
                q = (norm(a["q_a_norm"], hx @ a["wq_a"]) @ a["wq_b"]
                     ).reshape(b, s, h, dn + dr)
                kv_a = hx @ a["wkv_a"]
                c_kv = norm(a["kv_a_norm"], kv_a[..., :r_kv])
                kv = (c_kv @ a["wkv_b"]).reshape(b, s, h, dn + dv)
                qq = torch.cat([q[..., :dn], rope(q[..., dn:])], -1)
                k = torch.cat([kv[..., :dn], rope(kv_a[:, :, None, r_kv:])
                               .expand(b, s, h, dr)], -1)
                scores = torch.einsum("bqhd,bkhd->bhqk", qq, k) \
                    * (dn + dr) ** -0.5
                probs = scores.masked_fill_(future, -1e30).softmax(-1)
                del scores
                o = torch.einsum("bhqk,bkhd->bqhd", probs, kv[..., dn:])
                del probs
                x = x + o.reshape(b, s, h * dv) @ a["wo"]
                hm = norm(lp["ln2"], x)
                x = x + (F.silu(hm @ m["w_gate"]) * (hm @ m["w_up"])) \
                    @ m["w_down"]
                del lp, a, m, hx, q, kv_a, c_kv, kv, qq, k, o, hm
    x = norm(tree_map(lambda t: t.to(f64), params["final_norm"]), x)
    return x @ params["unembed"]["table"].to(f64).T


def minicpm3_phases(dev, rng, smi: str) -> None:
    """Phases 3g and 4g: MiniCPM3-4B at full width and full depth. Its
    MLA path runs no kernel (the reference's prefill is the plain masked
    attention, its absorbed decode plain einsums), so every launch count
    must stay 0."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve import Server
    from repro_torch.train import make_prefill_step, make_serve_step

    counters = kernel_modules()
    cfg = get_arch("minicpm3-4b")
    dims = cfg.mla

    # -- 3g. the prefill step at full width and full depth, fp32 -------------
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    print(f"minicpm3-4b: {model.param_count() / 1e9:.3f} B fp32 parameters "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; "
          f"{cfg.n_layers} mla layers, H={dims.n_heads}, r_q="
          f"{dims.q_lora_rank}, r_kv={dims.kv_lora_rank}, q.k at "
          f"{dims.qk_nope_dim + dims.qk_rope_dim}, v at {dims.v_head_dim}")
    torch.cuda.reset_peak_memory_stats()
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(1, MLA_S))).to(dev)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(model)
    zero_counts()
    first = prefill(params, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"prefill launches: {launches}")
    check(launches == dict.fromkeys(counters, 0),
          "the MLA prefill launches no kernel")
    check(tuple(first.shape) == (1, 1) and first.dtype == torch.int32,
          "prefill returns (1, 1) int32 tokens")
    ms = cuda_ms(lambda: prefill(params, batch), 2)
    print(f"prefill (B,S)={(1, MLA_S)}: {ms:.1f} ms, "
          f"{MLA_S / ms * 1e3:.0f} tokens/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})")
    t0 = time.perf_counter()
    with torch.no_grad():
        got = model.apply(params, batch)[0][0]                 # (S, V)
        want = mla_logits_fp64(cfg, params, tokens)[0]
        torch.cuda.synchronize()
        wide_s = time.perf_counter() - t0
        scale = want[-1].abs().max().item()
        diff = (got[-1] - want[-1]).abs().max().item()
        diff_all = (got - want).abs().max().item()
        scale_all = want.abs().max().item()
        top2 = want[-1].topk(2).values
        margin = (top2[0] - top2[1]).item()
        finite = bool(torch.isfinite(got).all())
        want_tok = int(want[-1].argmax())
        got = got[-1].clone()
        del want
        alt = model.apply(one_ulp_moved(params), batch)[0][0, -1]
        moved = (alt - got).abs().max().item() / scale
        del alt, got
    rel = diff / scale
    ok = finite and rel <= TOL_PREFILL_REL
    print(f"prefill last-position logits, fp32 vs the same model summed in "
          f"fp64 (both forwards {wide_s:.1f} s): max abs diff {diff:.3e}, "
          f"relative "
          f"{rel:.3e} (tolerance {TOL_PREFILL_REL}, "
          f"{rel / TOL_PREFILL_REL:.3f} of it) {'ok' if ok else 'FAIL'}; "
          f"over all {MLA_S} positions {diff_all / scale_all:.3e} of the "
          f"largest logit; first token: fp32 {int(first)}, fp64 {want_tok}, "
          f"top-2 margin {margin:.3e}")
    print(f"  yardstick: the fp32 prefill with the embeddings moved by 1 "
          f"ulp, relative {moved:.3e} ({moved / TOL_PREFILL_REL:.3f} of the "
          f"tolerance)")
    check(ok, "the fp32 MLA prefill disagrees with its fp64 sums")
    if margin > TOL_PREFILL_REL * scale:
        check(int(first) == want_tok,
              "the prefill step's first token is the fp64 model's")
    else:
        print("  top-2 margin below the tolerance: logits compared only")
    print(f"peak device memory so far: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del first, tokens, batch
    torch.cuda.empty_cache()
    phase_done("3g")

    # -- 4g. the Server for minicpm3-4b, absorbed-latent decode --------------
    server = Server("minicpm3-4b", smoke=False, slots=4, max_new=16,
                    device=dev, params=params)
    zero_counts()
    replies, long_prompt = serve_traffic(server, rng, cfg.vocab_size,
                                         long_len=MLA_LONG)
    check(read_counts() == dict.fromkeys(counters, 0),
          "the MLA Server launches no kernel")
    del server

    # one decode step at B=4 with every latent cache holding MLA_S positions
    step = make_serve_step(model)
    cache = model.init_cache(MLA_DEC_B, max_seq=MLA_S, device=dev,
                             dtype=torch.float32)
    for stage in cache:
        for block in stage.values():
            block["pos"].fill_(MLA_S)
    cache_gb = sum(t.numel() * t.element_size() for stage in cache
                   for block in stage.values() for t in block.values()) / 1e9
    print(f"latent caches: {cache_gb:.3f} GB fp32 at "
          f"{dims.kv_lora_rank + dims.qk_rope_dim} values a token a layer")
    tok = torch.zeros(MLA_DEC_B, 1, dtype=torch.int64, device=dev)
    zero_counts()
    step(params, cache, tok)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"decode step launches: {launches}")
    check(launches == dict.fromkeys(counters, 0),
          "an MLA decode step launches no kernel")
    time_decode_step(step, params, cache, tok,
                     f"B={MLA_DEC_B}, latent caches of {MLA_S} full", smi)
    del cache
    torch.cuda.empty_cache()

    hold_long_request(model, params, long_prompt, replies[6][0],
                      model.init_cache(1, max_seq=len(long_prompt),
                                       device=dev, dtype=torch.float32))
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("4g")



def hubert_phases(dev, rng, kernels: dict, smi: str) -> None:
    """Phases 2h and 3h: HuBERT-XLarge's encoder at full width and full
    depth, on B=8 clips of S=1500 frames: flash attention at head dim 80,
    non-causal, in both instances, then the forward through the entry
    points (``Model.apply``, ``make_prefill_step``, ``make_eval_step``).
    An encoder has no decode step, so there is no Server phase."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.train import make_eval_step, make_prefill_step
    from repro_torch.tree import tree_map

    counters = kernel_modules()

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    cfg = get_arch("hubert-xlarge")
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_a = sum(kind == "attn" for kind in cfg.layer_pattern)
    b, s = HUBERT_B, HUBERT_S

    # -- 2h. flash attention at HuBERT's shape, both instances ---------------
    print(f"hubert-xlarge flash attention at full width (B={b}, S={s}, "
          f"H={H}, KV={KV}, G={H // KV}, D={HD}, non-causal, no window):")
    for dtype, name in (("float32", "flash_attention@hubert-xlarge"),
                        ("bfloat16", "flash_attention@hubert-xlarge-bf16")):
        kernels[name] = dict(name=name, **flash_case(
            dev, randn, H, KV, s, HD, smi, dtype=dtype, b=b, causal=False))
        gc.collect()
        torch.cuda.empty_cache()
    phase_done("2h")

    # -- 3h. the forward at full width and full depth, fp32 then bf16 --------
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    print(f"hubert-xlarge: {model.param_count() / 1e9:.3f} B fp32 parameters "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; "
          f"{cfg.n_layers} attn layers, H={H}, D={HD}, non-causal, the "
          f"audio frontend (frames of {cfg.frontend_dim}, convpos kernel "
          f"{params['frontend']['convpos']['w'].shape[0]}, 16 groups)")
    torch.cuda.reset_peak_memory_stats()
    frames = randn(b, s, cfg.frontend_dim)
    labels = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(b, s))).to(dev)
    batch = {"frames": frames, "labels": labels}
    prefill = make_prefill_step(model)
    zero_counts()
    first = prefill(params, {"frames": frames})
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"forward launches: {launches}")
    check(launches == dict.fromkeys(counters, 0) | {"flash_attention": n_a},
          f"the forward must launch flash_attention {n_a}x and nothing else")
    check(tuple(first.shape) == (b, 1) and first.dtype == torch.int32,
          f"prefill returns ({b}, 1) int32 tokens")
    kernels["flash_attention@hubert-xlarge"]["launches"] = n_a
    ms = cuda_ms(lambda: prefill(params, {"frames": frames}), 2)
    print(f"forward (B,S)={(b, s)}: {ms:.1f} ms, {b * s / ms * 1e3:.0f} "
          f"frames/s ({b * s / ms * 1e3 * 0.02:.0f} s of audio a second); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB ({smi})")
    # the plain path sums its attention in fp64, as phase 3b's reference
    plain = Model(cfg, kernel_impl="plain")
    evals = {m: make_eval_step(m) for m in (model, plain)}
    with torch.no_grad():
        got = model.apply(params, batch)[0]                   # (B, S, V)
        loss = evals[model](params, batch)["loss"].item()
        with WidenedFlash(torch.float64):
            want = plain.apply(params, batch)[0]
            want_loss = evals[plain](params, batch)["loss"].item()
            moved = one_ulp_moved(params)
            alt = plain.apply(moved, batch)[0]
            alt_loss = evals[plain](moved, batch)["loss"].item()
            del moved
    scale = want.abs().max().item()
    rel = (got - want).abs().max().item() / scale
    moved_rel = (alt - want).abs().max().item() / scale
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    moved_loss = abs(alt_loss - want_loss) / abs(want_loss)
    top2 = want[:, -1].topk(2).values
    sure = (top2[:, 0] - top2[:, 1]) > TOL_PREFILL_REL * scale
    finite = bool(torch.isfinite(got).all()) and np.isfinite(loss)
    ok = finite and rel <= TOL_PREFILL_REL
    print(f"forward logits (B, S, V)={tuple(got.shape)}, kernels vs plain "
          f"(attention in fp64): max abs diff "
          f"{(got - want).abs().max().item():.3e}, relative {rel:.3e} "
          f"(tolerance {TOL_PREFILL_REL}, {rel / TOL_PREFILL_REL:.3f} of it)"
          f" {'ok' if ok else 'FAIL'}; yardstick (plain with the frames' "
          f"projection moved by 1 ulp) {moved_rel:.3e} "
          f"({moved_rel / TOL_PREFILL_REL:.3f} of the tolerance)")
    check(ok, "the forward with the kernels disagrees with the plain path")
    ok = loss_rel <= TOL_PREFILL_REL
    print(f"eval loss: kernels {loss:.6f}, plain (attention in fp64) "
          f"{want_loss:.6f}, relative {loss_rel:.3e} (tolerance "
          f"{TOL_PREFILL_REL}) {'ok' if ok else 'FAIL'}; yardstick "
          f"{moved_loss:.3e}")
    check(ok, "the eval loss with the kernels disagrees with the plain path")
    got_first = first[:, 0].cpu()
    check(bool((got_first == want[:, -1].argmax(-1).cpu())[sure.cpu()]
               .all()),
          "the prefill step's tokens are the plain path's where the top-2 "
          "margin exceeds the tolerance")
    print(f"  last-frame tokens: kernels {got_first.tolist()}; "
          f"{int(sure.sum())} of {b} rows decided beyond the tolerance")
    del got, want, alt, first
    torch.cuda.empty_cache()

    # the same forward from the tree rounded to bf16: the bf16 instance on
    # the path (48 launches on bf16 q, k and v)
    params16 = tree_map(lambda x: x.to(torch.bfloat16), params)
    del params
    batch16 = {"frames": frames.to(torch.bfloat16)}
    zero_counts()
    with torch.no_grad():
        got = model.apply(params16, batch16)[0]
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"bf16 forward launches: {launches}")
        check(launches == dict.fromkeys(counters, 0)
              | {"flash_attention": n_a},
              f"the bf16 forward must launch flash_attention {n_a}x and "
              f"nothing else")
        kernels["flash_attention@hubert-xlarge-bf16"]["launches"] = n_a
        ms = cuda_ms(lambda: model.apply(params16, batch16), 2)
        with WidenedFlash():
            wide = model.apply(params16, batch16)[0]
        want = plain.apply(params16, batch16)[0]
        alt = plain.apply(one_ulp_moved(params16), batch16)[0]
    scale = want.abs().max().item()
    moved = (alt - want).abs().max().item()
    wide_diff = (got - wide).abs().max().item()
    diff = (got - want).abs().max().item()
    limit = HUBERT_BF16_YARDSTICKS * moved
    finite = bool(torch.isfinite(got).all())
    print(f"bf16 forward (B,S)={(b, s)}: {ms:.1f} ms, "
          f"{b * s / ms * 1e3:.0f} frames/s; logits against the same forward "
          f"with each flash_attention call widened to fp32: max abs diff "
          f"{wide_diff:.3e} ({wide_diff / moved:.3f} of the 1-ulp yardstick "
          f"{moved:.3e}, {moved / scale:.3e} of the largest logit); against "
          f"the plain path {diff:.3e} ({diff / moved:.3f} of it); limit "
          f"{HUBERT_BF16_YARDSTICKS} yardsticks "
          f"{'ok' if finite and max(wide_diff, diff) <= limit else 'FAIL'}")
    check(finite and wide_diff <= limit,
          "the bf16 forward is within the yardstick limit of its "
          "widened-kernel counterpart")
    check(diff <= limit, "the bf16 forward with the kernels is within the "
          "yardstick limit of the plain path")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model, params16, got, wide, want, alt
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("3h")


if __name__ == "__main__":
    sys.exit(main())
