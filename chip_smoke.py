#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (the quickest proof that
the port starts on the card).

    python3 chip_smoke.py
    python3 chip_smoke.py --phases "3c'" 8    # the build, then these alone
    python3 chip_smoke.py --phases 5          # the build, xLSTM training

Phases, each printing its own lines; any failure exits non-zero:
  1. the card's name and power limit, then the build of every CUDA kernel
     (``src/repro_torch/kernels/csrc``) with its seconds and ptxas report;
  2. each kernel against its plain PyTorch version on the card, at the
     full-width prefill shapes of xLSTM-125M (B=8, S=2048), with errors
     against the stated tolerance, times and bounds; for the mLSTM also its
     launch geometry (column tile, CTAs, waves, shared memory), for the
     sLSTM its cluster geometry, its time a step and that of one chain
     alone; the sLSTM backward kernel at the train shape (B=8, S=512):
     the training forward's h bit for bit the store-free forward's, each
     of the eight grads against the plain backward and against autograd of
     the plain version in fp64 within SLSTM_BWD_YARDSTICKS times the fp32
     recompute's error (printed beside), its geometry, ms and bound; the
     mLSTM backward kernel at the train shape (``mlstm_backward_case``):
     the training forward's h bit for bit the store-free forward's, each
     of dq, dk, dv, di and df against the plain backward on the kernel's
     own saved states and against autograd of the plain version in fp64
     within MLSTM_BWD_YARDSTICKS times the fp32 recompute's error, its
     geometry, ms and bound, the saved states' bytes;
  3. the prefill step at full width through the entry points a user calls,
     with the launch counts zeroed just before and read just after (10
     mLSTM and 2 sLSTM launches), held against the same model on the plain
     kernel versions;
  4. the decode Server at full width answering 6 short requests and one
     512-token request submitted as futures under plan("threads"); the
     long request's first token and its logits are held against the
     prefill step on the same prompt;
  5. xLSTM-125M training at full width (B=8, S=512, fp32, remat "none"):
     one train step's loss and every grad leaf with the kernels (the
     sLSTM's and the mLSTM's backward their backward kernels) against the
     plain path from the same params and batch, with the launch counts
     read after the forward (10 mLSTM, 2 sLSTM) and after the backward (10
     mLSTM backward, 2 sLSTM backward), and no step of the plain sLSTM and
     no call of the plain mLSTM run (``PlainSlstmCalls``,
     ``PlainMlstmCalls``); the
     Trainer for 4 steps under plan("threads") with checkpoints at steps 2
     and 4, its loss curve held against the plain path's and the step-4
     checkpoint restored bit for bit; then the train step's times (forward
     with loss, backward with the optimiser), tokens/s, peak memory and the
     share of the backward in each kernel's backward: each backward kernel
     beside the recompute through the plain version it replaced;
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
     on threads, and state.get returning the live params;
  6b. the same prefill in worker processes under plan("processes",
     workers=2), the paper's multisession: three prefill futures, each
     with the ms until future() returns, the ms until value() returns, the
     direct call's ms and the bytes of ``put`` messages the worker was
     sent (counted on the parent's ends of the pipes); each worker's pid
     (not the parent's), launch counts (10 mLSTM, 2 sLSTM, read in the
     worker) and card, and its tokens phase 3's bit for bit; a worker that
     already holds the parameters is sent no ``put``; future_map over phase
     6's 4 batches of B=2 on the two workers, twice (cold, then warm), with
     the sequential map's tokens bit for bit and 40 mLSTM and 8 sLSTM
     launches summed from the workers; a worker that dies (os._exit)
     raising WorkerDiedError, and the healed worker's prefill (sent the
     parameters again) giving phase 3's tokens; the shared state over the
     pipe: an exact state.add fold from 8 futures, and the embedding table
     (50304 x 768 fp32, 154.5 MB) put by the driver, doubled in a worker
     and put back, bit for bit;
  6c. the same prefill on socket-connected workers under plan("cluster",
     workers=2), the paper's PSOCK cluster (local launcher over 127.0.0.1,
     a random token, no TLS: the card's host may lack openssl): three
     prefill futures, each with the ms until future() returns, until
     value() returns, the direct call's ms, the ``put`` bytes its worker
     was sent (counted at the driver's sockets) and the cold put's GB/s,
     its pid, card, launch counts read in the worker (10 mLSTM, 2 sLSTM)
     and phase 3's tokens bit for bit; a worker SIGKILLed mid-prefill
     raising WorkerDiedError and its relaunched successor giving phase 3's
     tokens; the last-position logits kept on their worker (a RemoteValue,
     one holder), a continuation run on the holder with under 1 MB
     received at the driver, a future on the other worker taking the
     RemoteValue by peer fetch, and value() pulling the in-process call's
     bytes bit for bit; held logits (of the sequences reversed) whose
     only holder is SIGKILLed rebuilt from lineage by value(), bit for bit,
     the producing task run again on a live worker (10 mLSTM, 2 sLSTM
     launches read there, recovery_stats() one reconstruction, the
     rebuild's ms and whether the parameters were sent again), and a
     .then(argmax) on lost fp64 logits rebuilding its parent first and
     giving phase 3's tokens; an exact state.add fold from 8 futures over
     the socket; the longest gap between two heartbeats of any worker;
  6d. the multi-tenant serving tier: serve() over a two-worker cluster
     with min_replicas=2 (loopback, random tokens, no TLS), two
     ServingClientBackend sessions in this process (alice weight 3, bob
     weight 1) sending 3 and 2 prefill futures, each phase 3's tokens bit
     for bit with 10 mLSTM and 2 sLSTM launches in its worker (each
     tenant's first future sent together, from a thread each), the put
     bytes each worker was sent for each tenant's first future; each
     tenant's state.put of one key read back as its own value; the
     completed count of session_stats() exact for each tenant; a held
     result replicated to both workers surviving the SIGKILL of one
     holder, value() bit for bit with no reconstruction and the killed
     worker relaunched;
  6e. the multi-pod DiLoCo driver (``repro_torch.launch.train``) from
     phase 3's parameters: two xLSTM-125M pods at full width as workers of
     plan("cluster", workers=2) (loopback, a random token, no TLS), 2
     rounds of 2 local steps at phase 5's B=8, S=512 and lr, int8 + error
     feedback, pod 0's first dispatch killed (exit 43) and re-dispatched;
     each pod round's pid (not the driver's), card and launch counts read
     in its worker (20 mlstm_scan, 4 slstm_scan, 20 mLSTM backward, 4
     sLSTM backward), its
     loss and every delta
     leaf bit for bit the same ``pod_round`` call in this process (made on
     a thread beside the driver); every leaf with a nonzero delta moved by
     the outer step; the last checkpoint restored bit for bit; every task
     frame under 1 MiB and each pod round's worker sent the round's large
     leaves as puts; each round's seconds and tokens/s, each worker's task
     and put bytes with their seconds, each pod's pull time, the
     exchange's ms and the re-dispatch's.
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
      launches) is timed, and the 128-token request's decode-path logits
      are held against the prefill step (the long requests of 4b to 4g
      cut from 512 tokens for time, ``LONG_REQUEST``).
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
  3c'. the dry run's analyzer (``repro_torch.launch.op_analysis``) held
      against that prefill on the card: the plain prefill traced on
      ``meta`` tensors of the same shapes, then run on the card under the
      analyzer and ``FlopCounterMode``: the card's FLOPs equal the meta
      trace's and ``FlopCounterMode``'s, its HBM bytes and ops counted the
      meta trace's, its argument bytes the tree's and the tokens'; the
      card's peak (``max_memory_allocated`` after a reset) within
      ``DRYRUN_PEAK_TOL`` of the trace's; the trace's roofline time no
      more than the plain prefill's measured time; and ``model_flops`` of
      the prefill over 3c's kernel prefill time as a share of the fp32
      peak, with the card's name and power limit;
  4c. the decode Server for yi-9b answering 6 short requests and one
      128-token request; one decode step at B=4 with every cache holding
      4096 positions (48 decode_attention launches) with its device time,
      wall time and idle share; the 128-token request's decode-path logits
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
      one 128-token request; one decode step at B=4 with every cache
      holding 4096 positions (24 decode_attention launches) with its
      device time, wall time and idle share; the 128-token request's
      decode-path logits at every step held by the same rule against a
      prefill that cannot drop (capacity factor n_experts), beside the
      assignments the real prefill drops on that prompt.
  7a. the multi-device runtime's expert parallelism: (i) right after 3d,
      the same prefill through ``Model(cfg, mesh=...)`` on a (1, 1)
      ("data", "model") mesh in this process (NCCL, world size 1; 24
      flash_attention launches), its logits held against 3d's kernel run
      by the flip-aware rule with 3d's yardstick; (ii) once qwen2-moe is
      freed, two spawned processes as the ranks of a (1, 2) mesh on gloo
      (NCCL refuses two ranks on one GPU) sharing the card, each drawing
      the tree as 3d does but keeping its 32 of the 64 padded experts
      (every leaf's integer digest equal to 3d's tree's, its own expert
      rows), 24 flash_attention launches in each rank's process (pid not
      this one's, the card's name), the logits held against 3d's by the
      same rule, the two ranks' logits bit for bit; each rank's prefill ms
      and peak memory;
  7b. the GPipe pipeline: Yi-9B at full width cut to 8 of its 48 layers
      (1.91 B parameters), two spawned stage processes on a (2, 1, 1)
      ("pod", "data", "model") gloo mesh, 4 layers a stage, B=8, S=512 in
      4 microbatches, remat "full": against the plain loss, its grads and
      one AdamW step of the same 8-layer tree in one process (each rank
      runs it in turn before the pipeline, keeping its stage's part), the
      pipelined loss within 1e-4, every grad leaf within 1e-3 of its
      scale, the params after one ``make_pipeline_train_step`` within
      1e-3 of each leaf's largest where the reference's grad decides the
      step's sign (elsewhere within the most two first Adam steps can
      part), 32 flash_attention launches a stage a step, one hand-off each
      way a microbatch, with its bytes and seconds through the host.
Then DeepSeekMoE-16B (28 layers, a dense first one; 64 routed experts,
top-6, 2 shared; 16.38 B fp32 parameters) takes it:
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
      answering 6 short requests and one 128-token request; one decode step
      at B=4 with every bf16 cache holding 4096 positions (60
      decode_attention launches) with its device time, wall time and idle
      share; the 128-token request's decode-path logits held against the
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
      of 128 tokens through the absorbed-latent
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
Last, with no model on the card:
  8. the dry-run CLI (``python -m repro_torch.launch.dryrun``) on this
     machine's host, its entry point called in this process, for
     ``DRYRUN_CELLS`` (yi-9b x train_4k on the 512-rank mesh and
     xlstm-125m x decode_32k on the 256-rank one): each record
     ``status: "ok"`` with every count positive.
Each phase prints its seconds. ``--phases`` runs the phases it names
(``ALONE``: 2m, phase 2's mLSTM backward case; 3c' with 3c's tree and
timing before it, 5 with phase 3's tree before it, and 8) alone after
phase 1, and prints no result. The line before the last is a JSON object
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
# within TOL_DECODE_REL.
MLA_S = 4096
MLA_DEC_B = 4
# The Servers of the large models (phases 4b to 4g) answer a long request
# of LONG_REQUEST tokens, cut from 512 for time. Their decode steps are
# host-bound at ~50-200 ms a step (~1,300 launches a step at Yi-34B, ~75
# a layer over MiniCPM3's 62), and the long prompt is fed a token a step
# twice, by the Server and by the decode-path check: at 512 tokens the
# phases took 1075 s of the 1200 s a run is allowed on a slow host (4g
# alone 193 s at 512 on another); at 256, with phases 6c and 6d grown by
# lineage and the serving tier, the run took 1023 s. xLSTM's Server
# (phase 4) keeps 512. The cut requests still draw 512 tokens, so later
# phases see the same data.
LONG_REQUEST = 128
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
# the sLSTM backward kernel (phase 2, at the train shape): each of the
# eight gradients' largest error, against autograd of the plain version in
# fp64 and against the plain backward on the kernel's own saved states,
# over that gradient's largest fp64 value, is at most this many times the
# fp32 recompute's error of the first kind (autograd of the plain version
# in fp32, the backward the kernel replaces; at least one fp32 ulp). The
# two fp32 backwards sum in other orders, through 512 steps, so their
# errors are alike in size; a dropped adjoint or a tie sent one way moves
# a gradient by far more than ten times
SLSTM_BWD_YARDSTICKS = 10
# the mLSTM backward kernel (phase 2, at the train shape), the same rule:
# each of dq, dk, dv, di and df within this many times the fp32
# recompute's error (at least one fp32 ulp). The kernel walks chunks of 16
# rows where the recompute walks 256, and sums C_c G and dC v over column
# tiles, so its errors are of the recompute's size but not its bits (at
# D=64 to 384 on the CPU, the kernel's arithmetic read 0.3 to 1.4 times
# it against fp64 and up to 2.8 times against the plain backward); a
# dropped term or a tie sent one way moves a gradient by far more
MLSTM_BWD_YARDSTICKS = 10
# phase 3c': the card's peak memory against the dry-run trace's, as a
# share of the trace's peak plus bytes (the caching allocator's rounding,
# library workspaces and temporaries inside a kernel, which no op shows)
DRYRUN_PEAK_TOL = (0.02, 256 * 2 ** 20)
# phase 8: the dry-run cells run on the host
DRYRUN_CELLS = (("yi-9b", "train_4k", "multi"),
                ("xlstm-125m", "decode_32k", "single"))
TOL_TRAIN_LOSS_REL = 1e-4
TOL_TRAIN_GRAD_REL = 1e-3
TOL_TRAIN_CURVE_REL = 1e-3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


_started = time.perf_counter()
_last_mark = [_started]


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


def main(argv: list | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", nargs="+", choices=sorted(ALONE),
                    help="run only these phases after phase 1 (the build)")
    args = ap.parse_args(argv)
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
    if args.phases:
        for name in args.phases:
            ALONE[name](smi)
        return 0
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
    slstm_backward_case(dev, kernels, NH, HD, smi)
    mlstm_backward_case(dev, kernels, H, D, smi)
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
    for name in ("mlstm_scan_backward", "slstm_scan_backward"):
        kernels[name]["launches"] = 0                # phase 5 sets them
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
    training_phase(dev, cfg, params, smi, kernels)
    phase_done("5")

    # -- 6. the Future API on the card ---------------------------------------
    future_api_phase(dev, cfg, params, prefill, tokens, first, prefill_ms,
                     smi)
    phase_done("6")

    # -- 6b. the same prefill in worker processes -----------------------------
    processes_phase(cfg, params, prefill, tokens, first, smi)
    phase_done("6b")

    # -- 6c. the same prefill on socket-connected cluster workers ------------
    cluster_phase(cfg, model, params, prefill, tokens, first, smi)
    phase_done("6c")

    # -- 6d. the multi-tenant serving tier over the same cluster kind --------
    serving_phase(cfg, model, params, prefill, tokens, first, smi)
    del first, tokens, prefill
    phase_done("6d")

    # -- 6e. two pods of the multi-pod driver as cluster workers -------------
    multipod_phase(cfg, params, smi)
    phase_done("6e")

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

    # -- 8. the dry run on this host, no model on the card -------------------
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_cells_phase()
    phase_done("8")

    print(f"chip_smoke: {time.perf_counter() - _started:.1f} s in all, "
          f"the build included (limit 1200 s)")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serve_traffic(server, rng, vocab: int, long_len: int = 512,
                  keep: "int | None" = None) -> tuple[dict, list]:
    """Six 4-token requests and one of ``long_len`` tokens (drawn from
    ``rng``; only its first ``keep`` sent when given, so that ``rng``
    moves on as before the long request was cut and the later phases draw
    the same data), submitted as futures under plan("threads") to
    ``server``'s running loop, each printed as it resolves; checks that
    each gets 16 tokens.
    Returns the replies by request and the long prompt."""
    import repro_torch.core as rc
    rc.plan("threads", workers=4)
    loop = threading.Thread(target=server.serve_loop, daemon=True)
    loop.start()
    prompts = [rng.integers(0, vocab, size=4).tolist() for _ in range(6)]
    prompts.append(rng.integers(0, vocab, size=long_len).tolist()[:keep])
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


SLSTM_GRADS = ("z", "i", "f", "o", "r_z", "r_i", "r_f", "r_o")


def slstm_backward_case(dev, kernels: dict, nh: int, hd: int,
                        smi: str) -> None:
    """Phase 2's sLSTM backward at the train shape (B=8, S=512): the
    training forward's h against the store-free forward's, bit for bit;
    the backward kernel's eight grads against the plain backward on the
    kernel's own saved states and against autograd of the plain version in
    fp64, within SLSTM_BWD_YARDSTICKS times the fp32 recompute's error
    (printed beside); the kernel's ms, its bound and launch geometry, the
    whole backward's (the kernel and the dR product) and the plain
    backward's ms."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm_scan as SK

    b, s = TRAIN_B, TRAIN_S
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    args = [rand(b, nh, s, hd) for _ in range(4)] + [
        rand(nh, hd, hd, scale=hd ** -0.5) for _ in range(4)]
    rs = args[4:]
    grad_h = rand(b, nh, s, hd)
    geo = SK.launch_geometry(b, nh, hd)
    print(f"slstm_scan backward (B,NH,S,HD)={(b, nh, s, hd)}: the forward's "
          f"geometry, clusters of {geo.cl} CTAs x {geo.threads} threads, "
          f"{geo.rb} batch rows a cluster, {geo.n_clusters} clusters, at "
          f"most {SK.backward_resident_clusters(geo)} backward clusters "
          f"resident")
    with torch.no_grad():
        h, states = SK._launch_train(*args)
        same = torch.equal(h, SK._launch(*args))
    print(f"  training forward's h against the store-free forward's: "
          f"{'bit for bit' if same else 'DIFFERENT'}")
    check(same, "the training forward's h is the store-free forward's")
    got = SK._launch_backward(h, states, *rs, grad_h)
    torch.cuda.synchronize()
    plain = SK.plain_backward(h, states, *rs, grad_h)
    wide = [a.double().requires_grad_(True) for a in args]
    want = [g.float() for g in torch.autograd.grad(
        SK.plain(*wide), wide, grad_h.double())]
    fresh = [a.clone().requires_grad_(True) for a in args]
    yard = torch.autograd.grad(SK.plain(*fresh), fresh, grad_h)
    del wide, fresh
    max_abs = 0.0
    for name, g, p, w, y in zip(SLSTM_GRADS, got, plain, want, yard):
        scale = max(w.abs().max().item(), 1e-30)
        e_y = (y - w).abs().max().item() / scale
        limit = SLSTM_BWD_YARDSTICKS * max(e_y, 2.0 ** -23)
        e_w = (g - w).abs().max().item() / scale
        e_p = (g - p).abs().max().item() / max(p.abs().max().item(), 1e-30)
        ok = bool(torch.isfinite(g).all()) and e_w <= limit and e_p <= limit
        max_abs = max(max_abs, (g - p).abs().max().item())
        print(f"  d{name}: against fp64 {e_w:.3e}, against the plain "
              f"backward {e_p:.3e} of the largest {scale:.3e}; yardstick, "
              f"the fp32 recompute against fp64, {e_y:.3e}; limit {limit:.3e}"
              f" ({SLSTM_BWD_YARDSTICKS}x) {'ok' if ok else 'FAIL'}")
        check(ok, f"the sLSTM backward kernel's d{name} is off")
    del plain, want, yard, got
    # the kernel's own work: the R^T matvecs (the cell is negligible), its
    # saved planes, grad_h and R read once, dpre written once; the whole
    # backward adds the dR products and reads h
    seq = b * nh * s * hd
    k_bound = bound(8.0 * seq * hd, 4.0 * (12 * seq + 4 * nh * hd * hd))
    w_bound = bound(16.0 * seq * hd, 4.0 * (13 * seq + 8 * nh * hd * hd))
    kernels["slstm_scan_backward"] = dict(
        name="slstm_scan_backward", route="cuda",
        source="src/repro_torch/kernels/csrc/slstm_scan.cu",
        replaces="src/repro/kernels/slstm_scan.py:29",
        max_abs_err=max_abs,
        ms=cuda_ms(lambda: SK._backward_kernel(h, states, *rs, grad_h), 10),
        plain_ms=cuda_ms(lambda: SK.plain_backward(h, states, *rs, grad_h),
                         1),
        bound_ms=k_bound[0], bound_by=k_bound[1], library_ms=None)
    whole = cuda_ms(lambda: SK._launch_backward(h, states, *rs, grad_h), 10)
    dr_ms = cuda_ms(lambda: ref.slstm_recurrent_grads(h, states[:4]), 10)
    kr = kernels["slstm_scan_backward"]
    print(f"  slstm_scan backward kernel: {kr['ms']:.4f} ms a launch, "
          f"{kr['ms'] * 1e3 / s:.4f} us a step, bound {kr['bound_ms']:.4f} "
          f"ms ({kr['bound_by']}); with the dR product {whole:.4f} ms (the "
          f"product alone {dr_ms:.4f} ms), bound {w_bound[0]:.4f} ms "
          f"({w_bound[1]}); the plain backward {kr['plain_ms']:.2f} ms "
          f"({smi})")
    del h, states, args, rs, grad_h


MLSTM_GRADS = ("q", "k", "v", "i", "f")


def mlstm_backward_case(dev, kernels: dict, h: int, d: int,
                        smi: str) -> None:
    """Phase 2's mLSTM backward at the train shape (B=8, S=512): the
    training forward's h against the store-free forward's, bit for bit,
    and the bytes it saves; the backward's five grads (dq, dk, dv from the
    kernel and the sums of its partial planes, di and df from them)
    against the plain backward on the kernel's own saved states and
    against autograd of the plain version in fp64, within
    MLSTM_BWD_YARDSTICKS times the fp32 recompute's error (printed
    beside); the kernel's ms, its bound and launch geometry, the whole
    backward's ms and the plain backward's."""
    import torch

    from repro_torch.kernels import mlstm_scan as MK

    b, s = TRAIN_B, TRAIN_S
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def rand(*shape, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) + shift

    args = [rand(b, h, s, d) for _ in range(3)] + [
        rand(b, h, s), rand(b, h, s, shift=2.0)]
    grad_h = rand(b, h, s, d)
    fgeo = MK.launch_geometry(b, h, d)
    geo = MK.launch_geometry(b, h, d, backward=True)
    print(f"mlstm_scan backward (B,H,S,D)={(b, h, s, d)}: DV={geo.dv} "
          f"columns of dC a CTA (the forward's {fgeo.dv}), {geo.grid} CTAs "
          f"x {geo.threads} threads, {geo.ctas_per_sm} CTA(s) per SM on "
          f"{geo.n_sms} SMs, {geo.waves} wave(s), {geo.smem_bytes} B of "
          f"shared memory a CTA; dq and dk in {d // geo.dv} partial planes")
    with torch.no_grad():
        hh, states = MK._launch_train(*args)
        same = torch.equal(hh, MK._launch(*args))
    saved = sum(x.numel() * x.element_size() for x in states)
    print(f"  training forward's h against the store-free forward's: "
          f"{'bit for bit' if same else 'DIFFERENT'}; saved states "
          f"{saved / 1e9:.3f} GB a layer (C at each chunk's start "
          f"{states[0].numel() * 4 / 1e9:.3f} GB)")
    check(same, "the mLSTM training forward's h is the store-free "
                "forward's")
    got = MK._launch_backward(*args, hh, states, grad_h)
    torch.cuda.synchronize()
    plain = MK.plain_backward(*args, hh, states, grad_h, cs=MK.CHUNK)
    wide = [a.double().requires_grad_(True) for a in args]
    want = [g.float() for g in torch.autograd.grad(
        MK.plain(*wide, cs=256), wide, grad_h.double())]
    fresh = [a.clone().requires_grad_(True) for a in args]
    yard = torch.autograd.grad(MK.plain(*fresh, cs=256), fresh, grad_h)
    del wide, fresh
    max_abs = 0.0
    for name, g, p, w, y in zip(MLSTM_GRADS, got, plain, want, yard):
        scale = max(w.abs().max().item(), 1e-30)
        e_y = (y - w).abs().max().item() / scale
        limit = MLSTM_BWD_YARDSTICKS * max(e_y, 2.0 ** -23)
        e_w = (g - w).abs().max().item() / scale
        e_p = (g - p).abs().max().item() / max(p.abs().max().item(), 1e-30)
        ok = bool(torch.isfinite(g).all()) and e_w <= limit and e_p <= limit
        max_abs = max(max_abs, (g - p).abs().max().item())
        print(f"  d{name}: against fp64 {e_w:.3e}, against the plain "
              f"backward {e_p:.3e} of the largest {scale:.3e}; yardstick, "
              f"the fp32 recompute against fp64, {e_y:.3e}; limit {limit:.3e}"
              f" ({MLSTM_BWD_YARDSTICKS}x) {'ok' if ok else 'FAIL'}")
        check(ok, f"the mLSTM backward kernel's d{name} is off")
    del plain, want, yard, got
    # the kernel's own work: per row 4 D^2 FMAs (C_c G, dC v, dC^T k and
    # the rank-16 update of dC) and 5 L D for the chunk's L x L products
    # (q.k, G.v, and their parts of dq, dk, dv), L = 16; q, k, v, h,
    # grad_h, the gates and the saved states read once, dq, dk, dv written
    rows, nc = b * h * s, s // MK.CHUNK
    flops = 2.0 * rows * (4 * d * d + 5 * MK.CHUNK * d)
    nbytes = 4.0 * (8 * rows * d + 4 * rows
                    + b * h * nc * (d * d + d + 1))
    k_bound = bound(flops, nbytes)
    kernels["mlstm_scan_backward"] = dict(
        name="mlstm_scan_backward", route="cuda",
        source="src/repro_torch/kernels/csrc/mlstm_scan.cu",
        replaces="src/repro/kernels/mlstm_scan.py:29",
        max_abs_err=max_abs,
        ms=cuda_ms(lambda: MK._backward_kernel(*args, hh, states, grad_h),
                   10),
        plain_ms=cuda_ms(lambda: MK.plain_backward(
            *args, hh, states, grad_h, cs=MK.CHUNK), 1),
        bound_ms=k_bound[0], bound_by=k_bound[1], library_ms=None)
    whole = cuda_ms(lambda: MK._launch_backward(*args, hh, states, grad_h),
                    10)
    fwd_ms = cuda_ms(lambda: MK._launch_train(*args), 10)
    kr = kernels["mlstm_scan_backward"]
    print(f"  mlstm_scan backward kernel: {kr['ms']:.4f} ms a launch, bound "
          f"{kr['bound_ms']:.4f} ms ({kr['bound_by']}: {flops / 1e9:.2f} "
          f"GFLOP, {nbytes / 1e9:.3f} GB); with the plane sums and the gate "
          f"grads {whole:.4f} ms; the training forward {fwd_ms:.4f} ms; the "
          f"plain backward {kr['plain_ms']:.2f} ms ({smi})")
    del hh, states, args, grad_h


class PlainSlstmCalls:
    """While active, counts the plain sLSTM's work: each step of the
    plain cell (``ref._slstm_cell``, which every plain sLSTM forward and
    its autograd recompute runs) and each call of the plain backward."""

    def _targets(self) -> list:
        from repro_torch.kernels import ref
        from repro_torch.kernels import slstm_scan as SK
        return [(ref, "_slstm_cell"), (ref, "slstm_scan_bwd_ref"),
                (SK, "plain_backward")]

    def __enter__(self):
        self.count = 0
        self._saved = [(mod, name, getattr(mod, name))
                       for mod, name in self._targets()]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._counted(fn))
        return self

    def _counted(self, fn):
        def call(*args, **kwargs):
            self.count += 1
            return fn(*args, **kwargs)
        return call

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class PlainMlstmCalls(PlainSlstmCalls):
    """While active, counts the plain mLSTM's work: each plain chunkwise
    forward (``ref._mlstm_chunks``, which ``mlstm_chunkwise``, its autograd
    recompute and the forward with states run) and each call of the plain
    backward."""

    def _targets(self) -> list:
        from repro_torch.kernels import mlstm_scan as MK
        from repro_torch.kernels import ref
        return [(ref, "_mlstm_chunks"), (ref, "mlstm_chunkwise_bwd_ref"),
                (MK, "plain_backward")]


def training_phase(dev, cfg, params, smi: str,
                   kernels: "dict | None" = None) -> None:
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
    # path: the loss, every grad leaf, the launches forward and backward,
    # the plain sLSTM's steps and backward calls
    def counts():
        return {"mlstm_scan": MK.launches, "slstm_scan": SK.launches,
                "mlstm_scan_backward": MK.backward_launches,
                "slstm_scan_backward": SK.backward_launches}

    runs = {}
    for impl in ("hopper", "plain"):
        model = Model(cfg, kernel_impl=impl)
        leafs = tree_map(lambda p: p.detach().requires_grad_(True), params)
        MK.launches = SK.launches = 0
        MK.backward_launches = SK.backward_launches = 0
        with PlainSlstmCalls() as plain_s, PlainMlstmCalls() as plain_m:
            loss, _ = model.loss(leafs, batch)
            torch.cuda.synchronize()
            fwd = counts()
            grads = torch.autograd.grad(loss, list(leaves(leafs)))
            torch.cuda.synchronize()
        bwd = {k: n - fwd[k] for k, n in counts().items()}
        runs[impl] = (loss.item(), grads, fwd, bwd,
                      (plain_s.count, plain_m.count))
        del leafs, loss
    k_loss, k_grads, fwd, bwd, k_plain = runs["hopper"]
    p_loss, p_grads, p_fwd, p_bwd, p_plain = runs.pop("plain")
    print(f"train step (B,S)={(B_, S_)} launches with the kernels: forward "
          f"{fwd}, backward {bwd}, plain sLSTM steps and backward calls, "
          f"plain mLSTM forwards and backward calls {k_plain}; plain path: "
          f"forward {p_fwd}, backward {p_bwd}, plain calls {p_plain}")
    check(fwd == {"mlstm_scan": n_m, "slstm_scan": n_s,
                  "mlstm_scan_backward": 0, "slstm_scan_backward": 0}
          and bwd == {"mlstm_scan": 0, "slstm_scan": 0,
                      "mlstm_scan_backward": n_m, "slstm_scan_backward": n_s},
          f"a train step must launch mlstm_scan {n_m}x and slstm_scan "
          f"{n_s}x in the forward, the mLSTM backward kernel {n_m}x and the "
          f"sLSTM backward kernel {n_s}x in the backward and nothing else")
    check(k_plain == (0, 0), "a hopper train step runs no plain sLSTM and "
                             "no plain mLSTM")
    check(p_plain == (n_s * S_, n_m),
          "the counts of plain sLSTM steps and plain mLSTM forwards count")
    check(p_fwd == p_bwd == dict.fromkeys(p_fwd, 0),
          "the plain path launches no kernel")
    if kernels is not None:
        for name in ("mlstm_scan_backward", "slstm_scan_backward"):
            kernels[name]["launches"] = bwd[name]
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
            MK.backward_launches = SK.backward_launches = 0
            t0 = time.perf_counter()
            state, history = trainer.run(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            curves[run] = [h["loss"] for h in history]
            print(f"Trainer, {run}: {TRAIN_STEPS} steps in {wall:.2f} s, "
                  f"losses {curves[run]}, launches mlstm_scan "
                  f"{MK.launches}, its backward {MK.backward_launches}, "
                  f"slstm_scan {SK.launches}, its backward "
                  f"{SK.backward_launches}")
            if run == "hopper":
                check((MK.launches, MK.backward_launches, SK.launches,
                       SK.backward_launches)
                      == (TRAIN_STEPS * n_m, TRAIN_STEPS * n_m,
                          TRAIN_STEPS * n_s, TRAIN_STEPS * n_s),
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

    # the share of the kernel step's backward spent in each kernel's
    # backward at the train step's shapes: each backward kernel and,
    # beside it, the recompute through the plain version it replaced
    from repro_torch.kernels.autograd import recompute
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
    step_bwd = times["hopper"][2]
    for name, (mod, count, args) in cases.items():
        kernel_way = {"slstm_scan": "the backward kernel and the dR product",
                      "mlstm_scan": "the backward kernel, its plane sums "
                                    "and the gate grads"}[name]
        ways = {kernel_way: lambda: getattr(mod, name)(*args),
                "recompute through the plain version and its autograd":
                lambda: recompute(mod._launch, mod.plain, *args)}
        for way, fn in ways.items():
            out = fn()
            g = torch.randn(out.shape, generator=gen, device=dev)
            ms = cuda_ms(lambda: torch.autograd.grad(out, args, g,
                                                     retain_graph=True), 2)
            print(f"  {name} backward, {way}, at {tuple(args[0].shape)}: "
                  f"{ms:.2f} ms a call, {count} calls a step = "
                  f"{count * ms:.1f} ms, {count * ms / step_bwd:.3f} of the "
                  f"kernel step's backward and optimiser ({step_bwd:.1f} ms;"
                  f" {smi})")
            del out, g
        del args
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


class PutTally:
    """The parent's end of one worker's pipe, counting the payload bytes
    of the ``put`` messages sent through it."""

    def __init__(self, conn):
        self._conn = conn
        self.put_bytes = 0

    def send(self, msg):
        if msg[0] == "put":
            self.put_bytes += len(msg[2])
        self._conn.send(msg)

    def __getattr__(self, name):
        return getattr(self._conn, name)


#: seconds any one wait on a worker may take in phase 6b (a cold worker
#: imports torch, starts CUDA and decodes the 0.62 GB of parameters)
WORKER_WAIT = 300.0


def bounded(fn, timeout: float):
    """``fn()`` on a thread of its own, waited for at most ``timeout``
    seconds: a call with no timeout of its own (``future_map``) that hangs
    fails the phase instead of the run. Its error is raised here."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as exc:                 # noqa: BLE001
            out["error"] = exc

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    check(not th.is_alive(), f"the call finished within {timeout:.0f} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def processes_phase(cfg, params, prefill, tokens, first, smi: str) -> None:
    """Phase 6b: the xLSTM prefill in worker processes under
    plan("processes"): prefill futures, future_map, a dying worker and the
    healed pool, and the shared state over the pipe."""
    import torch

    import repro_torch.core as rc
    from repro_torch.core import state
    from repro_torch.core.backends import processes as P
    from repro_torch.tree import leaves

    n_m = sum(kind == "mlstm" for kind in cfg.layer_pattern)
    n_s = sum(kind == "slstm" for kind in cfg.layer_pattern)
    want_launches = {"mlstm_scan": n_m, "slstm_scan": n_s}
    card = torch.cuda.get_device_name(0)
    nbytes = sum(p.numel() * p.element_size() for p in leaves(params))

    tallies = {}                     # worker id -> its PutTally
    spawn = P.ProcessBackend._spawn

    def counted_spawn(self, defer=False):
        w = spawn(self, defer=defer)
        w.parent_conn = tallies[w.wid] = PutTally(w.parent_conn)
        return w

    def sent() -> dict:
        return {wid: t.put_bytes for wid, t in tallies.items()}

    def body(b):
        # runs in a worker: its own launch counters, its own CUDA context
        import os

        import torch
        from repro_torch.kernels import mlstm_scan as MK
        from repro_torch.kernels import slstm_scan as SK
        MK.launches = SK.launches = 0
        out = prefill(params, b)
        torch.cuda.synchronize()
        return (out, {"mlstm_scan": MK.launches, "slstm_scan": SK.launches},
                os.getpid(), torch.cuda.get_device_name(0))

    # the workers' payload caches sized to the model: at their 256 MiB
    # default the parameters' 0.58 GB blob is evicted by the next put, and
    # a worker would ask it back with a need (0.58 GB more) every future
    store_bytes = 2 << 30
    P.ProcessBackend._spawn = counted_spawn
    try:
        # (a) three prefill futures (B=8, S=2048) on two workers
        batch = {"tokens": tokens}
        rc.plan("processes", workers=2, blob_store_bytes=store_bytes)
        t0 = time.perf_counter()
        backend = rc.active_backend()
        print(f"plan('processes', workers=2): 2 workers up in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        holders, pids = set(), set()
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            direct_ms = (time.perf_counter() - t0) * 1e3
            before = sent()
            t0 = time.perf_counter()
            f = rc.future(body, batch)
            submit_ms = (time.perf_counter() - t0) * 1e3
            got, counts, pid, name = rc.value(f, timeout=WORKER_WAIT)
            value_ms = (time.perf_counter() - t0) * 1e3
            wid = f._handle.worker.wid
            put = sent()[wid] - before.get(wid, 0)
            print(f"processes prefill future {i} (B,S)={(B, S)} on worker "
                  f"{wid} (pid {pid}, {name}): future() returned in "
                  f"{submit_ms:.1f} ms, value() at {value_ms:.1f} ms, "
                  f"direct call {direct_ms:.1f} ms; put bytes sent "
                  f"{put}; launches {counts} ({smi})")
            check(pid != os.getpid(), "the prefill runs in another process")
            check(name == card, "the worker computes on the card")
            check(counts == want_launches,
                  f"a prefill future in a worker launches mlstm_scan {n_m}x "
                  f"and slstm_scan {n_s}x")
            check(torch.equal(got, first),
                  "the worker's prefill tokens are phase 3's bit for bit")
            if wid in holders:
                check(put == 0, "a worker that holds the parameters is "
                      "sent no put")
            else:
                check(put > nbytes // 2, "a cold worker is sent the "
                      "parameters")
                holders.add(wid)
            pids.add(pid)
        del got

        # (b) future_map over phase 6's four batches of B=2, cold then warm
        rng6 = np.random.default_rng(SEED)
        batches = [{"tokens": torch.from_numpy(rng6.integers(
            0, cfg.vocab_size, size=(2, S))).to(tokens.device)}
            for _ in range(4)]
        rc.plan("sequential")
        seq = bounded(lambda: rc.future_map(lambda b: prefill(params, b),
                                            batches), WORKER_WAIT)
        torch.cuda.synchronize()
        rc.plan("processes", workers=2, blob_store_bytes=store_bytes)
        for run in ("cold", "warm"):
            before = sent()
            t0 = time.perf_counter()
            outs = bounded(lambda: rc.future_map(body, batches),
                           WORKER_WAIT)
            wall = (time.perf_counter() - t0) * 1e3
            total = {k: sum(o[1][k] for o in outs) for k in want_launches}
            same = all(torch.equal(o[0], t) for o, t in zip(outs, seq))
            workers = sorted({o[2] for o in outs})
            put = {w: sent()[w] - before.get(w, 0) for w in sent()}
            print(f"  future_map of the prefill over 4 batches (B,S)="
                  f"{(2, S)} on processes ({run}): {wall:.1f} ms, worker "
                  f"pids {workers}, launches {total}, put bytes {put}, "
                  f"tokens bit for bit the sequential ones: {same}")
            check(same and len(outs) == 4,
                  "future_map on processes gives the sequential tokens")
            check(total == {k: 4 * n for k, n in want_launches.items()},
                  "future_map on processes launches each kernel once a "
                  "block a batch")
        del outs, seq, batches

        # (c) a dying worker, and the healed pool
        died = None
        f = rc.future(lambda: os._exit(7))
        try:
            rc.value(f, timeout=WORKER_WAIT)
        except rc.WorkerDiedError as exc:
            died = exc
        print(f"  a worker calling os._exit: {type(died).__name__}: {died}")
        check(died is not None, "a dying worker raises WorkerDiedError")
        before = sent()
        t0 = time.perf_counter()
        f = rc.future(body, batch)
        got, counts, pid, _ = rc.value(f, timeout=WORKER_WAIT)
        value_ms = (time.perf_counter() - t0) * 1e3
        wid = f._handle.worker.wid
        put = sent()[wid] - before.get(wid, 0)
        print(f"  the healed worker {wid} (pid {pid}, new: "
              f"{pid not in pids}): prefill value() at {value_ms:.1f} ms, "
              f"put bytes {put}, launches {counts}")
        check(pid not in pids and pid != os.getpid(),
              "the next prefill runs on the healed worker")
        check(torch.equal(got, first) and counts == want_launches,
              "the healed worker's prefill is phase 3's bit for bit")
        check(put > nbytes // 2, "the healed worker's cold cache is sent "
              "the parameters again")
        del got

        # (d) shared state over the pipe
        state.reset()
        fs = [rc.future(lambda: state.add("tokens", 2 * S))
              for _ in range(8)]
        rc.value(fs, timeout=WORKER_WAIT)
        folded = state.read("tokens")
        print(f"  state.add from 8 futures on processes: {folded} "
              f"(value, version); want ({8 * 2 * S}, 8)")
        check(folded == (8 * 2 * S, 8), "the state fold over the pipe is "
              "exact")
        table = params["embed"]["table"]
        state.put("embed", table)

        def doubler():
            from repro_torch.core import state
            t = state.get("embed")
            state.put("embed2", t * 2)
            return t.device.type, tuple(t.shape), t.dtype

        t0 = time.perf_counter()
        where = rc.value(rc.future(doubler), timeout=WORKER_WAIT)
        rt_ms = (time.perf_counter() - t0) * 1e3
        back = state.get("embed2")
        same = back.is_cuda and torch.equal(back, table * 2)
        print(f"  the embedding table ({table.numel() * 4 / 1e6:.1f} MB) "
              f"through state: in the worker {where}, doubled and put back "
              f"in {rt_ms:.1f} ms, bit for bit on the card: {same}")
        check(where[0] == "cuda" and same,
              "the table round-trips the blob path bit for bit")
        del back, table
        state.reset()
    finally:
        P.ProcessBackend._spawn = spawn
        rc.shutdown()
    torch.cuda.synchronize()


def cluster_phase(cfg, model, params, prefill, tokens, first,
                  smi: str) -> None:
    """Phase 6c: the xLSTM prefill on socket-connected workers under
    plan("cluster"), the paper's PSOCK cluster: prefill futures, a held
    result chained on its holder and peer-fetched by the other worker, a
    killed worker and its relaunch, a lost sole holder, and the shared
    state over the socket."""
    import signal
    import tempfile

    import torch

    import repro_torch.core as rc
    from repro_torch.core import state
    from repro_torch.core.backends import transport
    from repro_torch.core.backends.blobstore import RemoteValue
    from repro_torch.tree import leaves

    n_m = sum(kind == "mlstm" for kind in cfg.layer_pattern)
    n_s = sum(kind == "slstm" for kind in cfg.layer_pattern)
    want_launches = {"mlstm_scan": n_m, "slstm_scan": n_s}
    card = torch.cuda.get_device_name(0)
    nbytes = sum(p.numel() * p.element_size() for p in leaves(params))
    batch = {"tokens": tokens}
    marks = tempfile.mkdtemp(prefix="chip-smoke-6c-")
    gaps = {}                        # pid -> longest heartbeat gap, s

    def body(b):
        # runs in a worker: its own launch counters, its own CUDA context
        import os

        import torch
        from repro_torch.kernels import mlstm_scan as MK
        from repro_torch.kernels import slstm_scan as SK
        MK.launches = SK.launches = 0
        out = prefill(params, b)
        torch.cuda.synchronize()
        return (out, {"mlstm_scan": MK.launches, "slstm_scan": SK.launches},
                os.getpid(), torch.cuda.get_device_name(0))

    def note_gaps(backend):
        for pid, gap in backend.heartbeat_gaps().items():
            gaps[pid] = max(gaps.get(pid, 0.0), gap)

    def wait_for(pred, what: str) -> None:
        deadline = time.monotonic() + WORKER_WAIT
        while not pred():
            check(time.monotonic() < deadline, f"{what} within "
                  f"{WORKER_WAIT:.0f} s")
            time.sleep(0.01)

    def holder_pid(backend, digest) -> int:
        wids = backend.locations(digest)
        with backend._pool_cv:
            return next(w.meta["pid"] for w in backend._all
                        if w.wid in wids)

    # the workers' blob stores sized to the model, as in phase 6b; no TLS:
    # the card's host may lack the openssl binary (the CPU tests hold TLS)
    token = os.urandom(16).hex()
    print("plan('cluster', workers=2): local launcher over 127.0.0.1, a "
          "random token, no TLS (held by the CPU tests)")
    try:
        t0 = time.perf_counter()
        rc.plan("cluster", workers=2, blob_store_bytes=2 << 30, token=token,
                connect_timeout=WORKER_WAIT)
        backend = bounded(rc.active_backend, WORKER_WAIT)
        print(f"  2 workers dialed back in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms, pids "
              f"{backend.worker_pids()}")

        # (a) three prefill futures (B=8, S=2048)
        holders, pids = set(), set()
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            direct_ms = (time.perf_counter() - t0) * 1e3
            before = backend.put_bytes()
            before_s = backend.put_seconds()
            t0 = time.perf_counter()
            f = bounded(lambda: rc.future(body, batch), WORKER_WAIT)
            submit_ms = (time.perf_counter() - t0) * 1e3
            got, counts, pid, name = rc.value(f, timeout=WORKER_WAIT)
            value_ms = (time.perf_counter() - t0) * 1e3
            put = backend.put_bytes()[pid] - before.get(pid, 0)
            put_s = backend.put_seconds()[pid] - before_s.get(pid, 0.0)
            rate = f", the put at {put / put_s / 1e9:.3f} GB/s over " \
                f"loopback ({put_s * 1e3:.1f} ms)" if put else ""
            print(f"cluster prefill future {i} (B,S)={(B, S)} on pid {pid} "
                  f"({name}): future() returned in {submit_ms:.1f} ms, "
                  f"value() at {value_ms:.1f} ms, direct call "
                  f"{direct_ms:.1f} ms; put bytes sent {put}{rate}; "
                  f"launches {counts} ({smi})")
            check(pid != os.getpid(), "the prefill runs on a cluster worker")
            check(name == card, "the worker computes on the card")
            check(counts == want_launches,
                  f"a prefill future on a cluster worker launches "
                  f"mlstm_scan {n_m}x and slstm_scan {n_s}x")
            check(torch.equal(got, first),
                  "the worker's prefill tokens are phase 3's bit for bit")
            if pid in holders:
                check(put == 0, "a worker that holds the parameters is "
                      "sent 0 put bytes")
            else:
                check(put > nbytes // 2, "a cold worker is sent the "
                      "parameters")
                holders.add(pid)
            pids.add(pid)
        note_gaps(backend)
        del got

        # (c) a worker SIGKILLed mid-prefill, and its relaunch
        pidfile = os.path.join(marks, "victim")

        def victim(b, _p=pidfile):
            import os as _os

            import torch
            with open(_p + ".tmp", "w") as fh:
                fh.write(str(_os.getpid()))
            _os.replace(_p + ".tmp", _p)
            while True:                      # prefills until the kill lands
                prefill(params, b)
                torch.cuda.synchronize()

        before_pids = set(backend.worker_pids())
        f = rc.future(victim, batch)
        wait_for(lambda: os.path.exists(pidfile), "the victim started")
        with open(pidfile) as fh:
            victim_pid = int(fh.read())
        time.sleep(0.5)                      # inside its prefill loop
        os.kill(victim_pid, signal.SIGKILL)
        died = None
        try:
            rc.value(f, timeout=WORKER_WAIT)
        except rc.WorkerDiedError as exc:
            died = exc
        print(f"  worker {victim_pid} SIGKILLed mid-prefill: "
              f"{type(died).__name__}: {str(died)[:160]}")
        check(died is not None, "a worker killed mid-prefill raises "
              "WorkerDiedError")
        t0 = time.perf_counter()
        wait_for(lambda: len(set(backend.worker_pids()) - before_pids) == 1
                 and len(backend.worker_pids()) == 2,
                 "the killed worker was relaunched")
        new_pid = (set(backend.worker_pids()) - before_pids).pop()
        relaunch_ms = (time.perf_counter() - t0) * 1e3
        before = backend.put_bytes()
        t0 = time.perf_counter()
        f = rc.future(body, batch)
        got, counts, pid, _ = rc.value(f, timeout=WORKER_WAIT)
        value_ms = (time.perf_counter() - t0) * 1e3
        put = backend.put_bytes()[pid] - before.get(pid, 0)
        print(f"  relaunched worker pid {new_pid} up {relaunch_ms:.1f} ms "
              f"after the death was seen; its prefill (pid {pid}) value() "
              f"at {value_ms:.1f} ms, put bytes {put}, launches {counts}")
        check(pid == new_pid, "the next prefill runs on the relaunched "
              "worker")
        check(torch.equal(got, first) and counts == want_launches,
              "the relaunched worker's prefill is phase 3's bit for bit")
        note_gaps(backend)
        del got

        # (b) dataflow: a held result, chained on its holder, peer-fetched
        def last_logits(b):
            import torch
            with torch.no_grad():
                return model.apply(params, b)[0][:, -1]

        with torch.no_grad():
            want = model.apply(params, batch)[0][:, -1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = rc.future(last_logits, batch)
        run = backend.collect(f._handle)
        held_ms = (time.perf_counter() - t0) * 1e3
        rv = run.value
        check(isinstance(rv, RemoteValue), "the last-position logits stay "
              "on their worker (a RemoteValue at the driver)")
        holder = holder_pid(backend, rv.digest)
        check(len(backend.locations(rv.digest)) == 1,
              "locations() names one holder")
        transport.reset_wire_stats()
        t0 = time.perf_counter()
        pid, toks = f.then(lambda lg: (
            os.getpid(), lg.argmax(-1, keepdim=True).to(torch.int32))) \
            .value(timeout=WORKER_WAIT)
        chain_ms = (time.perf_counter() - t0) * 1e3
        wire = transport.wire_stats()
        print(f"  held logits {tuple(want.shape)} ({rv.nbytes} B) on pid "
              f"{holder} after {held_ms:.1f} ms; .then(argmax) ran on pid "
              f"{pid} in {chain_ms:.1f} ms, the driver received "
              f"{wire['bytes_recv']} B and sent {wire['bytes_sent']} B")
        check(pid == holder, "the continuation runs on the holder")
        check(wire["bytes_recv"] < 1_000_000, "under 1 MB crosses to the "
              "driver for the chain")
        check(torch.equal(toks, first), "the chain's argmax is phase 3's "
              "tokens")
        release = os.path.join(marks, "release")
        parked = os.path.join(marks, "parked")

        def park(lg, _p=parked, _r=release):
            import os as _os
            import time as _time
            open(_p, "w").close()
            while not _os.path.exists(_r):
                _time.sleep(0.005)
            return 0

        blocker = f.then(park)               # the holder is busy now
        wait_for(lambda: os.path.exists(parked), "the holder is parked")
        transport.reset_wire_stats()
        t0 = time.perf_counter()
        g = rc.future(lambda lg: (os.getpid(), lg.double().sum().item()),
                      rv)
        pid, total = rc.value(g, timeout=WORKER_WAIT)
        fetch_ms = (time.perf_counter() - t0) * 1e3
        wire = transport.wire_stats()
        open(release, "w").close()
        rc.value(blocker, timeout=WORKER_WAIT)
        print(f"  a future taking the RemoteValue ran on pid {pid} (the "
              f"holder {holder} busy) in {fetch_ms:.1f} ms by peer fetch; "
              f"the driver sent {wire['bytes_sent']} B, received "
              f"{wire['bytes_recv']} B")
        check(pid != holder and pid != os.getpid(),
              "the other worker takes the RemoteValue")
        check(wire["bytes_sent"] < rv.nbytes // 10,
              "its bytes went worker to worker, not through the driver")
        check(total == want.double().sum().item(),
              "the peer-fetched logits sum as the in-process call's")
        t0 = time.perf_counter()
        pulled = f.value(timeout=WORKER_WAIT)
        pull_ms = (time.perf_counter() - t0) * 1e3
        same = pulled.is_cuda and torch.equal(
            pulled.view(torch.int32), want.view(torch.int32))
        print(f"  value() pulled the logits onto the driver's card in "
              f"{pull_ms:.1f} ms, bit for bit the in-process call's: {same}")
        check(same, "value() pulls the in-process call's bytes bit for bit")
        note_gaps(backend)
        del pulled, want, toks, f, g, rv, run, blocker

        # (c') lineage: held logits whose only holder is SIGKILLed are
        # rebuilt by running their producing task again on a live worker
        def logged_logits(b, wide=False):
            # the launch counts go to the driver's state (the result must
            # stay the logits alone); a rebuild runs this body again
            import os as _os

            import torch
            from repro_torch.core import state as _state
            from repro_torch.kernels import mlstm_scan as _MK
            from repro_torch.kernels import slstm_scan as _SK
            _MK.launches = _SK.launches = 0
            with torch.no_grad():
                lg = model.apply(params, b)[0][:, -1]
            torch.cuda.synchronize()
            _state.extend("6c-runs", [(_os.getpid(), _MK.launches,
                                       _SK.launches)])
            return lg.double() if wide else lg

        def runs_since(n: int) -> list:
            got = state.get("6c-runs", default=[])
            return list(got)[n:]

        # two results held by one worker (the idle list is LIFO), whose
        # SIGKILL loses both: the survivor runs both producing tasks again,
        # so the parameters are sent to it at most once (encoded anew: the
        # driver's 256 MiB store does not keep the 0.58 GB)
        # (b)'s logits are in the driver's store by now: the first rebuild
        # takes the prefill of the sequences reversed, bytes no one holds;
        # the chain's parent is the logits widened to fp64 (another digest,
        # the same argmax)
        batch_r = {"tokens": tokens.flip(1).contiguous()}
        with torch.no_grad():
            want = model.apply(params, batch_r)[0][:, -1]
        torch.cuda.synchronize()
        state.reset()
        recon0 = backend.recovery_stats()["reconstructions"]
        f = rc.future(logged_logits, batch_r)
        f_wide = None
        held = {}
        for what in ("the prefill's last-position logits", "the fp64 logits"):
            if held:
                f_wide = rc.future(logged_logits, batch, wide=True)
            rv = backend.collect((f_wide or f)._handle).value
            check(isinstance(rv, RemoteValue), f"{what} are held")
            check(len(backend.locations(rv.digest)) == 1,
                  f"{what} have one holder")
            held[rv.digest] = (rv, holder_pid(backend, rv.digest))
        rv = next(iter(held.values()))[0]
        victims = {pid for _, pid in held.values()}
        survivors = set(backend.worker_pids()) - victims
        for victim in victims:
            os.kill(victim, signal.SIGKILL)
        wait_for(lambda: not any(backend.locations(d) for d in held),
                 "the holders' deaths were seen")
        n_runs = len(runs_since(0))
        before = backend.put_bytes()
        t0 = time.perf_counter()
        rebuilt = f.value(timeout=WORKER_WAIT)
        rebuild_ms = (time.perf_counter() - t0) * 1e3
        recon = backend.recovery_stats()["reconstructions"] - recon0
        reruns = runs_since(n_runs)
        resent = {pid: n - before.get(pid, 0)
                  for pid, n in backend.put_bytes().items()
                  if n - before.get(pid, 0) > 0}
        same = rebuilt.is_cuda and torch.equal(
            rebuilt.view(torch.int32), want.view(torch.int32))
        print(f"  held logits {tuple(want.shape)} ({rv.nbytes} B) and fp64 "
              f"logits, their only holder(s) {sorted(victims)} SIGKILLed "
              f"(survivors {sorted(survivors)}): value() rebuilt the "
              f"logits from lineage in {rebuild_ms:.1f} ms (reconstructions "
              f"{recon}); the producing task ran again as {reruns} (pid, "
              f"mLSTM, sLSTM launches); parameters sent again: "
              f"{'yes, ' + str(resent) + ' B' if resent else 'no'}; bit "
              f"for bit the in-process call's: {same}")
        check(recon == 1, "recovery_stats() reads exactly 1 "
              "reconstruction")
        check(len(reruns) == 1 and reruns[0][0] not in victims
              and reruns[0][1:] == (n_m, n_s),
              f"a live worker runs the producing task again, launching "
              f"mlstm_scan {n_m}x and slstm_scan {n_s}x")
        check(same, "the rebuilt logits are the in-process call's bit for "
              "bit")
        # a chain on a lost parent rebuilds the parent first
        n_runs = len(runs_since(0))
        t0 = time.perf_counter()
        toks = f_wide.then(lambda lg: lg.argmax(-1, keepdim=True).to(
            torch.int32)).value(timeout=WORKER_WAIT)
        chain_ms = (time.perf_counter() - t0) * 1e3
        recon = backend.recovery_stats()["reconstructions"] - recon0
        reruns = runs_since(n_runs)
        print(f"  .then(argmax) on the lost fp64 logits: {chain_ms:.1f} ms, "
              f"the parent rebuilt as {reruns}; reconstructions {recon}")
        check(recon == 2 and len(reruns) == 1
              and reruns[0][0] not in victims
              and reruns[0][1:] == (n_m, n_s),
              "the chain rebuilt its lost parent once")
        check(torch.equal(toks.to(first.device), first),
              "the chain on a rebuilt parent gives phase 3's tokens")
        wait_for(lambda: len(backend.worker_pids()) == 2,
                 "the pool is whole again")
        state.reset()
        del rebuilt, want, toks, f, f_wide, rv, held
        note_gaps(backend)

        # (d) shared state over the socket
        state.reset()
        fs = [rc.future(lambda: state.add("tokens", 2 * S))
              for _ in range(8)]
        rc.value(fs, timeout=WORKER_WAIT)
        folded = state.read("tokens")
        print(f"  state.add from 8 futures on cluster: {folded} "
              f"(value, version); want ({8 * 2 * S}, 8)")
        check(folded == (8 * 2 * S, 8), "the state fold over the socket is "
              "exact")
        state.reset()
        note_gaps(backend)
        worst = max(gaps.values()) if gaps else 0.0
        print(f"  longest gap between two heartbeats of any worker: "
              f"{worst:.3f} s (heartbeat_timeout {backend._hb_timeout} s; "
              f"by pid {({p: round(g, 3) for p, g in gaps.items()})})")
        check(worst < backend._hb_timeout, "no worker went silent past "
              "the heartbeat timeout")
    finally:
        rc.shutdown()
    torch.cuda.synchronize()


def serving_phase(cfg, model, params, prefill, tokens, first,
                  smi: str) -> None:
    """Phase 6d: the multi-tenant serving tier (``repro_torch.core.
    serving``): one server over a warm two-worker cluster with
    ``min_replicas=2``, two tenant sessions of different weights sending
    xLSTM prefill futures, their shared state kept apart, the completions
    attributed to each tenant, and a replicated held result surviving the
    SIGKILL of one holder without a rebuild."""
    import signal

    import torch

    import repro_torch.core as rc
    from repro_torch.core.backends.blobstore import RemoteValue
    from repro_torch.core.serving import ServingClientBackend, serve

    n_m = sum(kind == "mlstm" for kind in cfg.layer_pattern)
    n_s = sum(kind == "slstm" for kind in cfg.layer_pattern)
    want_launches = {"mlstm_scan": n_m, "slstm_scan": n_s}
    card = torch.cuda.get_device_name(0)
    batch = {"tokens": tokens}
    per_tenant = {"alice": 3, "bob": 2}

    def body(b):
        # runs in a cluster worker behind the server
        import os

        import torch
        from repro_torch.kernels import mlstm_scan as MK
        from repro_torch.kernels import slstm_scan as SK
        MK.launches = SK.launches = 0
        out = prefill(params, b)
        torch.cuda.synchronize()
        return (out, {"mlstm_scan": MK.launches, "slstm_scan": SK.launches},
                os.getpid(), torch.cuda.get_device_name(0))

    def wait_for(pred, what: str) -> None:
        deadline = time.monotonic() + WORKER_WAIT
        while not pred():
            check(time.monotonic() < deadline, f"{what} within "
                  f"{WORKER_WAIT:.0f} s")
            time.sleep(0.01)

    tokens_of = {name: os.urandom(16).hex() for name in per_tenant}
    print("serve({'workers': 2, 'min_replicas': 2}, tokens=alice, bob, "
          "tenants={'alice': {'weight': 3.0}, 'bob': {'weight': 1.0}}): "
          "over 127.0.0.1, random tokens, no TLS (held by the CPU tests)")
    sessions = {}
    srv = None
    try:
        t0 = time.perf_counter()
        srv = bounded(lambda: serve(
            {"workers": 2, "min_replicas": 2, "blob_store_bytes": 2 << 30,
             "token": os.urandom(16).hex(),
             "connect_timeout": WORKER_WAIT},
            tokens=tokens_of,
            tenants={"alice": {"weight": 3.0}, "bob": {"weight": 1.0}}),
            WORKER_WAIT)
        inner = srv.inner
        up_ms = (time.perf_counter() - t0) * 1e3
        for name in per_tenant:
            sessions[name] = ServingClientBackend(addr=srv.address,
                                                  token=tokens_of[name])
        print(f"  server on {srv.address[0]}:{srv.address[1]} with 2 "
              f"workers (pids {inner.worker_pids()}) in {up_ms:.1f} ms; "
              f"sessions {[(s.tenant, s.meta['session']) for s in sessions.values()]}")
        check([s.tenant for s in sessions.values()] == list(per_tenant),
              "each session is mapped to its tenant")

        # (a) each tenant's prefill futures. The first ones go together,
        # from a thread each: each session encodes the 0.58 GB parameter
        # dict anew (the driver's 256 MiB store does not keep it), and the
        # two encodes overlap
        firsts = {}

        def first_of(name):
            try:
                t0 = time.perf_counter()
                f = rc.future(body, batch, backend=sessions[name])
                out = rc.value(f, timeout=WORKER_WAIT)
                firsts[name] = out, (time.perf_counter() - t0) * 1e3
            except BaseException as exc:             # noqa: BLE001
                firsts[name] = exc

        t_all = time.perf_counter()
        before = inner.put_bytes()
        threads = [threading.Thread(target=first_of, args=(name,),
                                    daemon=True) for name in per_tenant]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WORKER_WAIT)
        check(sorted(firsts) == sorted(per_tenant), "each tenant's first "
              f"future resolved within {WORKER_WAIT:.0f} s")
        for out in firsts.values():
            if isinstance(out, BaseException):
                raise out
        put = {p: b - before.get(p, 0) for p, b in inner.put_bytes().items()}
        for name in per_tenant:
            (got, counts, pid, dev_name), value_ms = firsts[name]
            print(f"  {name}'s first prefill future on pid {pid} "
                  f"({dev_name}): value() at {value_ms:.1f} ms; put bytes "
                  f"sent to its worker {put.get(pid, 0)} (to each worker "
                  f"for both first futures: {put}); launches {counts} "
                  f"({smi})")
            check(counts == want_launches and dev_name == card,
                  f"{name}'s future launches mlstm_scan {n_m}x and "
                  f"slstm_scan {n_s}x on the card")
            check(torch.equal(got.to(first.device), first),
                  f"{name}'s prefill tokens are phase 3's bit for bit")
        futs = {}
        for name, n in per_tenant.items():
            futs[name] = [rc.future(body, batch, backend=sessions[name])
                          for _ in range(n - 1)]
        for name, fs in futs.items():
            for f in fs:
                got, counts, pid, _ = rc.value(f, timeout=WORKER_WAIT)
                check(counts == want_launches and torch.equal(
                    got.to(first.device), first),
                    f"each of {name}'s futures gives phase 3's tokens with "
                    f"{n_m} mLSTM and {n_s} sLSTM launches")
        print(f"  {sum(per_tenant.values())} prefill futures "
              f"({per_tenant}) in {time.perf_counter() - t_all:.1f} s, "
              f"every one phase 3's tokens with {want_launches}")

        # (b) the same key in each tenant's namespace
        for name, s in sessions.items():
            s._state.put("k", f"{name}-data")
        seen = {name: s._state.get("k") for name, s in sessions.items()}
        print(f"  state.put('k') by each tenant, read back: {seen}")
        check(seen == {name: f"{name}-data" for name in per_tenant},
              "each tenant reads back only its own value")

        # (c) completions attributed per tenant (the count is bumped by a
        # done-callback that may run after the client saw its result)
        def completed():
            return {name: s.session_stats()["tenant_stats"]["completed"]
                    for name, s in sessions.items()}
        deadline = time.monotonic() + 30.0
        while completed() != per_tenant and time.monotonic() < deadline:
            time.sleep(0.05)
        stats = {name: s.session_stats()["tenant_stats"]
                 for name, s in sessions.items()}
        print(f"  tenant_stats: {stats}")
        check(completed() == per_tenant, "session_stats' completed count "
              "is exact for each tenant")

        # (d) a held result replicated under min_replicas=2 survives the
        # SIGKILL of one holder with no rebuild
        def last_logits(b):
            import torch
            with torch.no_grad():
                return model.apply(params, b)[0][:, -1]

        with torch.no_grad():
            want = model.apply(params, batch)[0][:, -1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = rc.future(last_logits, batch, backend=inner)
        rv = inner.collect(f._handle).value
        check(isinstance(rv, RemoteValue), "the logits are held")
        wait_for(lambda: inner.recovery_stats()["replications"] >= 1
                 and len(inner.locations(rv.digest)) == 2,
                 "a replica registered")
        repl_ms = (time.perf_counter() - t0) * 1e3
        before_pids = set(inner.worker_pids())
        with inner._pool_cv:
            victim = next(w.meta["pid"] for w in inner._all
                          if w.wid in inner.locations(rv.digest))
        os.kill(victim, signal.SIGKILL)
        wait_for(lambda: len(inner.locations(rv.digest)) == 1,
                 "the holder's death was seen")
        t0 = time.perf_counter()
        pulled = f.value(timeout=WORKER_WAIT)
        pull_ms = (time.perf_counter() - t0) * 1e3
        same = pulled.is_cuda and torch.equal(
            pulled.view(torch.int32), want.view(torch.int32))
        wait_for(lambda: len(inner.worker_pids()) == 2
                 and victim not in inner.worker_pids(),
                 "the killed worker was relaunched")
        recovery = inner.recovery_stats()
        print(f"  held logits ({rv.nbytes} B) on two holders "
              f"{repl_ms:.1f} ms after submit; holder {victim} "
              f"SIGKILLed, value() pulled the survivor's copy in "
              f"{pull_ms:.1f} ms, bit for bit: {same}; recovery "
              f"{recovery}; pool {inner.worker_pids()} (was "
              f"{sorted(before_pids)})")
        check(same, "value() pulls the in-process call's bytes bit for bit")
        check(recovery["reconstructions"] == 0, "a replicated result needs "
              "no rebuild")
        del pulled, want, f, rv
    finally:
        for s in sessions.values():
            s.shutdown()
        if srv is not None:
            srv.close()
    torch.cuda.synchronize()


class PodResults:
    """Records every pod result the multi-pod driver pulls, by wrapping the
    ``value`` that ``repro_torch.launch.train`` calls (a candidate that
    raised, the node failure, is not recorded), and the wall clock at the
    call's start and end."""

    def __enter__(self):
        import repro_torch.launch.train as T
        self._mod, self._value = T, T.value
        self.results = []
        self.pulls: dict = {}     # (round, pod) -> value()'s wall clock

        def recording(f, *args, **kwargs):
            t0 = time.time()
            out = self._value(f, *args, **kwargs)
            self.results.append(out)
            self.pulls[(out["round"], out["pod"])] = (t0, time.time())
            return out
        T.value = recording
        return self

    def __exit__(self, *exc):
        self._mod.value = self._value
        return False


class FrameTally:
    """The bytes of the ``task`` and ``put`` frames the cluster driver sends
    to each worker, by the worker's pid, the seconds their ``send_frame``
    calls took (the frame's encode and the socket write) and the wall clock
    at each call's end, by wrapping ``cluster.send_frame``."""

    def __init__(self, backend):
        self._backend = backend
        self._lock = threading.Lock()
        #: pid -> [(tag, bytes, seconds, wall clock at the end), ...]
        self.frames: dict = {}

    def __enter__(self):
        import repro_torch.core.backends.cluster as C
        self._mod, self._send = C, C.send_frame

        def counting(sock, frame, lock=None):
            t0 = time.perf_counter()
            n = self._send(sock, frame, lock)
            if frame[0] in ("task", "put"):
                pid = next((w.meta.get("pid") for w in list(
                    self._backend._all) if w.sock is sock), None)
                with self._lock:
                    self.frames.setdefault(pid, []).append(
                        (frame[0], n, time.perf_counter() - t0,
                         time.time()))
            return n
        C.send_frame = counting
        return self

    def __exit__(self, *exc):
        self._mod.send_frame = self._send
        return False


#: the longest phase 6e's driver.run() may take: a redispatch that never
#: completes fails the phase
MULTIPOD_WAIT = 420.0


def multipod_phase(cfg, params, smi: str) -> None:
    """Phase 6e: the multi-pod DiLoCo driver (``repro_torch.launch.train``)
    with two xLSTM-125M pods at full width as cluster workers on the card,
    from phase 3's parameters: a node failure re-dispatched, the kernels
    launched in each pod's worker, every pod round bit for bit the same
    call in this process (made on a thread of its own while the driver
    ships the round), the outer step and the checkpoint."""
    import tempfile

    import torch

    import repro_torch.core as rc
    from repro_torch.core.backends.blobstore import PAYLOAD_REF_THRESHOLD
    from repro_torch.launch.train import (MultiPodDriver, PodRunConfig,
                                          pod_round)
    from repro_torch.tree import leaves

    steps, pods = 2, 2
    n_m = sum(kind == "mlstm" for kind in cfg.layer_pattern)
    n_s = sum(kind == "slstm" for kind in cfg.layer_pattern)
    # the forward of each local step launches the kernels, the backward
    # the backward kernels
    want_launches = {"mlstm_scan": steps * n_m, "slstm_scan": steps * n_s,
                     "mlstm_scan_backward": steps * n_m,
                     "slstm_scan_backward": steps * n_s}
    card = torch.cuda.get_device_name(0)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-6e-")
    marker = os.path.join(tmp, "pod0-die-once")
    pcfg = PodRunConfig(
        arch=cfg.name, smoke=False, pods=pods, rounds=2, local_steps=steps,
        batch=TRAIN_B, seq=TRAIN_S, lr=TRAIN_LR, compress=True,
        ckpt_dir=os.path.join(tmp, "ckpt"), fail_marker=marker,
        device="cuda", plan_kwargs={"token": os.urandom(16).hex(),
                                    "connect_timeout": WORKER_WAIT})
    initial = [p.detach().cpu().numpy() for p in leaves(params)]
    nbytes = sum(p.nbytes for p in initial)
    print(f"MultiPodDriver: {pods} pods of {cfg.name} at full width "
          f"({len(initial)} leaves, {nbytes} B fp32), {pcfg.rounds} "
          f"rounds of {steps} local steps at B={TRAIN_B}, S={TRAIN_S}, lr "
          f"{TRAIN_LR}, int8 + error feedback; plan('cluster', workers="
          f"{pods}): local launcher over 127.0.0.1, a random token, no TLS; "
          f"pod 0's first dispatch dies ({smi})")
    snaps, round_s, mine, errors = [], [], {}, []
    threads: list = []

    def in_process(rnd, snap):
        # the same calls in this process, while the driver ships the round
        try:
            for pod in range(pods):
                t0 = time.perf_counter()
                out = pod_round(cfg.name, False, snap, rnd, pod, pods, steps,
                                TRAIN_B, TRAIN_S, TRAIN_LR, pcfg.seed,
                                device="cuda")
                mine[(rnd, pod)] = (out, (time.perf_counter() - t0) * 1e3)
        except BaseException as exc:                 # noqa: BLE001
            errors.append(exc)

    try:
        driver = MultiPodDriver(pcfg, params=initial)
        backend = rc.active_backend()
        inner = driver.run_round

        def run_round(rnd):
            for th in threads:
                th.join()
            snaps.append(list(driver.params))     # the round's shipped list
            threads.append(threading.Thread(
                target=in_process, args=(rnd, snaps[-1]), daemon=True))
            threads[-1].start()
            t0 = time.perf_counter()
            rec = inner(rnd)
            round_s.append(time.perf_counter() - t0)
            return rec
        driver.run_round = run_round
        t0 = time.perf_counter()
        with PodResults() as log, FrameTally(backend) as tally:
            hist = bounded(driver.run, MULTIPOD_WAIT)
        run_s = time.perf_counter() - t0
        pids, put_bytes = backend.worker_pids(), backend.put_bytes()
    finally:
        rc.shutdown()
        rc.plan("sequential")
    for th in threads:
        th.join(WORKER_WAIT)
        check(not th.is_alive(), "the in-process pod rounds finished")
    if errors:
        raise errors[0]

    # -- the rounds: times, bytes, the node failure --------------------------
    results = {(r["round"], r["pod"]): r for r in log.results}
    check(len(log.results) == len(results) == pods * pcfg.rounds,
          f"one result for each pod of each round ({len(log.results)})")
    frames = {pid: list(fs) for pid, fs in tally.frames.items()}
    print(f"  driver.run(): {run_s:.3f} s for {pcfg.rounds} rounds; pod "
          f"workers at the end {pids}")
    for rnd, rec in enumerate(hist):
        print(f"  round {rnd}: loss {rec['loss']:.6f}, {round_s[rnd]:.3f} s "
              f"(dispatches included; {rec['wall_s']:.3f} s from the last "
              f"dispatch, the reference's wall_s), {rec['tokens']} tokens, "
              f"{rec['tokens'] / round_s[rnd]:.1f} tokens/s; exchange "
              f"(compress, mean, outer step) "
              f"{rec['exchange_s'] * 1e3:.1f} ms")
        for pod in range(pods):
            r = results[(rnd, pod)]
            print(f"    pod {pod} on pid {r['pid']} ({r['device']}): loss "
                  f"{r['loss']:.6f}, result pulled at "
                  f"{rec['pulled_s'][pod] * 1e3:.1f} ms after the last "
                  f"dispatch, launches {r['launches']}")
            start, end = r["clock"]
            sent = max(t for tag, _, _, t in tally.frames.get(r["pid"], ())
                       if tag == "task" and t <= start)
            p0, p1 = log.pulls[(rnd, pod)]
            print(f"      from its task frame: {start - sent:.3f} s to "
                  f"pod_round's start (the task's decode), {end - start:.3f}"
                  f" s in it (2 steps and the delta), {p0 - end:.3f} s to "
                  f"the result's arrival (the held delta encoded and "
                  f"digested), {p1 - p0:.3f} s in value() (the pull and "
                  f"its decode)")
            check(r["pid"] != os.getpid(), "the pod runs on a cluster worker")
            check(r["device"] == card, "the pod trains on the card")
            check(r["launches"] == want_launches,
                  f"a pod round launches {want_launches} in its worker")
    # each leaf at or over the ref threshold rides a put of its raw bytes,
    # once a worker and round; the rest ride the task frame
    big = sum(p.nbytes for p in initial if p.nbytes >= PAYLOAD_REF_THRESHOLD)
    for pid, fs in sorted(frames.items(), key=lambda kv: str(kv[0])):
        tasks = [(n, sec) for tag, n, sec, _ in fs if tag == "task"]
        puts = [(n, sec) for tag, n, sec, _ in fs if tag == "put"]
        put_b, put_s = sum(n for n, _ in puts), sum(t for _, t in puts)
        ran = {r["round"] for r in log.results if r["pid"] == pid}
        print(f"    sent to pid {pid} (ran pods of rounds {sorted(ran)}): "
              f"{len(tasks)} "
              f"task frames of {[n for n, _ in tasks]} B in "
              f"{sum(t for _, t in tasks):.3f} s; {len(puts)} put frames, "
              f"{put_b} B in {put_s:.3f} s"
              + (f" ({put_b / put_s / 1e9:.3f} GB/s)" if put_s else ""))
        check(all(n < (1 << 20) for n, _ in tasks),
              "the parameter list rides outside the task frame")
        check(put_b >= len(ran) * big, f"a worker is sent each round's "
              f"{big} B of large leaves as puts")
    print(f"  put bytes at the driver's sockets at the end, by pid "
          f"{put_bytes}")
    fails = hist[0]["redispatched"]
    check(os.path.exists(marker) and [p for p, _ in fails] == [0]
          and all(not h["redispatched"] for h in hist[1:]),
          "pod 0's first dispatch died once and was re-dispatched")
    t_fail = fails[0][1]
    print(f"  node failure: pod 0's first worker exited, seen "
          f"{t_fail * 1e3:.1f} ms after the round's last dispatch; the "
          f"re-dispatched pod 0 pulled "
          f"{(hist[0]['pulled_s'][0] - t_fail) * 1e3:.1f} ms after that")
    check(all(np.isfinite(h["loss"]) for h in hist), "round losses finite")

    # -- each pod round against the same call in this process ----------------
    for key, r in sorted(results.items()):
        out, ms = mine[key]
        diff = [i for i, (a, b) in enumerate(zip(r["delta"], out["delta"]))
                if not np.array_equal(a, b)]
        worst = max((float(np.abs(r["delta"][i] - out["delta"][i]).max())
                     for i in diff), default=0.0)
        print(f"  round {key[0]} pod {key[1]} in process ({ms:.1f} ms, "
              f"beside the driver): loss {out['loss']:.6f} against the "
              f"worker's {r['loss']:.6f}; {len(diff)} of {len(out['delta'])} "
              f"delta leaves differ (largest {worst:.3e})")
        check(out["loss"] == r["loss"] and not diff,
              "a pod round in its worker is the in-process call bit for bit")
    mine.clear()

    # -- the outer step and the checkpoint ------------------------------------
    moved = [i for i, (a, b) in enumerate(zip(driver.params, initial))
             if not np.array_equal(a, b)]
    touched = [i for i in range(len(initial))
               if any(np.any(r["delta"][i]) for r in log.results)]
    print(f"  outer step: {len(moved)} of {len(initial)} leaves moved; "
          f"{len(touched)} had a nonzero pod delta")
    check(set(touched) <= set(moved), "every leaf with a nonzero delta moved")
    restored, step = driver.ckpt.restore(
        {str(i): torch.from_numpy(p) for i, p in enumerate(driver.params)})
    same = step == pcfg.rounds and all(
        np.array_equal(restored[str(i)].numpy(), p)
        for i, p in enumerate(driver.params))
    print(f"  checkpoint of step {step} restored bit for bit: {same}")
    check(same, "the last checkpoint restores the driver's params")
    del log, results, snaps, restored, driver
    gc.collect()


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
    replies, long_prompt = serve_traffic(server, rng, cfg.vocab_size,
                                         keep=LONG_REQUEST)

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
    del got, want, alt, first
    torch.cuda.empty_cache()
    phase_done("3c")

    # -- 3c'. the dry run's analyzer against this prefill on the card --------
    dryrun_prefill_phase(cfg, params, tokens, ms, smi)
    del tokens
    phase_done("3c'")

    # -- 4c. the Server for yi-9b at full width ------------------------------
    server = Server("yi-9b", smoke=False, slots=4, max_new=16, device=dev,
                    params=params)
    replies, long_prompt = serve_traffic(server, rng, cfg.vocab_size,
                                         keep=LONG_REQUEST)

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


def dryrun_prefill_phase(cfg, params, tokens, kernel_ms: float,
                         smi: str) -> None:
    """Phase 3c': the plain prefill traced on ``meta`` tensors, then run on
    the card under the same analyzer; see the module docstring."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.launch.specs import model_flops
    from repro_torch.models import Model
    from repro_torch.train import make_prefill_step
    from repro_torch.tree import leaves, tree_map

    plain = make_prefill_step(Model(cfg, kernel_impl="plain"))
    batch = {"tokens": tokens}
    real_bytes = sum(t.numel() * t.element_size()
                     for t in leaves((params, batch)))

    # (i) the trace on meta tensors, one device, no mesh; warm, as the
    # card's run follows 3c's: an untraced call fills the per-device
    # caches first (the RoPE table)
    t0 = time.perf_counter()
    meta = OpCounter()
    meta_args = tree_map(lambda t: torch.empty_like(t, device="meta"),
                         (params, batch))
    plain(*meta_args)
    with meta:
        meta_arg_bytes = meta.hold(meta_args)
        plain(*meta_args)
    trace_s = time.perf_counter() - t0
    mr = meta.roof

    # (ii) the same prefill on the card under the analyzer and FLOP counter
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - real_bytes
    torch.cuda.reset_peak_memory_stats()
    card = OpCounter()
    counter = FlopCounterMode(display=False)
    with counter, card:
        card_arg_bytes = card.hold((params, batch))
        plain(params, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    cr = card.roof
    print(f"dry-run analyzer, yi-9b plain prefill (B,S)={tuple(tokens.shape)}"
          f": meta trace {trace_s:.1f} s, {mr.ops} ops; FLOPs meta "
          f"{mr.flops:.6e}, card {cr.flops:.6e}, FlopCounterMode "
          f"{counter.get_total_flops():.6e}; HBM bytes meta "
          f"{mr.hbm_bytes:.6e}, card {cr.hbm_bytes:.6e}; argument bytes "
          f"meta {meta_arg_bytes}, card {card_arg_bytes}, tensors "
          f"{real_bytes}")
    check(mr.flops == cr.flops == counter.get_total_flops(),
          "the card's FLOPs equal the meta trace's and FlopCounterMode's")
    check(mr.ops == cr.ops, "the card runs the meta trace's ops")
    check(mr.hbm_bytes == cr.hbm_bytes,
          "the card's HBM bytes equal the meta trace's")
    check(meta_arg_bytes == card_arg_bytes == real_bytes,
          "the argument bytes are the tree's and the tokens'")

    # (iii) the peak, against the trace's
    share, extra = DRYRUN_PEAK_TOL
    gap = peak - mr.peak_bytes
    print(f"  peak: card {peak / 1e9:.4f} GB (max_memory_allocated less "
          f"{resident / 1e6:.1f} MB resident before the run), trace "
          f"{mr.peak_bytes / 1e9:.4f} GB, card - trace {gap / 1e6:.1f} MB "
          f"(limit {share} of the trace + {extra / 2 ** 20:.0f} MiB)")
    check(abs(gap) <= share * mr.peak_bytes + extra,
          "the card's peak is within DRYRUN_PEAK_TOL of the trace's")

    # (iv) no bound exceeds a measurement
    plain_ms = cuda_ms(lambda: plain(params, batch), 1)
    secs = mr.seconds(1)
    bound_ms = max(secs["compute_s"], secs["memory_s"]) * 1e3
    print(f"  roofline of the plain prefill: compute {secs['compute_s']:.4f}"
          f" s ({ {k: f'{v:.4e}' for k, v in mr.flops_by_dtype.items()} }"
          f" FLOPs), memory {secs['memory_s']:.4f} s; bound {bound_ms:.1f}"
          f" ms against the measured plain prefill {plain_ms:.1f} ms "
          f"({bound_ms / plain_ms:.3f} of it) ({smi})")
    check(bound_ms <= plain_ms, "the trace's roofline time is no more than "
          "the measured plain prefill")

    # (v) the model-FLOPs share of 3c's kernel prefill
    mf = model_flops(cfg, ShapeSpec("prefill_4k", int(tokens.shape[1]),
                                    int(tokens.shape[0]), "prefill"))
    rate = mf["model_flops"] / (kernel_ms / 1e3)
    print(f"  model FLOPs of the prefill {mf['model_flops']:.6e} (dense "
          f"{mf['dense_flops']:.6e}, attention {mf['attn_flops']:.6e}) "
          f"over 3c's kernel prefill {kernel_ms:.1f} ms: "
          f"{rate / 1e12:.2f} TFLOP/s, {rate / PEAK_FP32_FLOPS:.4f} of the "
          f"fp32 peak ({PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s) ({smi})")


def dryrun_cells_phase() -> None:
    """Phase 8: the dry-run CLI's entry point on this host for
    ``DRYRUN_CELLS``, in this process: a process of its own takes ~20 s
    to start on the card's host, and its fake process group takes the
    place of the one phase 7a left."""
    import tempfile

    from repro_torch.launch import dryrun

    with tempfile.TemporaryDirectory() as out:
        for arch, shape, mesh in DRYRUN_CELLS:
            t0 = time.perf_counter()
            try:
                dryrun.main(["--arch", arch, "--shape", shape, "--mesh",
                             mesh, "--out", out])
            except SystemExit as exc:
                check(False, f"dry run {arch} x {shape} x {mesh}: exit "
                      f"{exc.code}")
            wall = time.perf_counter() - t0
            path = os.path.join(out, f"{arch}_{shape}_{mesh}.json")
            with open(path) as f:
                rec = json.load(f)
            counts = {k: rec.get(k) for k in (
                "op_flops_per_device", "op_bytes_per_device",
                "link_bytes_per_device", "arg_bytes_per_device",
                "compute_s", "memory_s", "collective_s")}
            counts["peak_bytes"] = rec["memory_analysis"]["peak_bytes"]
            print(f"dry run {arch} x {shape} x {mesh} ({rec['chips']} "
                  f"ranks): {rec['status']} in {rec['total_s']} s ({wall:.1f}"
                  f" s with the mesh), dominant {rec['dominant']}, "
                  f"collectives {rec['collectives']}, "
                  + ", ".join(f"{k} {v:.6g}" for k, v in counts.items()))
            check(rec["status"] == "ok" and all(
                v is not None and v > 0 for v in counts.values()),
                f"the dry run of {arch} x {shape} x {mesh} reads ok with "
                f"every count positive")


def dryrun_prefill_alone(smi: str) -> None:
    """``--phases "3c'"``: 3c's Yi-9B tree and prompt, drawn as
    ``gqa_phases`` draws them, its kernel prefill timed, then phase 3c'."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.train import make_prefill_step

    dev = torch.device("cuda")
    cfg = get_arch("yi-9b")
    n_a = sum(kind == "attn" for kind in cfg.layer_pattern)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(1, YI_S))).to(dev)
    prefill = make_prefill_step(model)
    counters = kernel_modules()
    zero_counts()
    prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    check(read_counts() == dict.fromkeys(counters, 0)
          | {"flash_attention": n_a},
          f"prefill must launch flash_attention {n_a}x and nothing else")
    ms = cuda_ms(lambda: prefill(params, {"tokens": tokens}), 2)
    print(f"prefill (B,S)={(1, YI_S)}: {ms:.1f} ms with {n_a} "
          f"flash_attention launches ({smi})")
    phase_done("3c")
    dryrun_prefill_phase(cfg, params, tokens, ms, smi)
    phase_done("3c'")
    del params, tokens, prefill
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_cells_alone(smi: str) -> None:
    """``--phases 8``: phase 8."""
    dryrun_cells_phase()
    phase_done("8")


def training_alone(smi: str) -> None:
    """``--phases 5``: phase 3's xLSTM-125M tree, drawn as ``main`` draws
    it, then phase 5."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    dev = torch.device("cuda")
    cfg = get_arch("xlstm-125m")
    params = Model(cfg).init(torch.Generator().manual_seed(SEED), device=dev)
    phase_done("3")
    training_phase(dev, cfg, params, smi)
    phase_done("5")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def mlstm_backward_alone(smi: str) -> None:
    """``--phases 2m``: phase 2's mLSTM backward case."""
    import torch

    from repro_torch.configs import get_arch
    cfg = get_arch("xlstm-125m")
    kernels: dict = {}
    mlstm_backward_case(torch.device("cuda"), kernels, cfg.xlstm.n_heads,
                        cfg.xlstm.head_dim, smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    phase_done("2m")


# the phases ``--phases`` runs alone, each after phase 1 (the build)
ALONE = {"2m": mlstm_backward_alone, "3c'": dryrun_prefill_alone,
         "5": training_alone, "8": dryrun_cells_alone}


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


def moe_prefill_phase(cfg, model, params, tokens, smi: str,
                      keep: bool = False):
    """The prefill step at B=1 through the entry point a user calls (one
    flash_attention launch a layer and no other kernel) and its time; then
    the kernel path's logits at every position against the plain path's by
    the flip-aware rule, with the share of assignments dropped by capacity
    and the 1-ulp yardstick. Returns the flash_attention launches; with
    ``keep`` also the kernel path's run for later checks, on the host:
    {"logits" (S, V), "decisions" (each MoE layer's), "yardstick" (the
    flip-aware rule's), "tokens"}."""
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
        kept = got.cpu() if keep else None
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
    yardstick = (*routing_diff(alt_log.layers(n_moe), want_dec), alt_err)
    hold_flip_rule("prefill logits, kernels vs plain", err, flips,
                   TOL_PREFILL_REL, yardstick)
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
    if keep:
        kept = {"logits": kept, "tokens": tokens.cpu(),
                "decisions": [tuple(t.cpu() for t in d) for d in got_dec],
                "yardstick": (*yardstick[:4], yardstick[4].cpu())}
    del want, last, err, alt_err, want_log, got_log, alt_log, yardstick
    torch.cuda.empty_cache()
    return (n_a, kept) if keep else n_a


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
    kernels["flash_attention@qwen2-moe-a2.7b"]["launches"], ref = \
        moe_prefill_phase(cfg, model, params, tokens, smi, keep=True)
    del tokens
    phase_done("3d")

    # -- 7a(i). the same prefill on a (1, 1) mesh, expert-parallel path ------
    ref = ep_one_rank_phase(cfg, params, ref)
    phase_done("7a(i)")

    # -- 4d. the Server for qwen2-moe-a2.7b at full width --------------------
    server = Server("qwen2-moe-a2.7b", smoke=False, slots=4, max_new=16,
                    device=dev, params=params)
    replies, long_prompt = serve_traffic(server, rng, cfg.vocab_size,
                                         keep=LONG_REQUEST)
    del server
    kernels["decode_attention@qwen2-moe-a2.7b"]["launches"] = \
        moe_decode_step(cfg, model, params, smi)
    hold_long_request_moe(cfg, model, params, long_prompt, replies[6][0])
    phase_done("4d")

    # -- 7a(ii), 7b. two ranks on the card: free qwen2-moe first ------------
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"after qwen2-moe-a2.7b is freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    ep_ranks_phase(cfg, ref, smi)
    del ref
    phase_done("7a(ii)")
    pipeline_phase(smi)
    phase_done("7b")

    # -- 3e. DeepSeekMoE-16B ---------------------------------------------------
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


# --------------------------------------------------------------------------
# Phases 7a and 7b: the multi-device runtime, two ranks on the one card
# --------------------------------------------------------------------------

#: the longest the ranks of phase 7a or 7b may take, spawn to exit
RANKS_WAIT = 240.0
#: phase 7a: Qwen1.5-MoE-A2.7B's 64 padded experts over 2 ``model`` ranks
EP_RANKS = 2
#: phase 7b: Yi-9B cut to PP_LAYERS of its 48 layers (AdamW's state for all
#: 48, 8.83 B x 16 B, does not fit one card), PP_STAGES stages over ``pod``,
#: a batch of PP_B x PP_S in PP_MICRO microbatches; each stage launches
#: flash_attention once a layer a microbatch in the forward and once more
#: in the backward's recompute (remat "full"): 4 x 4 x 2 = 32 a train step
PP_STAGES, PP_LAYERS, PP_B, PP_S, PP_MICRO = 2, 8, 8, 512, 4
PP_LAUNCHES = 2 * PP_MICRO * PP_LAYERS // PP_STAGES


def leaf_digests(params) -> dict:
    """Exact digests of every fp32 leaf's bits, on its device: {path: (2,)
    int64} for a leaf, (L, E, 2) for a stacked MoE expert leaf (one row an
    expert). Sums of the int32 words, plain and weighted by position, mod
    2^64: exact in any order and chunking, so a rank's own experts compare
    with their rows of the whole tree's digest."""
    import torch

    from repro_torch.tree import map_with_path

    def words(t):
        flat = t.reshape(-1).view(torch.int32)
        out = torch.zeros(2, dtype=torch.int64, device=t.device)
        for i in range(0, flat.numel(), 1 << 26):
            w = flat[i:i + (1 << 26)].long()
            pos = torch.arange(i, i + w.numel(), device=t.device) % 65521 + 1
            out[0] += w.sum()
            out[1] += (w * pos).sum()
        return out

    digests = {}

    def visit(path, t):
        if re.search(r"/moe/w_(gate|up|down)$", path) and t.ndim == 4:
            digests[path] = torch.stack([torch.stack([words(t[l, e])
                                                      for e in range(
                                                          t.shape[1])])
                                         for l in range(t.shape[0])])
        else:
            digests[path] = words(t)

    map_with_path(visit, params)
    return digests


def _rank_entry(body: str, rank: int, world: int, work: str) -> None:
    """One rank of ``run_ranks``: a gloo process group on a file store in
    ``work`` (NCCL refuses two ranks on one GPU), ``body`` run, its result
    pickled into ``work``."""
    import pickle

    import torch
    import torch.distributed as dist
    with open(os.path.join(work, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    if job["device"] == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world)
    try:
        out = globals()[body](rank, world, job)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    out.update(pid=os.getpid(), rank=rank,
               device=(torch.cuda.get_device_name(0)
                       if job["device"] == "cuda" else "cpu"))
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(body: str, world: int, job: dict) -> list:
    """``world`` spawned processes running ``body(rank, world, job)`` as
    ranks of one gloo group; each rank's result. A rank that fails, or
    ranks still running after RANKS_WAIT, fail the phase."""
    import multiprocessing
    import pickle
    import tempfile
    with tempfile.TemporaryDirectory() as work:
        with open(os.path.join(work, "job.pkl"), "wb") as f:
            pickle.dump(job, f)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_entry, args=(body, r, world, work))
                 for r in range(world)]
        # the ranks share one card: each allocator grows its segments in
        # place rather than keeping freed blocks of fixed segments, which
        # held 3.6 GB a rank in 7b's AdamW step beside 33.8 GB in use
        saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            for p in procs:
                p.start()
        finally:
            if saved is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
        deadline = time.monotonic() + RANKS_WAIT
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join()
        check(not late, f"{body}: ranks still running after {RANKS_WAIT} s")
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"{body}: the ranks exited {codes}")
        out = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _peak_gb(dev) -> float:
    import torch
    return (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else float("nan"))


def ep_rank(rank: int, world: int, job: dict) -> dict:
    """Phase 7a's rank: Qwen1.5-MoE-A2.7B on a (1, world) ("data",
    "model") mesh, its experts split over the ``model`` ranks. The rank
    draws the tree as one process does, keeping its own experts, and checks
    every leaf's digest against the whole tree's; then the prefill step
    (launches, ms) and the logits at every position against the
    single-process run kept in ``job["ref"]``, and, on rank 0, every other
    rank's logits bit for bit."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.train import make_prefill_step
    dev = torch.device(job["device"])
    ref = torch.load(job["ref"], mmap=True)
    mesh = init_device_mesh(dev.type, (1, world),
                            mesh_dim_names=("data", "model"))
    cfg = get_arch(job["arch"], smoke=job["smoke"])
    model = Model(cfg, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    _sync(dev)
    draw_s = time.perf_counter() - t0
    epp = cfg.moe.e_pad // world
    differ = []
    for path, d in leaf_digests(params).items():
        want = ref["digests"][path]
        if d.ndim == 3:
            want = want[:, rank * epp:(rank + 1) * epp]
        if not torch.equal(d.cpu(), want):
            differ.append(path)
    batch = {"tokens": ref["tokens"].to(dev)}
    prefill = make_prefill_step(model)
    zero_counts()
    first = prefill(params, batch)
    _sync(dev)
    launches = read_counts()
    t0 = time.perf_counter()
    for _ in range(2):
        prefill(params, batch)
    _sync(dev)
    ms = (time.perf_counter() - t0) / 2 * 1e3
    n_moe = sum(kind == "moe" for kind in cfg.layer_pattern)
    with torch.no_grad(), RoutingLog() as log:
        logits = model.apply(params, batch)[0][0]
    flips = routing_diff(log.layers(n_moe),
                         [tuple(t.to(dev) for t in d)
                          for d in ref["decisions"]])
    s = logits.shape[0]
    err = torch.empty(s)
    same = True
    for i in range(0, s, 512):
        part = logits[i:i + 512]
        err[i:i + 512] = err_by_position(
            part, ref["logits"][i:i + 512].to(dev)).cpu()
        host = part.cpu()
        for other in range(1, world):     # every rank's logits to rank 0
            if rank == 0:
                theirs = torch.empty_like(host)
                dist.recv(theirs, src=other)
                same = same and torch.equal(host, theirs)
            elif rank == other:
                dist.send(host, dst=0)
    return {"draw_s": draw_s, "digests_differ": differ,
            "n_digests": len(ref["digests"]), "launches": launches,
            "first": int(first), "ms": ms, "err": err, "flips": flips,
            "same_as_others": same if rank == 0 else None,
            "peak_gb": _peak_gb(dev), "experts": epp}


def ep_one_rank_phase(cfg, params, ref: dict) -> dict:
    """Phase 7a(i), right after 3d on its tree: the same model on a (1, 1)
    mesh in this process (world size 1; NCCL on the card), one
    flash_attention launch a layer and its logits held against the
    single-process run ``ref`` (``moe_prefill_phase(..., keep=True)``) by
    the flip-aware rule. Returns ``ref`` with the tree's leaf digests, for
    7a(ii) (:func:`ep_ranks_phase`): after the tree is freed, EP_RANKS
    spawned ranks on a (1, EP_RANKS) mesh (``ep_rank``), each drawing the
    tree with e_pad / EP_RANKS experts of its own, held the same way."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.train import make_prefill_step
    dev = params["embed"]["table"].device
    n_a = len(cfg.layer_pattern)
    n_moe = sum(kind == "moe" for kind in cfg.layer_pattern)
    want_launches = n_a if dev.type == "cuda" else 0
    mesh = make_host_mesh(device_type=dev.type)
    try:
        print(f"7a(i): (1, 1) mesh on one rank, backend "
              f"{dist.get_backend()}, world size {dist.get_world_size()}")
        one = Model(cfg, mesh=mesh)
        batch = {"tokens": ref["tokens"].to(dev)}
        zero_counts()
        make_prefill_step(one)(params, batch)
        _sync(dev)
        launches = read_counts()
        with torch.no_grad(), RoutingLog() as log:
            logits = one.apply(params, batch)[0][0]
        err = torch.cat([err_by_position(logits[i:i + 512],
                                         ref["logits"][i:i + 512].to(dev))
                         for i in range(0, logits.shape[0], 512)])
        del logits
    finally:
        dist.destroy_process_group()
    check(launches == dict.fromkeys(launches, 0)
          | {"flash_attention": want_launches},
          f"7a(i) launches {launches}, flash_attention {want_launches}x "
          f"wanted")
    hold_flip_rule("7a(i) prefill logits on a (1, 1) mesh vs one process",
                   err.cpu(), routing_diff(
                       [tuple(t.cpu() for t in d) for d in log.layers(n_moe)],
                       ref["decisions"]),
                   TOL_PREFILL_REL, ref["yardstick"])
    ref["digests"] = {k: v.cpu() for k, v in leaf_digests(params).items()}
    return ref


def ep_ranks_phase(cfg, ref: dict, smi: str, device: str = "cuda",
                   smoke: bool = False) -> None:
    """Phase 7a(ii): see :func:`ep_one_rank_phase`. No model may be left
    on the card when it runs."""
    import tempfile

    import torch
    n_a = len(cfg.layer_pattern)
    want = n_a if device == "cuda" else 0
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "ref.pt")
        t0 = time.perf_counter()
        torch.save(ref, path)
        print(f"7a(ii): the single-process run written for the ranks "
              f"({os.path.getsize(path) / 1e9:.2f} GB) in "
              f"{time.perf_counter() - t0:.1f} s")
        results = run_ranks("ep_rank", EP_RANKS, {
            "device": device, "arch": cfg.name, "smoke": smoke,
            "ref": path})
    for r in results:
        print(f"7a rank {r['rank']} (pid {r['pid']}, {r['device']}): "
              f"{r['experts']} of {cfg.moe.e_pad} experts, drawn in "
              f"{r['draw_s']:.1f} s, {r['n_digests'] - len(r['digests_differ'])}"
              f" of {r['n_digests']} leaf digests equal the single-process "
              f"tree's; launches {r['launches']}; prefill (B,S)=(1, "
              f"{len(r['err'])}) {r['ms']:.1f} ms beside the other rank, "
              f"{len(r['err']) / r['ms'] * 1e3:.0f} tokens/s; peak memory "
              f"{r['peak_gb']:.2f} GB ({smi})")
        check(r["pid"] != os.getpid(), "each rank runs in its own process")
        check(device != "cuda" or r["device"] == torch.cuda.get_device_name(0),
              "each rank runs on the card")
        check(not r["digests_differ"],
              f"rank {r['rank']}'s leaves differ from the single-process "
              f"tree: {r['digests_differ'][:5]}")
        check(r["launches"] == dict.fromkeys(r["launches"], 0)
              | {"flash_attention": want},
              f"rank {r['rank']} must launch flash_attention {want}x")
        hold_flip_rule(f"7a rank {r['rank']} prefill logits vs one process",
                       r["err"], r["flips"], TOL_PREFILL_REL,
                       ref["yardstick"])
    check(len({r["first"] for r in results}) == 1,
          "the ranks' first tokens agree")
    print(f"7a: the ranks' logits bit for bit: "
          f"{results[0]['same_as_others']}")
    check(results[0]["same_as_others"] is True,
          "every rank's logits equal rank 0's bit for bit")


def pp_rank(rank: int, world: int, job: dict) -> dict:
    """Phase 7b's rank: stage ``rank`` of a (world, 1, 1) ("pod", "data",
    "model") pipeline. First the reference, one rank at a time: the whole
    cut model drawn as one process draws it, the plain ``Model.loss`` and
    its grads on the whole batch and one AdamW step, of which this stage's
    leaves are kept on the host; then the pipelined loss and grads
    (``value_and_grad``) and one ``make_pipeline_train_step``."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.data import synth_batch
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import init_train_state
    from repro_torch.train.pipeline import (local_stage_params,
                                            make_pipeline_loss,
                                            make_pipeline_train_step)
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import leaves, map_with_path, tree_map
    dev = torch.device(job["device"])
    mesh = init_device_mesh(dev.type, (world, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    cfg = dataclasses.replace(get_arch(job["arch"], smoke=job["smoke"]),
                              n_layers=job["layers"])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        cfg, batch=job["batch"], seq=job["seq"], seed=SEED,
        step=0).items()}
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    host = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    for turn in range(world):
        if turn == rank:
            t0 = time.perf_counter()
            model = Model(cfg)
            params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                                device=dev)
            (loss, _), grads = value_and_grad(model, params, batch)
            new, _, _ = adamw.apply_updates(opt, params, grads,
                                            adamw.init_state(params))
            ref = {"loss": loss.item(),
                   "grads": host(local_stage_params(grads, mesh)),
                   "params": host(local_stage_params(new, mesh))}
            local = tree_map(lambda t: t.clone(),
                             local_stage_params(params, mesh))
            del params, grads, new
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            ref_s = time.perf_counter() - t0
        dist.barrier()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    loss_fn = make_pipeline_loss(model, mesh, microbatches=job["micro"],
                                 remat="full")
    loss, grads = loss_fn.value_and_grad(local, batch)
    names = []
    map_with_path(lambda path, _: names.append(path), grads)
    grad_err = [((g - r.to(dev)).abs().max().item()
                 / max(r.abs().max().item(), 1e-30), path)
                for path, g, r in zip(names, leaves(grads),
                                      leaves(ref["grads"]))]
    del grads
    step = make_pipeline_train_step(model, opt, mesh,
                                    microbatches=job["micro"], remat="full")
    zero_counts()
    _sync(dev)
    t0 = time.perf_counter()
    state, metrics = step(init_train_state(local), batch)
    _sync(dev)
    step_s = time.perf_counter() - t0
    launches = read_counts()
    h = step.loss_fn.handoff
    param_err = []
    for path, p_new, p_old, r_new, r_g in zip(
            names, leaves(state.params), leaves(local),
            leaves(ref["params"]), leaves(ref["grads"])):
        r_new, r_g = r_new.to(dev), r_g.to(dev)
        diff = (p_new - r_new).abs()
        scale = r_new.abs().max().item()
        decided = r_g.abs() > TOL_TRAIN_GRAD_REL * r_g.abs().max()
        undecided = diff[~decided]
        reach = 2 * opt.lr * (1 + opt.weight_decay
                              * p_old.abs().max().item())
        param_err.append((
            (diff[decided].max().item() if decided.any() else 0.0) / scale,
            path, (undecided.max().item() if undecided.numel() else 0.0)
            / reach, int((undecided > TOL_TRAIN_GRAD_REL * scale).sum())))
    return {"stage": mesh.get_local_rank("pod"), "ref_s": ref_s,
            "ref_loss": ref["loss"], "loss": loss.item(),
            "step_loss": metrics["loss"].item(),
            "grad_norm": metrics["grad_norm"].item(),
            "grad_err": grad_err, "param_err": param_err,
            "launches": launches, "step_s": step_s,
            "handoff": (h.sent, h.received, h.host_bytes, h.copy_s),
            "reduce_s": step.loss_fn.reduce_s,
            "peak_gb": _peak_gb(dev)}


def pipeline_phase(smi: str, device: str = "cuda", smoke: bool = False,
                   layers: int = PP_LAYERS, b: int = PP_B, s: int = PP_S
                   ) -> None:
    """Phase 7b: Yi-9B at full width cut to PP_LAYERS layers, trained as
    PP_STAGES GPipe stages over ``pod`` in spawned ranks (``pp_rank``):
    the loss within TOL_TRAIN_LOSS_REL of the reference's, every grad leaf
    within TOL_TRAIN_GRAD_REL of its scale, the params after one AdamW step
    within the same bound wherever the reference's grad exceeds the grad
    limit (where it does not, the grads' rounding can flip the first
    step's sign, so those elements are held to the most two steps can move
    apart, 2 lr (1 + wd max|p|)), and PP_LAUNCHES flash_attention launches
    a stage a train step."""
    import torch
    if device == "cuda":
        free, total = torch.cuda.mem_get_info()
        print(f"7b: {free / 1e9:.2f} of {total / 1e9:.2f} GB free on the "
              f"card before the stages start")
    results = run_ranks("pp_rank", PP_STAGES, {
        "device": device, "arch": "yi-9b", "smoke": smoke,
        "layers": layers, "batch": b, "seq": s, "micro": PP_MICRO})
    want = PP_LAUNCHES if device == "cuda" else 0
    for r in sorted(results, key=lambda r: r["stage"]):
        rel = abs(r["loss"] - r["ref_loss"]) / abs(r["ref_loss"])
        g = max(r["grad_err"])
        pe = max(r["param_err"])
        reach = max(x[2] for x in r["param_err"])
        flipped = sum(x[3] for x in r["param_err"])
        sent, received, nbytes, copy_s = r["handoff"]
        print(f"7b stage {r['stage']} (pid {r['pid']}, {r['device']}): "
              f"reference in {r['ref_s']:.1f} s; loss {r['loss']:.6f} vs "
              f"{r['ref_loss']:.6f}, relative {rel:.3e} (tolerance "
              f"{TOL_TRAIN_LOSS_REL}); grads, {len(r['grad_err'])} leaves: "
              f"worst {g[1]} {g[0]:.3e} of its scale (tolerance "
              f"{TOL_TRAIN_GRAD_REL}); params after the step: worst decided "
              f"{pe[1]} {pe[0]:.3e}, undecided at most {reach:.3f} of 2 lr "
              f"(1 + wd max|p|), {flipped} undecided elements past "
              f"{TOL_TRAIN_GRAD_REL} of the scale; train step "
              f"{r['step_s']:.2f} s ({b * s / r['step_s']:.0f} "
              f"tokens/s), launches {r['launches']}; hand-off {sent} sent, "
              f"{received} received, {nbytes / 1e6:.1f} MB through the host "
              f"in {copy_s:.3f} s; the replicated leaves' grads summed over "
              f"pod in {r['reduce_s']:.2f} s; peak memory "
              f"{r['peak_gb']:.2f} GB ({smi})")
        check(r["pid"] != os.getpid(), "each stage runs in its own process")
        check(device != "cuda" or r["device"] == torch.cuda.get_device_name(0),
              "each stage runs on the card")
        check(np.isfinite(r["loss"]) and rel <= TOL_TRAIN_LOSS_REL,
              f"stage {r['stage']}: the pipelined loss")
        check(g[0] <= TOL_TRAIN_GRAD_REL, f"stage {r['stage']}: the grads")
        check(pe[0] <= TOL_TRAIN_GRAD_REL and reach <= 1.0,
              f"stage {r['stage']}: the params after the step")
        check(r["launches"] == dict.fromkeys(r["launches"], 0)
              | {"flash_attention": want},
              f"stage {r['stage']} must launch flash_attention {want}x a "
              f"train step")
        check(sent == received == PP_MICRO,
              f"stage {r['stage']}: one hand-off each way a microbatch")
    for key in ("loss", "step_loss"):
        check(len({r[key] for r in results}) == 1,
              f"every stage's {key} is the same")


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
    replies, long_prompt = serve_traffic(server, rng, cfg.vocab_size,
                                         keep=LONG_REQUEST)
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
                                         long_len=LONG_REQUEST)
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
