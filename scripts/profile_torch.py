#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving and training paths
on one GPU.

    python3 scripts/profile_torch.py [--arch recurrentgemma-9b|yi-9b|yi-34b|
                                             qwen2-moe-a2.7b|minicpm3-4b|
                                             hubert-xlarge]
                                     [--dtype float32|bfloat16]
    python3 scripts/profile_torch.py --train

Runs an arch at full width with random weights (seed 0) drawn in
``--dtype`` (fp32 by default; bf16 for yi-34b, whose 34.4 B parameters
fit the card only so) and, under ``torch.profiler``, one prefill step and
16 decode steps at B=4: xLSTM-125M (the default) prefills B=8, S=2048;
RecurrentGemma-9B, Yi-9B, Yi-34B, Qwen1.5-MoE-A2.7B and MiniCPM3-4B
prefill B=1, S=4096 and decode with every attention cache full
(RecurrentGemma's ring buffers, the others' 4096-position global caches,
MiniCPM3's 4096-position latent caches, of the parameters' type);
HuBERT-XLarge, an encoder with no decode step, runs its forward on B=8
clips of S=1500 frames (30 s each at 20 ms a frame) and nothing else. For
each it prints the wall time (host clock around work that ends in
``torch.cuda.synchronize()``), the device time summed over
the kernels that ran, the device's idle share (1 - device / wall), and the
kernels that took the most device time; for an MoE arch also the device
time of each part of its MoE layers (router and dispatch, expert products,
combine, shared MLP), each part's functions wrapped in a profiler range
for the run. ``--train`` profiles one xLSTM-125M train step instead, at
``chip_smoke.py`` phase 5's shape (B=8, S=512, fp32, AdamW): its wall and
device time, idle share and top kernels, and the device time spent in each
kernel's backward: the mLSTM's and the sLSTM's backward kernels by their
own rows, the ops each runs around its kernel (the mLSTM's plane sums and
gate grads, the sLSTM's dR product) and any recompute through a plain
version in a profiler range for the run (a launch through ctypes is no op
of the profiler, so no range holds the kernels themselves). Needs a CUDA
device.
"""

import argparse
import contextlib
import os
import re
import subprocess
import sys
import time

import numpy as np


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _kernel_rows(prof) -> list:
    """(name, count, device us) of each kernel, most time first: kernel
    rows only, since an operator's row carries its kernels' time too, and
    a range's row on the device (``moe_ranges``, ``backward_ranges``)
    spans its kernels' gaps."""
    from torch.autograd import DeviceType
    return sorted(((e.key, e.count, _device_us(e))
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key not in MOE_PARTS.values()
                   and not e.key.startswith(BACKWARD_RANGE.format(""))),
                  key=lambda r: -r[2])


def _report(label: str, prof, wall_s: float, steps: int, top: int = 10):
    rows = _kernel_rows(prof)
    dev_s = sum(r[2] for r in rows) / 1e6
    if dev_s == 0.0:
        print(f"{label}: wall {wall_s / steps * 1e3:.3f} ms per step; "
              f"device time not measured (the profiler saw no kernels)")
        return
    print(f"{label}: wall {wall_s / steps * 1e3:.3f} ms per step, device "
          f"{dev_s / steps * 1e3:.3f} ms per step, device idle share "
          f"{1 - dev_s / wall_s:.3f}")
    for key, count, us in rows[:top]:
        if us <= 0:
            break
        print(f"  {us / steps / 1e3:9.3f} ms/step {count // steps:6d} "
              f"calls/step  {us / 1e6 / dev_s:6.1%}  {key[:90]}")


#: the train step's shape (batch, sequence), chip_smoke.py phase 5's
TRAIN_SHAPE = (8, 512)

#: full-width prefill shape (batch, sequence) of each arch
PREFILL = {"xlstm-125m": (8, 2048), "recurrentgemma-9b": (1, 4096),
           "yi-9b": (1, 4096), "yi-34b": (1, 4096),
           "qwen2-moe-a2.7b": (1, 4096), "minicpm3-4b": (1, 4096),
           "hubert-xlarge": (8, 1500)}

#: the parts of an MoE layer, by the functions of ``models/moe.py`` that
#: ``moe_apply`` calls for each
MOE_PARTS = {"route": "moe: router and dispatch",
             "dispatch": "moe: router and dispatch",
             "experts": "moe: expert products", "combine": "moe: combine",
             "mlp_apply": "moe: shared MLP"}


@contextlib.contextmanager
def moe_ranges():
    """While active, each part of ``moe_apply`` runs inside a profiler
    range named for its part."""
    from torch.profiler import record_function

    from repro_torch.models import moe as MOE

    def ranged(fn, name):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    saved = {fn: getattr(MOE, fn) for fn in MOE_PARTS}
    for fn, name in MOE_PARTS.items():
        setattr(MOE, fn, ranged(saved[fn], name))
    try:
        yield
    finally:
        for fn, f in saved.items():
            setattr(MOE, fn, f)


#: profiler range of each kernel's backward: a recompute through the plain
#: version (``autograd._Recompute``), named for that version, or a backward
#: kernel's (``mlstm_scan`` and ``slstm_scan``'s ``_Scan``), named for the
#: wrapper
BACKWARD_RANGE = "backward: {}"
#: the backward kernels' rows, by the kernel's name
BACKWARD_KERNEL = re.compile(r"\w+_bwd_kernel(<[^>]*>)?")


@contextlib.contextmanager
def backward_ranges():
    """While active, each kernel's backward runs inside a profiler range
    named for its recompute's plain version or its backward kernel."""
    from torch.profiler import record_function

    from repro_torch.kernels import mlstm_scan, slstm_scan
    from repro_torch.kernels.autograd import _Recompute

    def recomputed(ctx):
        return f"recompute through {ctx.plain.__name__}"

    def kernel_of(mod):
        return lambda ctx: f"{mod.__name__.rsplit('.', 1)[1]} backward kernel"

    targets = [(_Recompute, recomputed)] + [
        (mod._Scan, kernel_of(mod)) for mod in (mlstm_scan, slstm_scan)]
    saved = [(cls, cls.backward) for cls, _ in targets]

    def ranged(fn, name_of):
        def backward(ctx, *grads):
            with record_function(BACKWARD_RANGE.format(name_of(ctx))):
                return fn(ctx, *grads)
        return staticmethod(backward)

    for (cls, name_of), (_, fn) in zip(targets, saved):
        cls.backward = ranged(fn, name_of)
    try:
        yield
    finally:
        for cls, fn in saved:
            cls.backward = staticmethod(fn)


def _report_backward(prof, steps: int, wall_s: float) -> None:
    """Device time of each backward kernel's rows and of the kernels
    launched under each backward range, a step and as a share of the
    step's device and wall time."""
    from torch.autograd import DeviceType
    rows = _kernel_rows(prof)
    dev_us = sum(r[2] for r in rows)
    for name, count, us in rows:
        found = BACKWARD_KERNEL.search(name)
        if found:
            print(f"  kernel {found.group(0)}: {us / steps / 1e3:.3f} ms/step "
                  f"in {count / steps:.0f} launches, "
                  f"{us / max(dev_us, 1e-9):.3f} of the step's device time, "
                  f"{us / 1e6 / wall_s:.3f} of its wall")
    parts: dict = {}
    prefix = BACKWARD_RANGE.format("")
    for e in prof.events():
        if e.name.startswith(prefix) and e.device_type == DeviceType.CPU:
            parts[e.name] = parts.get(e.name, 0.0) + float(
                getattr(e, "device_time_total", 0.0))
    if not parts:
        print("  no kernel backward ran")
    print("  under each backward's range (the ops it runs through PyTorch):")
    for name, us in sorted(parts.items()):
        print(f"  {name}: " + (f"{us / steps / 1e3:.3f} ms/step of kernels, "
                               f"{us / max(dev_us, 1e-9):.3f} of the step's "
                               f"device time, {us / 1e6 / wall_s:.3f} of its "
                               f"wall" if us else "not measured (no kernels "
                               "under its range)"))


def profile_train(dev) -> int:
    """One xLSTM-125M train step at B=8, S=512 from the same state after
    a warm-up step, under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data import synth_batch
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_arch("xlstm-125m")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    b, s = TRAIN_SHAPE
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             synth_batch(cfg, batch=b, seq=s, seed=0, step=0).items()}
    state = init_train_state(params)
    step = make_train_step(model, AdamWConfig(lr=3e-5, warmup_steps=1,
                                              total_steps=4))
    step(state, batch)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with backward_ranges(), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"xlstm-125m train step B={b} S={s}", prof, wall, 1, top=15)
    _report_backward(prof, 1, wall)
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    print(f"train step without the profiler: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    return 0


def _report_moe(prof, steps: int) -> None:
    """Device time of each MoE part: the kernels launched inside its
    ranges on the host, summed over the layers."""
    from torch.autograd import DeviceType
    parts = dict.fromkeys(MOE_PARTS.values(), 0.0)
    for e in prof.events():
        if e.name in parts and e.device_type == DeviceType.CPU:
            parts[e.name] += float(getattr(e, "device_time_total", 0.0))
    for name, us in parts.items():
        print(f"  {name}: " + (f"{us / steps / 1e3:.3f} ms/step of kernels"
                                if us else "not measured (no kernels under "
                                "its ranges)"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m", choices=sorted(PREFILL))
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    help="the parameters' and caches' type (default fp32, "
                    "bf16 for yi-34b)")
    ap.add_argument("--train", action="store_true",
                    help="profile one xlstm-125m train step instead")
    args = ap.parse_args()
    dtype = args.dtype or ("bfloat16" if args.arch == "yi-34b"
                           else "float32")
    import torch
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import Model
    from repro_torch.train import make_prefill_step, make_serve_step

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    _build.build_all()
    dev = torch.device("cuda")
    if args.train:
        return profile_train(dev)
    cfg = get_arch(args.arch)
    model = Model(cfg)
    dt = getattr(torch, dtype)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev, dtype=dt)
    print(f"{args.arch}: {dtype} parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    rng = np.random.default_rng(0)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    b, s = PREFILL[args.arch]
    ranges = moe_ranges if cfg.moe is not None else contextlib.nullcontext

    prefill = make_prefill_step(model)
    if cfg.frontend == "audio":
        batch = {"frames": torch.from_numpy(rng.standard_normal(
            (b, s, cfg.frontend_dim), dtype=np.float32)).to(dev, dt)}
    else:
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, size=(b, s))).to(dev)}
    prefill(params, batch)
    torch.cuda.synchronize()
    with ranges(), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"prefill B={b} S={s}", prof, wall, 1)
    if cfg.moe is not None:
        _report_moe(prof, 1)
    del prof
    torch.cuda.empty_cache()
    if not cfg.decode_capable:
        return 0

    step = make_serve_step(model)
    cache = model.init_cache(4, max_seq=s, device=dev, dtype=dt)
    for stage in cache:                # every attention cache full
        for block in stage.values():
            if "pos" in block:
                block["pos"].fill_(s)
    tok = torch.zeros(4, 1, dtype=torch.int64, device=dev)
    for _ in range(3):
        tok, cache = step(params, cache, tok)
    torch.cuda.synchronize()
    steps = 16
    with ranges(), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, cache = step(params, cache, tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report("decode B=4", prof, wall, steps)
    if cfg.moe is not None:
        _report_moe(prof, steps)
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, cache = step(params, cache, tok)
    torch.cuda.synchronize()
    print(f"decode B=4 without the profiler: "
          f"{(time.perf_counter() - t0) / steps * 1e3:.3f} ms per step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
