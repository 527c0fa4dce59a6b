#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path on one GPU.

    python3 scripts/profile_torch.py [--arch recurrentgemma-9b|yi-9b|yi-34b|
                                             qwen2-moe-a2.7b|minicpm3-4b|
                                             hubert-xlarge]
                                     [--dtype float32|bfloat16]

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
for the run. Needs a CUDA device.
"""

import argparse
import contextlib
import os
import subprocess
import sys
import time

import numpy as np


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _report(label: str, prof, wall_s: float, steps: int, top: int = 10):
    from torch.autograd import DeviceType
    # kernel rows only: an operator's row carries its kernels' time too,
    # and a range's row on the device (moe_ranges) spans its kernels' gaps
    rows = sorted(((e.key, e.count, _device_us(e))
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key not in MOE_PARTS.values()),
                  key=lambda r: -r[2])
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
