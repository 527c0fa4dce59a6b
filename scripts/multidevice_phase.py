#!/usr/bin/env python3
"""Phases 7a and 7b of ``chip_smoke.py`` alone, after its phase 1 (the
build): Qwen1.5-MoE-A2.7B's prefill (3d's single-process run, then 7a(i) on
a (1, 1) mesh and 7a(ii) with its experts split over two spawned ranks) and
Yi-9B cut to 8 layers trained as two GPipe stages in spawned ranks (7b), on
one NVIDIA GPU, with every check and print of those phases.

    python3 scripts/multidevice_phase.py [--phases 7a 7b]

The parameters are drawn from ``chip_smoke.SEED`` on the card, as
``chip_smoke.py`` draws them; the prompt is drawn from a generator of that
seed (not the one the whole run has advanced to). Prints the card's name
and power limit and each phase's seconds; exits non-zero if a check fails
or there is no card.
"""

import argparse
import gc
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", nargs="+", choices=("7a", "7b"),
                    default=["7a", "7b"])
    phases = ap.parse_args().phases
    import torch
    if not torch.cuda.is_available():
        print("multidevice_phase: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    _build.build_all()
    cs.phase_done("1")
    if "7a" in phases:
        run_7a(cs, smi)
    if "7b" in phases:
        cs.pipeline_phase(smi)
        cs.phase_done("7b")
    return 0


def run_7a(cs, smi: str) -> None:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    dev = torch.device("cuda")
    cfg = get_arch("qwen2-moe-a2.7b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(cs.SEED),
                        device=dev)
    tokens = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, cfg.vocab_size, size=(1, cs.MOE_S))).to(dev)
    _, ref = cs.moe_prefill_phase(cfg, model, params, tokens, smi,
                                  keep=True)
    cs.phase_done("3d")
    ref = cs.ep_one_rank_phase(cfg, params, ref)
    cs.phase_done("7a(i)")
    del model, params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    cs.ep_ranks_phase(cfg, ref, smi)
    del ref
    cs.phase_done("7a(ii)")


if __name__ == "__main__":
    sys.exit(main())
