#!/usr/bin/env python3
"""How far rounding alone moves xLSTM-125M's training, beside the kernels
and two deliberately broken backwards (on one CUDA card).

    python3 scripts/train_divergence.py [--lrs 6e-4,1e-4,3e-5] [--steps 4]

From the Trainer's parameters (the card's generator, seed 0) at B=8,
S=512, fp32:
  * one train step's grads with the kernels, and on the plain path with
    the embedding table moved by one ulp, each against the plain path:
    the worst leaf over its largest plain grad (the mLSTM input-gate bias
    b_i on its block's w_i scale, as chip_smoke.py holds it);
  * for each learning rate (linear warmup of one step, cosine over the
    run) the loss curve of the plain path against: the plain path moved by
    one ulp (the yardstick: what any other rounding may do), the kernels,
    and the kernels with the mLSTM backward zeroed or scaled by 1.1 (what
    the curve check must catch). Relative difference per step.
chip_smoke.py phase 5 runs its curve check at the rate this table
supports. Nothing here is a pass or fail: it prints the table.
"""

import argparse
import os
import subprocess
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="6e-4,1e-4,3e-5")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_divergence: no CUDA device is available",
              file=sys.stderr)
        return 2
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    import repro_torch.core as rc
    from chip_smoke import mlstm_b_i_scales
    from repro_torch.configs import get_arch
    from repro_torch.data import synth_batch
    from repro_torch.kernels import mlstm_scan as MK
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, init_train_state
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import leaves, map_with_path, tree_map

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = get_arch("xlstm-125m")
    base = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    moved = dict(base, embed={"table": base["embed"]["table"]
                              * (1 + 2 ** -23)})

    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             synth_batch(cfg, batch=8, seq=512, seed=0, step=0).items()}
    names = []
    map_with_path(lambda path, _: names.append(path), base)
    scale_of = mlstm_b_i_scales(cfg, names)
    grads = {}
    for run, impl, params in (("plain", "plain", base),
                              ("plain moved by 1 ulp", "plain", moved),
                              ("kernels", "hopper", base)):
        _, g = value_and_grad(Model(cfg, kernel_impl=impl), params, batch)
        grads[run] = dict(zip(names, leaves(g)))
    ref = grads.pop("plain")
    for run, g in grads.items():
        worst = max(((g[n] - ref[n]).abs().max().item()
                     / ref[scale_of.get(n, n)].abs().max().item(), n)
                    for n in names)
        print(f"grads, {run} vs plain: worst {worst[1]} {worst[0]:.3e}")
    del grads, ref

    rc.plan("threads", workers=2)
    plain_bwd = MK.plain

    def curve(impl, params, opt, broken=None):
        if broken is not None:
            MK.plain = lambda *a, **k: plain_bwd(*a, **k) * broken
        try:
            trainer = Trainer(cfg, TrainerConfig(
                steps=args.steps, batch=8, seq=512, log_every=1, device=dev,
                kernel_impl=impl), opt)
            _, history = trainer.run(init_train_state(
                tree_map(lambda t: t.clone(), params)))
        finally:
            MK.plain = plain_bwd
        return np.array([h["loss"] for h in history])

    for lr in (float(x) for x in args.lrs.split(",")):
        opt = AdamWConfig(lr=lr, warmup_steps=1, total_steps=args.steps)
        ref = curve("plain", base, opt)
        print(f"lr {lr}: plain losses {ref.tolist()}")
        for run, impl, params, broken in (
                ("plain moved by 1 ulp", "plain", moved, None),
                ("kernels", "hopper", base, None),
                ("kernels, mLSTM backward x0", "hopper", base, 0.0),
                ("kernels, mLSTM backward x1.1", "hopper", base, 1.1)):
            rel = np.abs(curve(impl, params, opt, broken) - ref) / ref
            print(f"  {run}: relative per step "
                  f"{[float(f'{r:.3e}') for r in rel]}")
    rc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
