"""End-to-end training example on the PyTorch port: xLSTM-125M (the twin of
``examples/train_lm.py``).

Futures at work in the loop: prefetched data batches, async checkpoints,
progress relay. Defaults are sized for a quick run (reduced model, 50
steps); ``--full`` trains the real 125M config at B=8, S=512. On a CUDA
tensor the mLSTM and sLSTM scans run as the hand-written kernels, their
backward by recompute through the plain versions; ``--kernel-impl plain``
runs the plain versions throughout.

Run on the GPU:  PYTHONPATH=src python examples/train_lm_torch.py [--full]
On the CPU:      PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""

import argparse
import os
import tempfile

import repro_torch.core as rc
from repro_torch.configs import get_arch
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="real 125M config instead of the reduced one")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm_torch"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--kernel-impl", default="hopper",
                    choices=("hopper", "plain"))
    args = ap.parse_args()

    rc.plan("threads", workers=2)      # data prefetch + ckpt writer overlap
    cfg = get_arch("xlstm-125m", smoke=not args.full)
    batch = args.batch or 8
    seq = args.seq or (512 if args.full else 64)

    tcfg = TrainerConfig(steps=args.steps, batch=batch, seq=seq,
                         log_every=max(args.steps // 10, 1),
                         ckpt_every=max(args.steps // 4, 1),
                         ckpt_dir=args.ckpt_dir, device=args.device,
                         kernel_impl=args.kernel_impl)
    trainer = Trainer(cfg, tcfg, AdamWConfig(
        lr=3e-3 if not args.full else 6e-4,
        warmup_steps=max(args.steps // 20, 1), total_steps=args.steps))
    state, history = trainer.run()
    first, last = history[0], history[-1]
    print(f"\nloss: {first['loss']:.4f} (step {first['step']}) -> "
          f"{last['loss']:.4f} (step {last['step']})")
    print(f"tokens/s: {last['step'] * batch * seq / last['wall_s']:.0f} "
          f"on {trainer.device}")
    print(f"checkpoints in {args.ckpt_dir}: latest step "
          f"{trainer.ckpt.latest_step()}")
    rc.shutdown()


if __name__ == "__main__":
    main()
