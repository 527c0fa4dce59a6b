"""Batched serving example on the PyTorch port: request futures + one
decode loop (the twin of ``examples/serve.py``).

Clients submit prompts as *futures* on a thread backend; the serving loop
batches whatever requests are pending, runs greedy decode steps against
per-slot recurrent caches, and resolves each client's future when its
sequence finishes. `resolved()` gives clients non-blocking polling — the
Future API as a serving front door.

Run on the GPU:  PYTHONPATH=src python examples/serve_torch.py
On the CPU:      PYTHONPATH=src python examples/serve_torch.py --device cpu
Full width:      add --full
Another arch:    add --arch recurrentgemma-9b, yi-9b, qwen2-moe-a2.7b or
                 deepseek-moe-16b (full width: 41.8, 35.3, 60.6 and 65.5 GB
                 of fp32 parameters, drawn on the card)
"""

import argparse
import threading
import time

import numpy as np
import torch

import repro_torch.core as rc
from repro_torch.configs import all_archs, get_arch
from repro_torch.serve import Server


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="serve the full-width config, not the smoke one")
    # an encoder-only arch (hubert-xlarge) has no decode step to serve
    ap.add_argument("--arch", default="xlstm-125m",
                    choices=[a for a in all_archs()
                             if get_arch(a).decode_capable])
    args = ap.parse_args()

    rc.plan("threads", workers=4)
    params = None
    if args.full and args.device != "cpu":
        # draw full-width weights with the card's generator: the CPU one
        # takes tens of seconds for 10 B values
        from repro_torch.models import Model
        params = Model(get_arch(args.arch)).init(
            torch.Generator(device="cuda").manual_seed(0))
    server = Server(args.arch, smoke=not args.full, device=args.device,
                    params=params)
    loop = threading.Thread(target=server.serve_loop, daemon=True)
    loop.start()

    rng = np.random.default_rng(0)
    t0 = time.time()
    futures = []
    for i in range(6):
        prompt = rng.integers(0, server.cfg.vocab_size, size=4).tolist()
        futures.append((i, prompt, server.submit(prompt)))
        print(f"request {i}: submitted prompt={prompt}")

    pending = dict((i, f) for i, _, f in futures)
    while pending:
        for i, f in list(pending.items()):
            if rc.resolved(f):
                toks = rc.value(f)
                print(f"request {i}: done -> {toks[:8]}... "
                      f"({time.time() - t0:.2f}s)")
                del pending[i]
        time.sleep(0.01)
    server.stop()
    loop.join(timeout=5)
    rc.shutdown()
    print("all requests served")


if __name__ == "__main__":
    main()
