"""Parameter-server training on the port's shared-state service (the twin
of ``examples/param_server.py``).

The classic asynchronous-SGD topology, expressed with nothing but
``future()`` + ``repro_torch.core.state``: the driver hosts the model as
one versioned entry, and every worker loops

    snapshot = state.get("ps")          # pull current params + opt state
    grads    = autograd(loss)(snapshot) # local compute, stale-ok
    state.update("ps", commit)          # atomic read-modify-write

where ``commit`` applies *this worker's* gradient to whatever the entry
holds **now** via :func:`repro_torch.optim.adamw.apply_updates`.
``update`` is the linearizable read-modify-write, so two workers
committing concurrently never lose a step.

The entry's version number *is* the global step counter: after W workers
each commit S updates, ``state.version("ps") == 1 + W * S`` exactly.

Like the original, it plans ``"cluster"``: each worker is a process of its
own that dials the driver over TCP (with a random token), and every
``state.get``/``state.update`` rides the worker's control socket — the
parameters cross as their bytes and land on the worker's card.

Run on the GPU:  PYTHONPATH=src python examples/param_server_torch.py
On the CPU:      PYTHONPATH=src python examples/param_server_torch.py --device cpu
"""

import argparse
import os

import numpy as np
import torch

import repro_torch.core as rc
from repro_torch.core import future, gather, plan, state, value
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state

DIM = 16
WORKERS = 4
STEPS = 12               # optimizer commits per worker
CFG = AdamWConfig(lr=0.05, warmup_steps=0, total_steps=WORKERS * STEPS,
                  weight_decay=0.0)


def make_problem(device, seed: int = 0):
    """Synthetic least squares: recover w* from noisy linear measurements."""
    rng = np.random.default_rng(seed)
    w_star = rng.normal(size=(DIM,))
    xs = rng.normal(size=(256, DIM))
    ys = xs @ w_star + 0.01 * rng.normal(size=(256,))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=device)
    return t(w_star), t(xs), t(ys)


def loss_of(params, xs, ys) -> float:
    return float(torch.mean((xs @ params["w"] - ys) ** 2))


def make_worker_body(xs, ys, cfg, steps):
    def body(wid: int, _xs=xs, _ys=ys, _cfg=cfg, _steps=steps):
        rng = np.random.default_rng(1000 + wid)
        for _ in range(_steps):
            # pull a snapshot (possibly stale by a few commits: PS model)
            snap = state.get("ps")
            idx = torch.as_tensor(rng.integers(0, _xs.shape[0], size=32),
                                  device=_xs.device)
            w = snap["params"]["w"].detach().requires_grad_(True)
            loss = torch.mean((_xs[idx] @ w - _ys[idx]) ** 2)
            (g,) = torch.autograd.grad(loss, [w])
            grads = {"w": g}

            def commit(cur, g=grads):
                # atomic apply against the *current* entry: every gradient
                # lands exactly once
                p2, s2, _metrics = apply_updates(
                    _cfg, cur["params"], g, cur["opt"])
                return {"params": p2, "opt": s2}

            state.update("ps", commit)
        return state.stats()["cas_retries"]
    return body


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)
    plan("cluster", workers=WORKERS, token=os.urandom(8).hex())
    w_star, xs, ys = make_problem(device)

    # the driver seeds the model entry: params + optimizer state together,
    # one key, so a commit is atomic over both
    params = {"w": torch.zeros(DIM, device=device)}
    state.put("ps", {"params": params, "opt": init_state(params)})
    loss0 = loss_of(params, xs, ys)

    body = make_worker_body(xs, ys, CFG, STEPS)
    retries = value(gather([future(lambda i=i, b=body: b(i))
                            for i in range(WORKERS)]))

    final = state.get("ps")
    loss1 = loss_of(final["params"], xs, ys)
    steps = state.version("ps") - 1          # v1 was the seed put
    print(f"workers={WORKERS} steps/worker={STEPS} "
          f"commits={steps} cas_retries={sum(retries)} on {device}")
    print(f"loss: {loss0:.4f} -> {loss1:.4f}   |w - w*|: "
          f"{float(torch.linalg.norm(final['params']['w'] - w_star)):.4f}")
    assert steps == WORKERS * STEPS, "lost or duplicated a commit"
    assert loss1 < loss0 * 0.5, "training did not make progress"
    rc.shutdown()


if __name__ == "__main__":
    main()
