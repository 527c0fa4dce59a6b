"""Multi-pod training driver: the Future API orchestrating pods.
Counterpart of ``repro/launch/train.py``.

Each *pod* is a worker on the ``cluster`` backend; one training **round**
dispatches one future per pod. A pod runs H local AdamW steps on its data
shard (DiLoCo-style local updates: one delta exchange per round instead of
a gradient all-reduce per step, matching slow inter-pod links), then
returns its parameter delta.

The driver:
  * collects the pod futures as they resolve, sleeping on one
    cross-backend ``Waiter`` per round (the cluster's select loop pushes
    each completion through ``add_done_callback``);
  * re-dispatches on ``FutureError`` (node failure; the pool relaunches
    the worker underneath);
  * races a speculative duplicate of every unresolved pod after
    ``straggler_timeout_s`` (the ``future_either`` pattern), the first
    result winning and the other candidates cancelled;
  * compresses the delta exchange (int8 + error feedback per pod), takes
    the mean and applies a Nesterov outer step;
  * writes async checkpoints through a future on a local thread (the
    writes stay on the driver's disk and off the pods).

The parameters travel as a flat list of fp32 host arrays in the port's
leaf order (``repro_torch.tree.leaves`` of ``Model.init``), each large
leaf content-addressed (its raw bytes sent once a worker and round, never
inside the task blob);
``repro_torch.convert.flat_params_from_jax`` maps the reference driver's
list (``jax.tree_util.tree_leaves`` order) onto it. A pod trains on
``PodRunConfig.device``: the GPU unless the caller asks for the CPU.

Run: PYTHONPATH=src python -m repro_torch.launch.train --pods 2 [--full]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..core import (FutureError, Waiter, active_backend, future, plan,
                    shutdown, value)
from ..core.backends.blobstore import DEFAULT_STORE_BYTES
from ..optim.compression import ErrorFeedback

#: the pod worker's model, parameter template and train step, kept between
#: rounds (pods are long-lived processes)
_POD_CACHE: "dict | None" = None


@dataclasses.dataclass
class PodRunConfig:
    arch: str = "xlstm-125m"
    pods: int = 2
    rounds: int = 4
    local_steps: int = 5
    batch: int = 4
    seq: int = 64
    lr: float = 1e-3
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    compress: bool = True
    seed: int = 0
    ckpt_dir: str | None = None
    smoke: bool = True              # reduced configs, as the reference's
    straggler_timeout_s: float | None = None
    # fault injection (tests / examples)
    fail_marker: str | None = None  # kill one pod once, then recover
    straggle_pod: int | None = None
    straggle_s: float = 0.0
    device: str = "cuda"            # where each pod trains
    #: further ``plan("cluster", ...)`` kwargs (token, connect_timeout, ...)
    plan_kwargs: dict = dataclasses.field(default_factory=dict)


def kernel_launches() -> dict:
    """Each kernel's launches in this process so far, by name (the
    backward kernels' as ``mlstm_scan_backward`` and
    ``slstm_scan_backward``)."""
    from ..kernels import (decode_attention, flash_attention, mlstm_scan,
                           rglru_scan, slstm_scan)
    mods = (mlstm_scan, slstm_scan, rglru_scan, flash_attention,
            decode_attention)
    return {**{m.__name__.rsplit(".", 1)[1]: m.launches for m in mods},
            "mlstm_scan_backward": mlstm_scan.backward_launches,
            "slstm_scan_backward": slstm_scan.backward_launches}


def pod_round(arch: str, smoke: bool, params_flat: "list[np.ndarray]",
              round_idx: int, pod_id: int, n_pods: int,
              local_steps: int, batch: int, seq: int, lr: float,
              seed: int, fail_marker: str | None = None,
              straggle_s: float = 0.0, device: str = "cuda") -> dict:
    """Executed inside a pod worker (shipped by the future machinery: its
    code by value, so everything it uses is imported inside it, and its
    cache kept on this module as imported in the worker).

    ``fail_marker``: fault-injection hook — if set and the file does not
    exist yet, create it and kill this worker (simulated node failure; the
    retry path must converge). ``straggle_s``: artificial slowness.

    Returns the pod's fp32 delta (its parameters after ``local_steps``
    steps minus the ones shipped, host arrays in the port's leaf order),
    the last step's loss and the tokens trained on; and, to read in the
    driver, the kernel launches this call made, its pid, its device and
    the wall clock (``time.time()``) at its start and end.
    """
    if fail_marker and not os.path.exists(fail_marker):
        open(fail_marker, "w").close()
        os._exit(43)                      # hard node failure
    if straggle_s:
        time.sleep(straggle_s)
    started = time.time()
    import repro_torch.launch.train as _self
    from repro_torch.configs import get_arch
    from repro_torch.core import signal_progress
    from repro_torch.data import synth_batch
    from repro_torch.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves, tree_map

    dev = resolve_device(device)          # no card: raises, never the CPU
    ckey = (arch, smoke, lr, local_steps, str(dev))
    cache = _self._POD_CACHE
    if cache is None or cache["key"] != ckey:
        cfg = get_arch(arch, smoke=smoke)
        model = Model(cfg)
        cache = _self._POD_CACHE = {
            "key": ckey, "cfg": cfg,
            "template": model.init(torch.Generator(), device="meta"),
            "step": make_train_step(model, AdamWConfig(
                lr=lr, warmup_steps=0, total_steps=max(local_steps, 1)))}
    cfg, template, step_fn = cache["cfg"], cache["template"], cache["step"]
    n_leaves = sum(1 for _ in leaves(template))
    if len(params_flat) != n_leaves:
        raise ValueError(f"{len(params_flat)} parameter arrays shipped, "
                         f"{arch} has {n_leaves} leaves")

    shipped = [np.asarray(a, np.float32) for a in params_flat]
    it = iter(shipped)
    params = tree_map(lambda leaf: torch.tensor(
        next(it), dtype=leaf.dtype, device=dev), template)
    state = TrainState(params, adamw.init_state(params))

    before = _self.kernel_launches()
    loss = float("nan")
    for i in range(local_steps):
        data = synth_batch(cfg, batch=batch, seq=seq, seed=seed,
                           step=round_idx * local_steps + i, shard=pod_id,
                           n_shards=n_pods)
        data = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        state, metrics = step_fn(state, data)
        loss = float(metrics["loss"])
    signal_progress(f"pod {pod_id} round {round_idx} loss={loss:.4f}")

    delta = [p.detach().to("cpu", torch.float32).numpy() - o
             for p, o in zip(leaves(state.params), shipped)]
    launches = {k: n - before[k] for k, n in _self.kernel_launches().items()
                if n != before[k]}
    return {"pod": pod_id, "round": round_idx, "loss": loss,
            "delta": delta, "tokens": local_steps * batch * seq,
            "launches": launches, "pid": os.getpid(),
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else dev.type),
            "clock": (started, time.time())}


def _writable(a: np.ndarray) -> np.ndarray:
    """A decoded result's arrays may be read-only views of its blob;
    ``torch.from_numpy`` wants a writable one."""
    return a if a.flags.writeable else a.copy()


class MultiPodDriver:
    def __init__(self, cfg: PodRunConfig,
                 params: "list[np.ndarray] | None" = None):
        """``params``: the initial flat parameter list in the port's leaf
        order (default: ``Model.init`` drawn from ``cfg.seed``)."""
        self.cfg = cfg
        if params is None:
            from ..configs import get_arch
            from ..models import Model
            from ..tree import leaves
            tree = Model(get_arch(cfg.arch, smoke=cfg.smoke)).init(
                torch.Generator().manual_seed(cfg.seed), device="cpu")
            params = [p.numpy() for p in leaves(tree)]
        self.params = [np.asarray(p, np.float32) for p in params]
        # each large leaf ships as a put of its raw bytes, once a worker and
        # round; a pod's store holds the round's list beside its held
        # delta (and the last round's list until the LRU drops it)
        nbytes = sum(p.nbytes for p in self.params)
        store = ({"blob_store_bytes": 3 * nbytes}
                 if 3 * nbytes > DEFAULT_STORE_BYTES else {})
        plan("cluster", workers=cfg.pods, **{**store, **cfg.plan_kwargs})
        self.velocity = [np.zeros_like(p) for p in self.params]
        self.ef = [ErrorFeedback() for _ in range(cfg.pods)]
        self.history: list[dict] = []
        self.ckpt = None
        if cfg.ckpt_dir:
            from ..checkpoint import CheckpointManager
            from ..core.backends.threads import ThreadBackend
            self.ckpt = CheckpointManager(
                cfg.ckpt_dir, backend=ThreadBackend(workers=1))

    # -- one communication round -------------------------------------------

    def _dispatch(self, pod: int, rnd: int, *, speculative: bool = False):
        c = self.cfg
        straggle = (c.straggle_s if (c.straggle_pod == pod
                                     and not speculative) else 0.0)
        return future(
            pod_round, c.arch, c.smoke, self.params, rnd, pod, c.pods,
            c.local_steps, c.batch, c.seq, c.lr, c.seed,
            fail_marker=c.fail_marker if pod == 0 else None,
            straggle_s=straggle, device=c.device,
            label=f"pod{pod}-round{rnd}{'+spec' if speculative else ''}")

    def run_round(self, rnd: int) -> dict:
        """One round. Besides the reference's keys, the record holds the
        seconds after the first dispatches (the clock of ``wall_s``) at
        which each pod's result was in (``pulled_s``) and at which a
        failed candidate was re-dispatched (``redispatched``, ``(pod, s)``
        pairs), and the exchange's seconds (``exchange_s``: compression,
        mean and outer step)."""
        c = self.cfg
        # Each pod has a list of racing candidates (future_either pattern).
        # One Waiter spans the whole round: every candidate — initial,
        # re-dispatched after a node failure, or speculative — registers a
        # completion callback once, and the loop sleeps on one condition
        # variable until a pod backend pushes (select loop under cluster).
        fs: dict[int, list] = {pod: [self._dispatch(pod, rnd)]
                               for pod in range(c.pods)}
        owner = {id(f): pod for pod, cands in fs.items() for f in cands}
        waiter = Waiter(f for cands in fs.values() for f in cands)
        results: dict[int, dict] = {}
        pulled: dict[int, float] = {}
        redispatched: list[tuple[int, float]] = []
        t0 = time.time()
        speculated = False
        while len(results) < c.pods:
            # Before the speculation deadline, cap the wait so the straggler
            # check below fires on time; after it, block until a pod pushes.
            timeout = None
            if c.straggler_timeout_s and not speculated:
                timeout = max(0.0, c.straggler_timeout_s
                              - (time.time() - t0))
            done = waiter.wait(timeout)
            if c.straggler_timeout_s and not speculated and \
                    time.time() - t0 > c.straggler_timeout_s:
                # speculative duplicates for every unresolved pod
                for pod, cands in fs.items():
                    if pod not in results:
                        nf = self._dispatch(pod, rnd, speculative=True)
                        cands.append(nf)
                        owner[id(nf)] = pod
                        waiter.add(nf)
                speculated = True
            for f in done:
                pod = owner[id(f)]
                if pod in results:          # late loser: winner already in
                    continue
                try:
                    results[pod] = value(f)
                except FutureError:
                    # node failure: pool self-healed; re-dispatch
                    redispatched.append((pod, time.time() - t0))
                    cands = fs[pod]
                    cands.remove(f)
                    nf = self._dispatch(pod, rnd)
                    cands.append(nf)
                    owner[id(nf)] = pod
                    waiter.add(nf)
                    continue
                pulled[pod] = time.time() - t0
                for other in fs[pod]:       # first resolved wins
                    if other is not f:
                        other.cancel()

        # -- compressed delta averaging (int8 + EF), then outer Nesterov --
        tx = time.time()
        deltas = []
        for pod in range(c.pods):
            d = {i: torch.from_numpy(_writable(x))
                 for i, x in enumerate(results[pod]["delta"])}
            if c.compress:
                _, d = self.ef[pod].compress(d)
            deltas.append([d[i].numpy() for i in range(len(d))])
        avg = [np.mean([d[i] for d in deltas], axis=0)
               for i in range(len(self.params))]
        m = self.cfg.outer_momentum
        for i, g in enumerate(avg):
            self.velocity[i] = m * self.velocity[i] + g
            self.params[i] = self.params[i] + c.outer_lr * (
                g + m * self.velocity[i])

        loss = float(np.mean([results[p]["loss"] for p in range(c.pods)]))
        rec = {"round": rnd, "loss": loss,
               "tokens": sum(results[p]["tokens"] for p in range(c.pods)),
               "wall_s": time.time() - t0, "pulled_s": pulled,
               "redispatched": redispatched, "exchange_s": time.time() - tx}
        self.history.append(rec)
        return rec

    def run(self) -> list[dict]:
        for rnd in range(self.cfg.rounds):
            rec = self.run_round(rnd)
            print(f"round {rec['round']}: loss={rec['loss']:.4f} "
                  f"tokens={rec['tokens']}", flush=True)
            if self.ckpt:
                self.ckpt.save(rnd + 1,
                               {str(i): p for i, p in
                                enumerate(self.params)})
        if self.ckpt:
            self.ckpt.wait()
        return self.history

    def resize(self, pods: int) -> None:
        """Elastic scaling between rounds."""
        active_backend().resize(pods)
        old = self.cfg.pods
        self.cfg.pods = pods
        if pods > old:
            self.ef.extend(ErrorFeedback() for _ in range(pods - old))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the pods train (cuda, or cpu)")
    ap.add_argument("--full", action="store_true",
                    help="the arch at full width (default: its smoke config)")
    args = ap.parse_args()
    cfg = PodRunConfig(arch=args.arch, pods=args.pods, rounds=args.rounds,
                       local_steps=args.local_steps, batch=args.batch,
                       seq=args.seq, compress=not args.no_compress,
                       ckpt_dir=args.ckpt_dir, smoke=not args.full,
                       device=args.device)
    try:
        driver = MultiPodDriver(cfg)
        hist = driver.run()
    finally:
        shutdown()
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} over {len(hist)} rounds")


if __name__ == "__main__":
    main()
