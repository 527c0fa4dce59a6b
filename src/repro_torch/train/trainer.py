"""Trainer: the single-process training loop with futures woven through it.
Counterpart of ``repro/train/trainer.py``.

Futures in the loop:

* data batches arrive via the Prefetcher's future window;
* checkpoint writes are futures overlapping the next steps;
* the step's kernels run asynchronously on the card, and the loop reads
  its metrics (the only host sync) at log steps alone;
* ``signal_progress`` emits immediateConditions that the plan's backend
  can relay.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import torch

from ..checkpoint import CheckpointManager
from ..core import signal_progress
from ..data import Prefetcher
from ..device import resolve_device
from ..models.model import Model
from ..optim import AdamWConfig
from .state import TrainState, init_train_state
from .step import make_eval_step, make_train_step

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    seed: int = 0
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    microbatches: int = 1
    remat: str = "none"
    param_dtype: Any = None          # default float32
    device: Any = None               # default the GPU
    kernel_impl: str = "hopper"


class Trainer:
    def __init__(self, cfg, tcfg: TrainerConfig,
                 opt: AdamWConfig | None = None):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(tcfg.device)
        self.opt_cfg = opt or AdamWConfig(total_steps=tcfg.steps)
        self.model = Model(cfg, kernel_impl=tcfg.kernel_impl,
                           remat=tcfg.remat)
        self.step_fn: Callable = make_train_step(
            self.model, self.opt_cfg, microbatches=tcfg.microbatches)
        self.eval_fn = make_eval_step(self.model)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)

    def init_or_restore(self, generator: torch.Generator | None = None
                        ) -> tuple[TrainState, int]:
        """Parameters drawn from ``generator`` (by default one on the
        trainer's device seeded with ``seed``), or the latest checkpoint."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(
                self.tcfg.seed)
        dtype = self.tcfg.param_dtype or torch.float32
        params = self.model.init(generator, device=self.device, dtype=dtype)
        state = init_train_state(params)
        start = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            state, start = self.ckpt.restore(state)
            log.info("restored checkpoint at step %d", start)
        return state, start

    def run(self, state: TrainState | None = None, *,
            start_step: int = 0) -> tuple[TrainState, list[dict]]:
        tcfg = self.tcfg
        if state is None:
            state, start_step = self.init_or_restore()
        data = Prefetcher(self.cfg, batch=tcfg.batch, seq=tcfg.seq,
                          seed=tcfg.seed, device=self.device)
        history: list[dict] = []
        t0 = time.time()
        for step in range(start_step, tcfg.steps):
            batch = data.next_batch()
            state, metrics = self.step_fn(state, batch)
            if (step + 1) % tcfg.log_every == 0 or step + 1 == tcfg.steps:
                m = {k: float(v) for k, v in metrics.items()}  # host sync
                m["step"] = step + 1
                m["wall_s"] = time.time() - t0
                history.append(m)
                signal_progress(
                    f"step {step + 1}/{tcfg.steps} "
                    f"loss={m.get('loss', float('nan')):.4f}")
            if self.ckpt and (step + 1) % tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, state)           # async future
        if self.ckpt:
            self.ckpt.save(tcfg.steps, state, block=True)
        return state, history
