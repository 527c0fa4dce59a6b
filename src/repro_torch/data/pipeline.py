"""Synthetic data pipeline with future-based prefetch. Counterpart of
``repro/data/pipeline.py``.

Batches are produced by *futures*: a window of ``prefetch`` batch futures
stays in flight; ``next_batch()`` collects the oldest (blocking only if the
producer is behind), refills the window and moves the batch to the model's
device. Batch content is a deterministic function of (seed, step, shard)
via counter-based RNG: :func:`synth_batch` is the JAX package's numpy
generator, copied, so both packages train on the same arrays.
"""

from __future__ import annotations

import functools
from collections import deque
from typing import Iterator

import numpy as np
import torch

from ..core import future, value
from ..device import resolve_device


def synth_batch(cfg, *, batch: int, seq: int, seed: int, step: int,
                shard: int = 0, n_shards: int = 1) -> dict:
    """Deterministic synthetic batch for (seed, step, shard), as numpy."""
    rng = np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step, shard)))
    out: dict = {}
    # zipf-flavoured token distribution, clipped to vocab
    toks = rng.zipf(1.3, size=(batch, seq + 1)) % cfg.vocab_size
    toks = toks.astype(np.int32)
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal(
            (batch, seq, cfg.frontend_dim)).astype(np.float32)
        out["labels"] = toks[:, :seq]
    else:
        out["tokens"] = toks[:, :seq]
        out["labels"] = toks[:, 1:]
    if cfg.rope_kind == "mrope":
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32),
                              (batch, seq)).copy()
        out["positions"] = np.stack([pos, pos, pos])
        out["vision_embeds"] = rng.standard_normal(
            (batch, min(64, seq), cfg.d_model)).astype(np.float32)
    return out


class Prefetcher:
    """Future-based double (N-)buffering of the input pipeline; batches
    arrive as tensors on ``device`` (the GPU by default)."""

    def __init__(self, cfg, *, batch: int, seq: int, seed: int = 0,
                 prefetch: int = 2, shard: int = 0, n_shards: int = 1,
                 device=None):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed, self.shard, self.n_shards = seed, shard, n_shards
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self._step = 0
        self._window: deque = deque()
        for _ in range(prefetch):
            self._enqueue()

    def _enqueue(self) -> None:
        step = self._step
        self._step += 1
        # NB: bind via partial — `seed` is also a future() *option* name
        producer = functools.partial(
            synth_batch, self.cfg, batch=self.batch, seq=self.seq,
            seed=self.seed, step=step, shard=self.shard,
            n_shards=self.n_shards)
        self._window.append(future(producer, label=f"data-{step}"))

    def next_batch(self) -> dict:
        self._enqueue()
        return {k: torch.from_numpy(a).to(self.device)
                for k, a in value(self._window.popleft()).items()}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
