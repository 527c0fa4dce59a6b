"""Batched greedy-decode server: request futures + one decode loop.

Counterpart of the ``Server`` in ``examples/serve.py``. Clients submit
prompts and get back a ``repro_torch.core`` future over the generated
tokens; a serving loop batches whatever requests are pending into up to
``slots`` rows, prefills them by single-token decode steps, decodes
``max_new`` tokens greedily, and replies to each client on a
``queue.Queue`` that its future waits on. It serves any ported arch; each
batch's cache holds the batch's longest prompt plus ``max_new`` positions
(local attention keeps at most its window of them).
"""

from __future__ import annotations

import queue

import torch

from . import core as rc
from .configs import get_arch
from .device import resolve_device
from .models import Model
from .models.model import check_decode_capable
from .train import make_serve_step


class Server:
    """Greedy decode server with slot-based batching for the config
    ``arch``. ``params`` defaults to random weights drawn from ``seed``;
    ``smoke=False`` serves the full-width config. An encoder-only config
    (no decode step) is refused."""

    def __init__(self, arch: str = "xlstm-125m", *, smoke: bool = True,
                 slots: int = 4, max_new: int = 16, device=None,
                 params: "dict | None" = None, seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = get_arch(arch, smoke=smoke)
        check_decode_capable(self.cfg)
        self.model = Model(self.cfg)
        if params is None:
            params = self.model.init(torch.Generator().manual_seed(seed),
                                     device=self.device)
        self.params = params
        self.slots = slots
        self.max_new = max_new
        self.step = make_serve_step(self.model)
        self.requests: queue.Queue = queue.Queue()
        self._stop = False

    def submit(self, prompt_tokens: list[int]) -> "rc.Future":
        """Client-facing: returns a future over the generated tokens.

        The reply channel is a Queue, not a mutable dict: futures snapshot
        captured mutable containers at creation (the paper's globals
        semantics), so a later write to a captured dict would be invisible.
        Queues are synchronization objects and pass by reference.
        """
        reply: queue.Queue = queue.Queue(1)
        self.requests.put((prompt_tokens, reply))

        def wait():
            return reply.get()

        return rc.future(wait)

    def stop(self) -> None:
        self._stop = True

    def serve_loop(self):
        """One batch at a time; pads free slots with finished sequences."""
        while not self._stop:
            batch = []
            try:
                batch.append(self.requests.get(timeout=0.2))
            except queue.Empty:
                continue
            while len(batch) < self.slots:
                try:
                    batch.append(self.requests.get_nowait())
                except queue.Empty:
                    break
            self._decode_batch(batch)

    def _decode_batch(self, batch):
        b = len(batch)
        maxlen = max(len(p) for p, _ in batch)
        cache = self.model.init_cache(b, max_seq=maxlen + self.max_new,
                                      device=self.device,
                                      dtype=torch.float32)
        # prefill via single-token steps, then greedy decode
        outs: list[list[int]] = [[] for _ in range(b)]
        last = [0] * b
        for t in range(maxlen + self.max_new):
            col = [prompt[t] if t < len(prompt) else last[i]
                   for i, (prompt, _) in enumerate(batch)]
            tok = torch.tensor(col, dtype=torch.int64,
                               device=self.device)[:, None]
            nxt, cache = self.step(self.params, cache, tok)
            last = nxt[:, 0].tolist()
            for i, (prompt, _) in enumerate(batch):
                if t >= len(prompt) - 1:
                    outs[i].append(last[i])
        for i, (_, reply) in enumerate(batch):
            reply.put(outs[i][:self.max_new])
