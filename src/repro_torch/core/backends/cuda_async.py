"""plan(cuda_async): futures resolved by the card's stream, through CUDA events.

PyTorch's CUDA operators are already asynchronous: each call enqueues its
kernels on the current stream and returns at once, so a function of CUDA
tensors is a promise over device work. This backend makes that explicit in
Future-API terms (the counterpart of the JAX package's ``jax_async``):

* ``submit`` runs the body on the caller's thread — cheap, it only
  enqueues — under the same nested-plan, RNG and capture harness as every
  backend, then records a ``torch.cuda.Event`` on the current stream;
* ``resolved`` maps to ``event.query()`` and ``collect`` to
  ``event.synchronize()``; ``wait`` is the base class's (a bounded
  ``query()`` poll when timed — CUDA has no timed multi-event wait).

What the event covers, and what it does not:

* only the work enqueued on the submitting thread's *current stream*.
  PyTorch gives every thread the device's default stream unless a body
  changes it; a body that launches on a stream of its own must join it
  to the current one (``torch.cuda.current_stream().wait_stream(s)``)
  before it returns;
* a host sync inside the body (``.item()``, ``.tolist()``, a copy to the
  host) makes ``submit`` wait for the card: still correct, no longer
  asynchronous;
* Python errors are captured at submit, like every backend; an error the
  device raises surfaces from ``collect``, at ``value()``.

``plan("cuda_async")`` runs on the GPU (``repro_torch.device``) and raises
on a host without one. ``plan("cuda_async", device="cpu")`` is the
synchronous form — the body runs at submit and there is nothing to wait
for — so the tests can run the backend on the CPU.
"""

from __future__ import annotations

import threading

import torch

from ..conditions import CapturedRun, capture_run
from .. import planning as plan_mod
from ..rng import rng_scope
from ...device import resolve_device
from .base import Backend, TaskSpec, register_backend


def _new_event(device: torch.device):
    """An event recorded on ``device``'s current stream, after the work the
    body enqueued; ``None`` on the CPU, where nothing is left to wait for."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class _Handle:
    """The body's captured run and the event that marks its device work
    done. ``callbacks`` is None until a callback is registered, then the
    list the watcher fans out, then ``"fired"``."""

    __slots__ = ("run", "event", "callbacks")

    def __init__(self, run: CapturedRun, event):
        self.run = run
        self.event = event
        self.callbacks = None


@register_backend("cuda_async")
class CudaAsyncBackend(Backend):
    supports_immediate = True

    @classmethod
    def validate_spec(cls, device=None) -> None:
        resolve_device(device)          # raises without a card, unless cpu

    def __init__(self, device: "str | torch.device | None" = None):
        self.device = resolve_device(device)
        self._cb_lock = threading.Lock()

    def free_slots(self) -> int:
        # Dispatch only enqueues: the stream queues without bound, so
        # admission always grants one more slot (the inherited try_submit
        # forwards to submit) — the caller's ``max_in_flight`` bounds
        # outstanding work. (dispatches_continuations stays False: submit()
        # would run the continuation inline on the completion watcher
        # thread, which must stay non-blocking — continuations take the
        # bounced path.)
        return 1

    def submit(self, task: TaskSpec) -> _Handle:
        with plan_mod.use_nested_stack():
            with rng_scope(task.seed_declared):
                run = capture_run(
                    lambda: task.fn(*task.args, **task.kwargs),
                    capture_stdout=task.capture_stdout,
                    capture_conditions=task.capture_conditions,
                )
        return _Handle(run, None if run.error is not None
                       else _new_event(self.device))

    def poll(self, handle: _Handle) -> bool:
        return handle.event is None or handle.event.query()

    def collect(self, handle: _Handle) -> CapturedRun:
        if handle.event is not None:
            handle.event.synchronize()
        return handle.run

    def add_done_callback(self, handle: _Handle, cb) -> None:
        # Python-level work ran at submit; only device work is outstanding.
        # CUDA has no host-side completion hook that may run Python, so one
        # watcher thread per handle parks in event.synchronize() and fans
        # out to every registered callback exactly once. The "fired"
        # sentinel is written under _cb_lock on *every* path that fires,
        # including the already-done fast path, so a registration racing
        # it can neither spawn a second watcher nor be fanned out twice.
        fire = False
        with self._cb_lock:
            cbs = handle.callbacks
            if cbs == "fired":
                fire = True
            elif cbs is None:
                if self.poll(handle):
                    handle.callbacks = "fired"
                    fire = True
                else:
                    handle.callbacks = [cb]
                    threading.Thread(target=self._watch, args=(handle,),
                                     name="cuda-done-watch",
                                     daemon=True).start()
            else:
                cbs.append(cb)
        if fire:
            cb(handle)

    def _watch(self, handle: _Handle) -> None:
        try:
            self.collect(handle)
        except Exception:                   # noqa: BLE001 — errored == resolved
            pass
        with self._cb_lock:
            pending = handle.callbacks
            handle.callbacks = "fired"
        for fn in pending:
            try:
                fn(handle)
            except Exception:               # noqa: BLE001 — one bad callback
                import traceback            # must not starve the others
                traceback.print_exc()
