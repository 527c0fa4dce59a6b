"""plan(threads): resolve futures on a pool of threads.

The in-process analogue of the paper's ``multicore`` (shared-memory,
zero-copy globals). PyTorch releases the GIL inside its operators, so this
gives real overlap for device work and I/O; for pure-Python bodies it gives
concurrency. Creation blocks when all workers are busy, matching the
paper's semantics ("future() blocks until one of the workers is available").

Immediate conditions are supported live: the worker thread pushes progress
events onto a queue the parent drains at resolved()/value().

Worker threads are *reused*: a thread that finishes a body parks on the
dispatch queue and serves the next handle, spawning only when every live
worker is busy (same cached-executor discipline as the continuation pool).
Idle workers retire after a short grace, so a quiet plan("threads") holds
no threads at all — and a tight future/value loop stops paying a thread
spawn per future.
"""

from __future__ import annotations

import queue
import threading
from typing import Any

from ..conditions import CapturedRun, ImmediateCondition, capture_run
from ..errors import FutureCancelledError
from .. import planning as plan_mod
from ..rng import rng_scope
from .base import (Backend, CompletionHandle, EventWaitMixin,
                   SlotCounterMixin, TaskSpec, register_backend)


class _Handle(CompletionHandle):
    def __init__(self, task: TaskSpec):
        super().__init__()
        self.task = task
        self.run: CapturedRun | None = None
        self.immediate: queue.SimpleQueue[ImmediateCondition] = queue.SimpleQueue()
        self.cancelled = False


@register_backend("threads")
class ThreadBackend(SlotCounterMixin, EventWaitMixin, Backend):
    supports_immediate = True
    # dispatches_continuations stays False: a continuation occupying one
    # of these *bounded* slots deadlocks the moment user code inside it
    # creates/waits a nested eager future (workers=1: the continuation
    # holds the only slot the nested submit blocks on). Continuations take
    # the slot-free continuation pool, which preserves the old liveness
    # guarantee while still bounding and reusing threads.

    #: how long a worker thread lingers on the dispatch queue before
    #: retiring; long enough to be reused across back-to-back futures,
    #: short enough that a quiet backend holds no threads
    _IDLE_GRACE_S = 2.0

    def __init__(self, workers: int | None = None):
        from ..planning import available_cores
        self._n = int(workers) if workers else available_cores()
        # exact free-slot counter (not a bare Semaphore) so the admission
        # protocol can report real capacity
        self._init_slots(self._n)
        self._nested = plan_mod.nested_stack()
        self._init_wait()
        self._open = True
        # cached worker pool (see module docstring): handles flow through
        # _queue; _idle/_pending decide whether a submit must spawn
        self._queue: queue.SimpleQueue[_Handle] = queue.SimpleQueue()
        self._pool_lock = threading.Lock()
        self._idle = 0
        self._pending = 0

    def submit(self, task: TaskSpec) -> _Handle:
        self._acquire_slot()             # paper semantics: block for a worker
        return self._start(task)

    def try_submit(self, task: TaskSpec) -> "_Handle | None":
        if not self._acquire_slot(blocking=False):
            return None
        return self._start(task)

    def _start(self, task: TaskSpec) -> _Handle:
        handle = _Handle(task)
        with self._pool_lock:
            self._pending += 1
            spawn = self._pending > self._idle
        self._queue.put(handle)
        if spawn:
            threading.Thread(target=self._drain, name="threads-worker",
                             daemon=True).start()
        return handle

    def _drain(self) -> None:
        while True:
            with self._pool_lock:
                self._idle += 1
            try:
                handle = self._queue.get(timeout=self._IDLE_GRACE_S)
            except queue.Empty:
                with self._pool_lock:
                    self._idle -= 1
                    if self._pending == 0:
                        return           # truly quiet: retire
                # a _start() saw us idle in the instant our grace expired
                # and skipped the spawn — its handle is enqueued with no
                # other worker committed to it, so loop and claim it (the
                # lock orders the two: either we see its pending increment
                # here, or it sees our idle decrement and spawns)
                continue
            with self._pool_lock:
                self._idle -= 1
                self._pending -= 1
            self._worker(handle)

    def _worker(self, handle: _Handle) -> None:
        task = handle.task
        try:
            if handle.cancelled:
                run = CapturedRun(error=FutureCancelledError(
                    "future cancelled before it started",
                    future_label=task.label))
            else:
                with plan_mod.use_nested_stack(self._nested):
                    with rng_scope(task.seed_declared):
                        run = capture_run(
                            lambda: task.fn(*task.args, **task.kwargs),
                            capture_stdout=task.capture_stdout,
                            capture_conditions=task.capture_conditions,
                            immediate_emit=handle.immediate.put,
                        )
            handle.run = run
        finally:
            self._release_slot()
            # push completion: fires done-callbacks from this worker thread
            self._complete(handle)

    def poll(self, handle: _Handle) -> bool:
        return handle.done.is_set()

    def collect(self, handle: _Handle) -> CapturedRun:
        handle.done.wait()
        assert handle.run is not None
        return handle.run

    def drain_immediate(self, handle: _Handle) -> list[ImmediateCondition]:
        out = []
        while True:
            try:
                out.append(handle.immediate.get_nowait())
            except queue.Empty:
                return out

    def cancel(self, handle: _Handle) -> bool:
        # Threads cannot be killed; we can only prevent a queued start.
        handle.cancelled = True
        return not handle.done.is_set() and handle.run is None

    @property
    def workers(self) -> int:
        return self._n
