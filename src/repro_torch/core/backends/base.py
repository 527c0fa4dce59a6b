"""Backend ABC + registry (the paper's 'future backend' contract).

A backend resolves futures. The *Future API conformance* contract (paper
§Validation / future.tests) is: for any backend, the same program yields the
same value, the same relayed output/conditions, the same RNG streams, and
the same exception behaviour. ``tests/test_conformance.py`` asserts this for
every registered backend.
"""

from __future__ import annotations

import abc
import dataclasses
import threading
import time
from typing import Any, Callable, Sequence

from ..conditions import CapturedRun, ImmediateCondition


@dataclasses.dataclass
class TaskSpec:
    """Everything a backend needs to evaluate one future."""
    task_id: int
    fn: Callable[..., Any]              # frozen callable (globals snapshotted)
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    label: str = ""
    capture_stdout: bool = True
    capture_conditions: bool = True
    seed_declared: bool = False
    # For the out-of-process backends only: the pre-shipped function blob.
    shipped: bytes | None = None
    # Content-addressed payloads referenced by the shipped blob:
    # digest -> PayloadSource (pinned for the task's lifetime so ``need``
    # backfills can always be served). ``refs`` is the digest tuple the
    # worker must hold before evaluating.
    payload_sources: dict = dataclasses.field(default_factory=dict)
    # Digests whose current holders make *better homes* for this task: the
    # cluster backend prefers an idle worker already holding them (locality
    # scheduling for continuation chains); other backends ignore it.
    affinity: tuple = ()
    # Serving-tier attribution: which tenant submitted this task. ``None``
    # (direct library use) bypasses per-tenant policy entirely; a named
    # tenant is dispatched through the cluster's fair-share scheduler and
    # counted in its wire/recovery stats.
    tenant: "str | None" = None

    @property
    def refs(self) -> tuple:
        return tuple(self.payload_sources)


class Backend(abc.ABC):
    """One resolver of futures. Implementations must be registered in
    BACKEND_REGISTRY to be usable from plan()."""

    name: str = "abstract"
    #: whether immediateConditions can be relayed before value()
    supports_immediate: bool = False

    @classmethod
    def validate_spec(cls, **kwargs) -> None:
        """Raise if a plan level with these constructor kwargs cannot run
        on this host; ``plan()`` calls it before installing the level."""

    @abc.abstractmethod
    def submit(self, task: TaskSpec) -> Any:
        """Begin resolving; returns an opaque handle. May block when all
        workers are busy (paper: future() blocks until a worker frees up)."""

    # -- admission control ---------------------------------------------------
    #
    # The streaming frontend (``core/stream.py``) and the continuation
    # dispatcher do not want the paper's "future() blocks" semantics: they
    # hold a queue of runnable work and need to dispatch *exactly when
    # capacity exists*. ``free_slots``/``try_submit`` are that protocol —
    # submission becomes an admission decision the caller can take without
    # parking a thread inside ``submit``.

    #: whether continuation steps may run through this backend's
    #: ``try_submit``. Only safe for backends whose submission is
    #: synchronous and slot-free (sequential): a continuation *holding a
    #: bounded worker slot* deadlocks when user code inside it blocks on a
    #: nested eager future, and process/socket backends only run pickled
    #: blobs anyway. Everything else takes the slot-free continuation pool.
    dispatches_continuations: bool = False

    def free_slots(self) -> int:
        """How many tasks this backend could begin resolving right now
        without blocking in ``submit()``.

        The default (for third-party backends that predate the admission
        protocol) optimistically reports ``workers`` — their ``try_submit``
        therefore degrades to plain ``submit`` and may block, which is
        exactly the legacy behaviour. Built-in backends report real counts:
        free pool threads/processes, or the cluster driver's idle-worker
        set (relaunch-pending slots count as absent — a slot that is being
        respawned cannot accept work *now*).
        """
        return self.workers

    def try_submit(self, task: TaskSpec) -> Any:
        """Non-blocking submit: begin resolving ``task`` iff a worker is
        free, else return ``None`` (the caller keeps the task queued and
        re-offers it when capacity frees — e.g. after the next completion
        callback). Never blocks on built-in backends.

        The default routes through :meth:`free_slots`, which makes it
        exact wherever ``free_slots`` is.
        """
        if self.free_slots() <= 0:
            return None
        return self.submit(task)

    @abc.abstractmethod
    def poll(self, handle: Any) -> bool:
        """Non-blocking: is the future resolved?"""

    @abc.abstractmethod
    def collect(self, handle: Any) -> CapturedRun:
        """Block until resolved and return the captured run.

        Infrastructure failures raise FutureError; evaluation errors are
        *inside* the CapturedRun (relayed by the Future at value())."""

    def wait(self, handles: Sequence[Any], timeout: "float | None" = None
             ) -> list[Any]:
        """Block until at least one handle is resolved; return the resolved
        subset (possibly empty iff ``timeout`` elapsed first).

        This is the event-driven primitive that ``resolve()`` /
        ``as_completed()`` / ``future_map`` build on instead of sleep-polling
        ``poll()``. Built-in backends override it with a real event wait
        (socket ``select`` for cluster, a completion condition variable for
        threads/processes, immediacy for sequential/jax_async).

        The default is for third-party backends that predate ``wait()``.
        Untimed, it blocks on ``collect()`` of the first handle — exact for
        synchronous backends (everything resolved at submit). With a finite
        ``timeout`` it must *not* do that (``collect()`` could overshoot the
        deadline by the whole task duration), so it falls back to a bounded
        ``poll()`` loop that honours the deadline.
        """
        handles = list(handles)
        ready = [h for h in handles if self.poll(h)]
        if ready or not handles or timeout == 0:
            return ready
        if timeout is None:
            try:
                self.collect(handles[0])
            except Exception:                # noqa: BLE001 — errored == resolved
                pass
            return [h for h in handles if self.poll(h)]
        deadline = time.monotonic() + timeout
        while True:
            ready = [h for h in handles if self.poll(h)]
            remaining = deadline - time.monotonic()
            if ready or remaining <= 0:
                return ready
            time.sleep(min(0.005, remaining))

    def add_done_callback(self, handle: Any, cb: Callable[[Any], None]
                          ) -> None:
        """Register ``cb(handle)`` to fire **exactly once** when ``handle``
        resolves (value, error, or cancellation alike).

        This is the push primitive the continuation layer (``Future.then``
        and friends, the cross-backend ``Waiter``) is built on. Contract:

        * if the handle is already resolved, ``cb`` fires synchronously in
          the calling thread before this method returns;
        * otherwise it fires from whatever thread completes the handle (the
          worker thread for ``threads``/``processes``, the select loop for
          ``cluster``) — callbacks must therefore be cheap and non-blocking;
          heavy continuations bounce to their own thread (the Future layer
          does this for user code);
        * multiple callbacks on one handle each fire exactly once.

        The default suits third-party backends that predate the callback
        kernel: it fires inline when ``poll()`` is already true and otherwise
        parks a watcher thread in ``collect()``.
        """
        if self.poll(handle):
            cb(handle)
            return

        def _watch():
            try:
                self.collect(handle)
            except Exception:                # noqa: BLE001 — errored == resolved
                pass
            cb(handle)

        threading.Thread(target=_watch, name="future-done-watch",
                         daemon=True).start()

    def drain_immediate(self, handle: Any) -> list[ImmediateCondition]:
        """Immediate conditions produced since the last drain (may be [])."""
        return []

    def cancel(self, handle: Any) -> bool:
        """Best-effort cancel; returns True if the task will not complete."""
        return False

    def shutdown(self) -> None:
        """Release workers. Idempotent."""

    @property
    def workers(self) -> int:
        return 1


class CompletionHandle:
    """Base for backend handles resolved by a push event: a ``done``
    :class:`threading.Event` plus the completion-callback slot that
    :class:`EventWaitMixin` drains exactly once at completion."""

    def __init__(self):
        self.done = threading.Event()
        self._cbs: list[Callable[[Any], None]] = []
        self._cb_lock = threading.Lock()


class EventWaitMixin:
    """Completion kernel for backends whose handles are
    :class:`CompletionHandle` s finished by some notifier thread.

    The backend calls :meth:`_init_wait` in ``__init__`` and
    :meth:`_complete` from the completing thread *after* storing the
    handle's result/error. ``_complete`` sets ``handle.done``, fires the
    handle's registered done-callbacks (push delivery, exactly once), and
    wakes every ``wait()``er through one shared condition variable — no
    sleep loops anywhere.
    """

    def _init_wait(self) -> None:
        self._done_cv = threading.Condition()

    def _notify_done(self) -> None:
        with self._done_cv:
            self._done_cv.notify_all()

    def _complete(self, handle: CompletionHandle) -> None:
        """Mark ``handle`` resolved: fire its callbacks (from this thread)
        and wake waiters. Idempotent — late/racing completions are no-ops."""
        with handle._cb_lock:
            if handle.done.is_set():
                cbs: list = []
            else:
                handle.done.set()
                cbs, handle._cbs = handle._cbs, []
        for cb in cbs:
            try:
                cb(handle)
            except Exception:                # noqa: BLE001
                import traceback
                traceback.print_exc()
        self._notify_done()

    def add_done_callback(self, handle: CompletionHandle,
                          cb: Callable[[Any], None]) -> None:
        with handle._cb_lock:
            if not handle.done.is_set():
                handle._cbs.append(cb)
                return
        cb(handle)                           # already resolved: fire inline

    def wait(self, handles: Sequence[Any], timeout: "float | None" = None
             ) -> list[Any]:
        handles = list(handles)
        if not handles:
            return []
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._done_cv:
            while True:
                ready = [h for h in handles if h.done.is_set()]
                if ready:
                    return ready
                if deadline is None:
                    self._done_cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return []
                    self._done_cv.wait(remaining)


class SlotCounterMixin:
    """Exact free-slot accounting for pool backends (threads/processes):
    one cv-guarded counter shared by the blocking ``submit`` path
    (``_acquire_slot()``), the admission path (``_acquire_slot(blocking=
    False)`` / :meth:`free_slots`), and elastic ``resize``.

    The backend calls :meth:`_init_slots` in ``__init__`` and releases
    from whatever thread completes the task.
    """

    def _init_slots(self, n: int) -> None:
        self._free = n
        self._slot_cv = threading.Condition()

    def _acquire_slot(self, blocking: bool = True) -> bool:
        with self._slot_cv:
            while self._free <= 0:
                if not blocking:
                    return False
                self._slot_cv.wait()
            self._free -= 1
            return True

    def _release_slot(self) -> None:
        with self._slot_cv:
            self._free += 1
            self._slot_cv.notify()

    def free_slots(self) -> int:
        with self._slot_cv:
            return max(self._free, 0)


BACKEND_REGISTRY: dict[str, type] = {}


def register_backend(name: str):
    def deco(cls):
        cls.name = name
        BACKEND_REGISTRY[name] = cls
        return cls
    return deco
