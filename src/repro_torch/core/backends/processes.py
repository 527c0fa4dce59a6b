"""plan(processes): resolve futures on local worker processes.

The analogue of the paper's ``multisession`` backend: a pool of background
interpreter processes, functions + snapshotted globals shipped over pipes
(serialization — the paper's §Known limitations apply: non-picklable globals
raise NonExportableObjectError *at creation*, not at some far-away crash on
the worker). Large globals are content-addressed: they cross the pipe in a
``("put", digest, blob)`` message at most once per worker and are referenced
by digest afterwards (see ``blobstore.py``; ``("need", digest)`` backfills
evictions). Tensors cross as their bytes — a CUDA tensor through a host
copy, rebuilt on the worker's card (see ``worker.py``) — so a worker
computes on the card with its own CUDA context.

This backend is the substrate for fault tolerance:

* a worker that dies mid-task (simulated node failure) is detected via
  pipe EOF and surfaces as :class:`WorkerDiedError` (a FutureError), while
  the pool **restarts the worker** so subsequent futures find a healthy pool;
* ``cancel()`` terminates the worker running the task (used by
  ``future_either`` speculative execution) and restarts it;
* ``resize()`` grows/shrinks the pool — elastic scaling.

A worker starts by importing ``repro_torch`` (and torch with it: seconds,
not milliseconds), and a worker that touches the card pays its CUDA
initialisation on first use; ``plan()`` parks a live pool in the warm pool
(``planning.py``) so re-planning back to it pays neither again.
"""

from __future__ import annotations

import itertools
import pickle
import threading

import multiprocessing as mp

from ..conditions import CapturedRun, ImmediateCondition
from ..errors import WorkerDiedError
from .. import planning as plan_mod
from .base import (Backend, CompletionHandle, EventWaitMixin,
                   SlotCounterMixin, TaskSpec, register_backend)
from .blobstore import DRIVER_STORE, encode_backfill
from .worker import Channel


class _Worker:
    def __init__(self, ctx, nested_blob: bytes, session_seed: int, wid: int,
                 blob_store_bytes: "int | None" = None):
        self.wid = wid
        parent_conn, child_conn = ctx.Pipe()
        self.parent_conn = Channel(parent_conn)
        from .worker import worker_main
        self.proc = ctx.Process(
            target=worker_main,
            args=(child_conn, nested_blob, session_seed, blob_store_bytes),
            daemon=True, name=f"repro-torch-worker-{wid}")
        self.proc.start()
        child_conn.close()
        self._ready = False
        #: payload digests this worker is believed to hold (cold for a
        #: freshly restarted worker; its LRU may still evict -> "need")
        self.known: set[bytes] = set()
        #: serializes parent->worker pipe sends: _drive's dispatch/backfill
        #: traffic vs state-wait reply threads (state.py)
        self.send_lock = threading.Lock()
        self.busy_task: "_Handle | None" = None

    def wait_ready(self) -> None:
        if not self._ready:
            msg = self.parent_conn.recv()           # handshake
            assert msg == ("ready",)
            self._ready = True

    def alive(self) -> bool:
        return self.proc.is_alive()

    def terminate(self) -> None:
        try:
            self.proc.terminate()
            self.proc.join(timeout=5)
        except Exception:                            # noqa: BLE001
            pass
        try:
            self.parent_conn.close()
        except OSError:
            pass


class _Handle(CompletionHandle):
    def __init__(self, task: TaskSpec):
        super().__init__()
        self.task = task
        self.run: CapturedRun | None = None
        self.error: Exception | None = None          # infrastructure error
        self.immediate: list[ImmediateCondition] = []
        self.ilock = threading.Lock()
        self.worker: _Worker | None = None
        self.cancelled = False


@register_backend("processes")
class ProcessBackend(SlotCounterMixin, EventWaitMixin, Backend):
    """Pool of persistent worker processes with fault detection/restart."""

    supports_immediate = True
    # spawn, not fork: the parent holds a CUDA context once it touched the
    # card, and a forked child of it cannot use CUDA (and may deadlock on
    # mutexes of the parent's threads it inherits).
    _START_METHOD = "spawn"

    def __init__(self, workers: int | None = None,
                 blob_store_bytes: "int | None" = None):
        self._blob_store_bytes = blob_store_bytes
        self._n = int(workers) if workers else plan_mod.available_cores()
        self._ctx = mp.get_context(self._START_METHOD)
        self._nested_blob = pickle.dumps(plan_mod.nested_stack())
        from .. import rng as rng_mod
        self._session_seed = rng_mod._session_seed
        self._wid = itertools.count()
        self._lock = threading.Lock()
        self._init_wait()
        # start all workers first, then handshake (parallel startup)
        self._idle: list[_Worker] = [self._spawn(defer=True)
                                     for _ in range(self._n)]
        for w in self._idle:
            w.wait_ready()
        # exact free-slot counter (not a bare Semaphore) so the admission
        # protocol can report real capacity
        self._init_slots(self._n)
        self._open = True

    # -- pool management ----------------------------------------------------

    def _spawn(self, defer: bool = False) -> _Worker:
        w = _Worker(self._ctx, self._nested_blob, self._session_seed,
                    next(self._wid), self._blob_store_bytes)
        if not defer:
            w.wait_ready()
        return w

    def _checkout(self) -> _Worker:
        with self._lock:
            while self._idle:
                w = self._idle.pop()
                if w.alive():
                    return w
                w.terminate()
            return self._spawn()

    def _checkin(self, w: _Worker, healthy: bool) -> None:
        with self._lock:
            if not self._open:
                w.terminate()
                return
            if healthy and w.alive():
                self._idle.append(w)
            else:
                w.terminate()
                self._idle.append(self._spawn())     # restart: pool self-heals

    def resize(self, workers: int) -> None:
        """Elastic scaling: grow/shrink the worker pool in place."""
        with self._lock:
            delta = workers - self._n
            self._n = workers
        if delta > 0:
            for _ in range(delta):
                with self._lock:
                    self._idle.append(self._spawn())
                self._release_slot()
        else:
            for _ in range(-delta):
                self._acquire_slot()
                with self._lock:
                    if self._idle:
                        self._idle.pop().terminate()

    def worker_pids(self) -> list[int]:
        """The pids of the idle workers (all of them when none is busy)."""
        with self._lock:
            return [w.proc.pid for w in self._idle]

    # -- Backend API ---------------------------------------------------------

    def submit(self, task: TaskSpec) -> _Handle:
        self._acquire_slot()             # paper semantics: block for a worker
        return self._start(task)

    def try_submit(self, task: TaskSpec) -> "_Handle | None":
        if not self._acquire_slot(blocking=False):
            return None
        return self._start(task)

    def _start(self, task: TaskSpec) -> _Handle:
        handle = _Handle(task)
        th = threading.Thread(target=self._drive, args=(handle,),
                              name=f"future-io-{task.task_id}", daemon=True)
        th.start()
        return handle

    def _drive(self, handle: _Handle) -> None:
        """Parent-side I/O thread: feed one task to one worker, pump
        progress messages, detect death."""
        task = handle.task
        try:
            if handle.cancelled:
                from ..errors import FutureCancelledError
                handle.error = FutureCancelledError(
                    "future cancelled before dispatch", future_label=task.label)
                return
            worker = self._checkout()
            handle.worker = worker
            worker.busy_task = handle
            healthy = False
            try:
                # the task's sources stay in the driver store while it is
                # in flight, so a need backfill is served from there and
                # never encodes a payload twice
                with DRIVER_STORE.pinned(task.payload_sources):
                    healthy = self._exchange(worker, handle)
            finally:
                worker.busy_task = None
                self._checkin(worker, healthy and not handle.cancelled)
        except Exception as exc:                     # noqa: BLE001
            # no worker could be had (a spawn that failed its handshake),
            # or a whole message came that does not load here (a result
            # tensor the parent's card cannot hold, a class the parent
            # cannot import): the future fails with that error, and a
            # worker whose next move is unknown is replaced
            handle.error = exc
        finally:
            self._release_slot()
            # push completion: fires done-callbacks from this I/O thread
            self._complete(handle)

    def _exchange(self, worker: _Worker, handle: _Handle) -> bool:
        """Send one task and what the worker lacks of its payloads, then
        serve the worker's messages until its result. Sets ``handle.run``
        or ``handle.error``, or raises; returns whether the worker stays
        in the pool."""
        task = handle.task
        blob = task.shipped
        assert blob is not None, "process backend requires shipped fn"
        # content-addressed payloads: ship what this worker lacks. Encode
        # before sending so an encode failure fails the future with the
        # real error (worker stays healthy) rather than completing the
        # handle with neither run nor error.
        try:
            puts = [(digest, src.encode())
                    for digest, src in task.payload_sources.items()
                    if digest not in worker.known]
        except Exception as exc:                     # noqa: BLE001
            handle.error = exc
            return True
        try:
            with worker.send_lock:
                for digest, pblob in puts:
                    worker.parent_conn.send(("put", digest, pblob))
                    worker.known.add(digest)
                worker.parent_conn.send(
                    ("task", task.task_id, blob, task.refs))
        except OSError:
            # worker died while idle (e.g. OOM-killed): the pipe send
            # raises EPIPE — surface WorkerDiedError and mark the worker
            # unhealthy so _checkin self-heals, exactly like a death
            # detected on the recv side below
            handle.error = WorkerDiedError(
                f"worker {worker.wid} died at dispatch of future "
                f"{task.label or task.task_id!r}",
                future_label=task.label, worker=worker.wid)
            return False
        while True:
            try:
                msg = worker.parent_conn.recv()
            except (EOFError, OSError):
                handle.error = WorkerDiedError(
                    f"worker {worker.wid} died while resolving future "
                    f"{task.label or task.task_id!r}",
                    future_label=task.label, worker=worker.wid)
                return False
            if msg[0] == "progress":
                with handle.ilock:
                    handle.immediate.append(msg[2])
            elif msg[0] == "need":
                # blob-store backfill (LRU eviction on the worker)
                pblob = encode_backfill(task.payload_sources.get(msg[1]))
                with worker.send_lock:
                    if pblob is not None:
                        worker.parent_conn.send(("put", msg[1], pblob))
                        worker.known.add(msg[1])
                    else:
                        worker.parent_conn.send(("nak", msg[1]))
            elif msg[0] == "state":
                # shared-state op from the task body: serve it against the
                # in-process singleton (state.py)
                self._serve_state(worker, msg)
            elif msg[0] == "result":
                handle.run = msg[2]
                return True

    def _serve_state(self, worker: _Worker, msg) -> None:
        """Serve one ``("state", rid, op, args)`` pipe message from a task
        body against the driver-process singleton service. ``wait`` blocks
        by design, so it runs on a side thread — ``_drive`` keeps pumping
        the pipe (death detection) while the worker's main thread is
        parked inside ``state.wait()``."""
        from .. import state as state_mod
        _tag, rid, op, args = msg
        svc = state_mod.service()

        def _send(status, payload):
            try:
                with worker.send_lock:
                    worker.parent_conn.send(
                        ("state_rep", rid, status, payload))
            except (OSError, ValueError):
                pass             # worker death surfaces on the recv side

        if op == "wait":
            key, min_version, timeout = args

            def _run():
                try:
                    value, version = svc.wait(key, int(min_version), timeout)
                except state_mod.StateTimeout:
                    _send("timeout", None)
                    return
                except Exception as exc:             # noqa: BLE001
                    _send("err", state_mod._safe_exc(exc))
                    return
                try:
                    payload, digest = svc.reply_payload(
                        key, value, version, worker.known)
                except Exception as exc:             # noqa: BLE001
                    _send("err", state_mod._safe_exc(exc))
                    return
                if digest is not None:
                    worker.known.add(digest)
                _send("ok", (version, payload))

            threading.Thread(target=_run, name="state-wait",
                             daemon=True).start()
            return
        status, payload, digest = svc.handle(op, args, worker.known)
        if digest is not None:
            worker.known.add(digest)
        _send(status, payload)

    def poll(self, handle: _Handle) -> bool:
        return handle.done.is_set()

    def collect(self, handle: _Handle) -> CapturedRun:
        handle.done.wait()
        if handle.error is not None:
            raise handle.error
        assert handle.run is not None
        return handle.run

    def drain_immediate(self, handle: _Handle) -> list[ImmediateCondition]:
        with handle.ilock:
            out = handle.immediate[:]
            handle.immediate.clear()
        return out

    def cancel(self, handle: _Handle) -> bool:
        handle.cancelled = True
        if handle.done.is_set():
            return False
        w = handle.worker
        if w is not None:
            w.terminate()                # hard-cancel: kill the worker; the
        return True                      # drive thread sees EOF and returns

    def shutdown(self) -> None:
        with self._lock:
            self._open = False
            workers, self._idle = self._idle, []
        for w in workers:
            try:
                w.parent_conn.send(("stop",))
            except (OSError, ValueError):
                pass
            w.terminate()

    @property
    def workers(self) -> int:
        return self._n
