"""The Future API: future(), value(), resolved() (paper §Three constructs).

    f <- future(expr)   ->   f = future(lambda: slow_fcn(x))
    v <- value(f)       ->   v = value(f)
    r <- resolved(f)    ->   r = resolved(f)

Semantics reproduced from the paper:

* **snapshot at creation** — globals/closure values are frozen when the
  future is created, so reassigning ``x`` afterwards does not change the
  future's value;
* **blocking** — creating a future blocks iff no worker is free (backend
  dependent); ``value()`` blocks until resolved; ``resolved()`` never blocks;
* **relaying** — stdout first, then conditions in order, at the first
  ``value()``; errors re-raised as-is at *every* ``value()``;
* **lazy futures** — ``lazy=True`` defers dispatch until ``resolved()`` or
  ``value()`` first touches the future; lazy futures can be ``merge()``d
  into a single chunked future (the paper's §Future-work load balancing);
* **seed** — ``seed=True`` gives the body a deterministic per-future RNG
  stream key, invariant to the backend and worker count.

Completion is **push-based**: every backend implements
``Backend.add_done_callback(handle, cb)`` and fires it exactly once from
the completing thread (a worker thread, or the caller's own thread on the
sequential plan). Two layers build on that one kernel:

* **event-driven collection** — :func:`resolve`, :func:`as_completed` and
  :func:`wait_any` multiplex any number of futures *across any mix of
  backends* through one :class:`Waiter` (one callback registration per
  future, one condition variable) — a single event wait, no polling slices;
* **cooperative (asyncio) collection** — ``await f`` suspends the calling
  coroutine instead of blocking its thread (:meth:`Future.__await__`,
  bridged off the same callback kernel via ``call_soon_threadsafe``);
  :class:`AsyncWaiter` / :func:`as_completed_async` are the loop-native
  analogues of :class:`Waiter` / :func:`as_completed` — any mix of
  backends, one event wait, zero parked threads per awaited future;
* **continuation combinators** — ``Future.then(fn)`` (chain, monadic:
  a returned ``Future`` is flattened), ``Future.map(fn)`` (plain
  transform), ``Future.recover(fn)`` / ``Future.fallback(other)`` (error
  paths), and module-level :func:`gather` / :func:`first` /
  :func:`first_successful`. Combinators return real :class:`Future` s:
  ``value()`` relays the whole chain's captured stdout/conditions in order
  and re-raises errors as-is, identically on every backend — the paper's
  three-construct surface and conformance contract are unchanged.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import itertools
import threading
import time
import traceback
import weakref
from typing import Any, AsyncIterator, Callable, Iterable, Iterator, Sequence

from . import planning as plan_mod
from .backends.base import (Backend, CompletionHandle, EventWaitMixin,
                            TaskSpec)
from .conditions import CapturedRun, capture_run, relay
from .errors import (FutureCancelledError, FutureError, GlobalsError,
                     WorkerDiedError)
from .globals_capture import identify_globals
from . import rng as rng_mod

_ids = itertools.count(1)

_CREATED, _SUBMITTED, _COLLECTED = "created", "submitted", "collected"


def _freeze(fn: Callable, explicit: dict | None) -> tuple[Callable, dict, set]:
    """Rebuild ``fn`` against a creation-time snapshot of its globals and
    closure — the paper's automatic-globals semantics."""
    import types
    snapshot, packages = identify_globals(fn, explicit=explicit)
    code = getattr(fn, "__code__", None)
    if code is None:
        return fn, snapshot, packages
    g = dict(getattr(fn, "__globals__", {}))       # freeze *bindings* now
    g.update({k: v for k, v in snapshot.items() if k not in code.co_freevars})
    cells = []
    if code.co_freevars:
        for name in code.co_freevars:
            cells.append(types.CellType(snapshot.get(name)))
    frozen = types.FunctionType(code, g, fn.__name__, fn.__defaults__,
                                tuple(cells) or None)
    if fn.__kwdefaults__:
        frozen.__kwdefaults__ = dict(fn.__kwdefaults__)
    return frozen, snapshot, packages


def _accepts_kwarg(fn: Callable, name: str) -> bool:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    params = sig.parameters
    if name in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values())


# --------------------------------------------------------------------------
# The continuation kernel: completion cells for derived futures
# --------------------------------------------------------------------------

class _ChainHandle(CompletionHandle):
    """Completion cell for a derived (combinator) future: filled in by a
    continuation instead of a backend worker."""

    def __init__(self, label: str = ""):
        super().__init__()
        self.label = label
        self.run: CapturedRun | None = None
        self.error: Exception | None = None          # infrastructure error


class _ChainKernel(EventWaitMixin, Backend):
    """The pseudo-backend that resolves derived futures.

    It is deliberately *not* in ``BACKEND_REGISTRY`` — nothing is ever
    submitted to it. It only provides the resolution-side half of the
    Backend contract (poll / collect / wait / add_done_callback) over
    :class:`_ChainHandle` cells, so a combinator result is
    indistinguishable from a backend future to ``value()``, ``wait_any()``
    and further combinators.
    """

    name = "continuation"
    supports_immediate = False

    def __init__(self):
        self._init_wait()

    def submit(self, task: TaskSpec):   # pragma: no cover — never dispatched
        raise NotImplementedError(
            "derived futures are completed by continuations, not submitted")

    def poll(self, handle: _ChainHandle) -> bool:
        return handle.done.is_set()

    def collect(self, handle: _ChainHandle) -> CapturedRun:
        handle.done.wait()
        if handle.error is not None:
            raise handle.error
        assert handle.run is not None
        return handle.run

    def complete(self, handle: _ChainHandle, run: CapturedRun | None = None,
                 error: Exception | None = None) -> bool:
        """Resolve ``handle`` exactly once (racing completions lose
        silently), firing its done-callbacks from this thread."""
        with handle._cb_lock:
            if handle.done.is_set():
                return False
            handle.run, handle.error = run, error
            handle.done.set()
            cbs, handle._cbs = handle._cbs, []
        for cb in cbs:
            try:
                cb(handle)
            except Exception:                        # noqa: BLE001
                traceback.print_exc()
        self._notify_done()
        return True

    def cancel(self, handle: _ChainHandle) -> bool:
        return self.complete(handle, error=FutureCancelledError(
            f"derived future {handle.label!r} cancelled",
            future_label=handle.label))


_CHAIN = _ChainKernel()


class _ContinuationPool:
    """Cached continuation executor: the bounced-dispatch path for
    continuations whose parent backend cannot run them inline (threads and
    derived futures).

    Replaces the old thread-per-continuation spawn: a worker that finishes
    a job parks on the queue and serves the next one, and only spawns when
    every live worker is busy (so concurrency is bounded by the number of
    *simultaneously running* continuations, with thread reuse in between).
    Idle workers exit after a short grace, so a quiet process holds no
    continuation threads at all. Liveness is unconditional: a submit that
    finds no idle worker always spawns, so a continuation can never
    deadlock behind user code blocking inside another continuation.
    """

    _IDLE_GRACE_S = 1.0

    def __init__(self):
        import queue
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._idle = 0
        self._pending = 0

    def submit(self, job: Callable[[], None]) -> None:
        with self._lock:
            self._pending += 1
            spawn = self._pending > self._idle
        self._q.put(job)
        if spawn:
            threading.Thread(target=self._drain, name="continuation-pool",
                             daemon=True).start()

    def _drain(self) -> None:
        import queue
        while True:
            with self._lock:
                self._idle += 1
            try:
                job = self._q.get(timeout=self._IDLE_GRACE_S)
            except queue.Empty:
                with self._lock:
                    self._idle -= 1
                    if self._pending == 0:
                        return           # truly quiet: retire
                # a submit() decided not to spawn because it saw us idle
                # in the instant our grace timeout was expiring — the job
                # is enqueued with no other worker committed to it, so
                # loop and claim it rather than stranding it (the lock
                # orders the two: either we see its pending increment
                # here, or it sees our idle decrement and spawns)
                continue
            with self._lock:
                self._idle -= 1
                self._pending -= 1
            try:
                job()
            except BaseException:                    # noqa: BLE001
                traceback.print_exc()


_CONT_POOL = _ContinuationPool()


def _spawn_continuation(out: "Future", job: Callable[[], None], *,
                        backend: "Backend | None" = None) -> None:
    """Dispatch one continuation step.

    Backend done-callbacks fire from completing threads and must stay
    non-blocking, so user continuations
    (arbitrary code — possibly slow, possibly creating futures) cannot run
    there. Dispatch is admission-controlled instead of thread-per-step:

    * when the parent's ``backend`` declares ``dispatches_continuations``
      (sequential: submission is synchronous and slot-free) *and* the
      firing thread is not inside a worker's nested-plan context (TLS
      override unset — i.e. this thread holds no bounded worker slot),
      the step is offered through ``Backend.try_submit`` and runs inline —
      the fully synchronous plan keeps fully synchronous chains;
    * everything else bounces to the shared :class:`_ContinuationPool`.
      Deliberately: a continuation running on a thread that *holds a
      bounded worker slot* deadlocks as soon as user code inside it
      creates/waits an eager future with no slots left — that rules out
      dispatching through the slot-bounded threads backend *and* inlining
      on its worker threads.

    An escaped exception resolves ``out`` instead of vanishing.
    """
    def _run():
        try:
            job()
        except BaseException as exc:                 # noqa: BLE001
            _CHAIN.complete(out._handle, error=exc)

    if backend is not None and backend.dispatches_continuations \
            and plan_mod.thread_stack_override() is None:
        # capture off, seed "declared": the step does its own capture_run
        # around user code, and must not trip RNG-misuse detection on the
        # user's behalf (declaration happened on the futures involved).
        # The global-stack scope undoes the worker's use_nested_stack so
        # futures created by the continuation land on the end-user's plan,
        # exactly as they did on parent-side threads (the pool path below
        # runs on fresh threads whose TLS override is already unset).
        def _run_on_backend():
            with plan_mod.use_global_stack():
                _run()

        task = TaskSpec(task_id=out.id, fn=_run_on_backend,
                        label=f"cont:{out.label}",
                        capture_stdout=False, capture_conditions=False,
                        seed_declared=True)
        try:
            if backend.try_submit(task) is not None:
                return
        except Exception:                            # noqa: BLE001
            pass                                     # shut-down race: bounce
    _CONT_POOL.submit(_run)


def _outcome(f: "Future") -> "tuple[CapturedRun | None, Exception | None]":
    """``(run, infra_error)`` of a *resolved* future — never blocks long."""
    try:
        return f._backend.collect(f._handle), None
    except Exception as exc:                         # noqa: BLE001 — FutureError
        return None, exc


def _merge_runs(head: CapturedRun, tail: CapturedRun) -> CapturedRun:
    """Value/error from ``tail``; captures concatenated, so one ``value()``
    on a chained future relays the whole chain's output in order."""
    return CapturedRun(
        value=tail.value, error=tail.error, error_tb=tail.error_tb,
        stdout=head.stdout + tail.stdout,
        conditions=head.conditions + tail.conditions,
        immediate=head.immediate + tail.immediate,
        wall_time_s=head.wall_time_s + tail.wall_time_s,
        rng_touched=head.rng_touched or tail.rng_touched)


class Future:
    """One future. Create via :func:`future`, interrogate via
    :func:`resolved`, harvest via :func:`value`, compose via
    :meth:`then` / :meth:`map` / :meth:`recover` / :meth:`fallback`."""

    def __init__(self, fn: Callable, args: tuple, kwargs: dict, *,
                 seed: bool | int | None = None,
                 lazy: bool = False,
                 globals: dict | None = None,      # noqa: A002 — paper name
                 label: str | None = None,
                 stdout: bool = True,
                 conditions: bool = True,
                 backend: Backend | None = None):
        self.id = next(_ids)
        self.label = label or f"future-{self.id}"
        self._lock = threading.Lock()
        self._state = _CREATED
        self._handle: Any = None
        self._run: CapturedRun | None = None
        self._relayed = False
        self._stdout = stdout
        self._conditions = conditions
        self._backend = backend

        self.seed_declared = seed is not None and seed is not False
        if seed is False:
            # internal futures must not consume a stream index: user futures
            # created afterwards get identical keys either way
            self._stream_index = None
        elif seed is True or seed is None:
            self._stream_index = rng_mod.next_stream_index()
        else:
            self._stream_index = int(seed)

        frozen, snapshot, packages = _freeze(fn, globals)
        self._snapshot, self._packages = snapshot, packages
        if self.seed_declared and _accepts_kwarg(fn, "key"):
            key = rng_mod.stream_key(self._stream_index)
            kwargs = dict(kwargs, key=key)
        self._fn, self._args, self._kwargs = frozen, args, kwargs

        if not lazy:
            self._submit()

    @classmethod
    def _derived(cls, label: str) -> "Future":
        """A future resolved by a continuation (no backend dispatch)."""
        f = cls.__new__(cls)
        f.id = next(_ids)
        f.label = label
        f._lock = threading.Lock()
        f._state = _SUBMITTED
        f._handle = _ChainHandle(label)
        f._run = None
        f._relayed = False
        f._stdout = True
        f._conditions = True
        f._backend = _CHAIN
        f.seed_declared = False
        f._stream_index = None                   # no RNG stream consumed
        f._snapshot, f._packages = {}, set()
        f._fn, f._args, f._kwargs = None, (), {}
        return f

    # -- dispatch -------------------------------------------------------------

    def _task(self, backend: Backend) -> TaskSpec:
        shipped = None
        sources: dict = {}
        args, kwargs = self._args, self._kwargs
        if backend.name in ("processes", "cluster"):
            # Content-addressed shipping: large globals leave the task blob
            # as PayloadRef digests (shipped at most once per worker); the
            # extraction doubles as the exportability scan, raising
            # NonExportableObjectError at creation.
            from .globals_capture import (dumps_robust, extract_call_refs,
                                          extract_payload_refs,
                                          ship_function)
            refd, sources = extract_payload_refs(
                self._snapshot, backend=backend.name)
            if backend.name == "cluster":
                # large call args ride the same content-addressed channel
                # as globals; RemoteValue args stay worker-resident digests
                # (the dataflow path — cluster-only, as in the reference)
                args, kwargs, asrc = extract_call_refs(
                    args, kwargs, backend=backend.name)
                sources.update(asrc)
            shipped = dumps_robust({
                "fn": ship_function(self._fn, refd, self._packages,
                                    ref_sink=sources),
                "args": args, "kwargs": kwargs,
                "capture_stdout": self._stdout,
                "capture_conditions": self._conditions,
                "seed_declared": self.seed_declared,
            }, ref_sink=sources)
        return TaskSpec(
            task_id=self.id, fn=self._fn, args=args,
            kwargs=kwargs, label=self.label,
            capture_stdout=self._stdout, capture_conditions=self._conditions,
            seed_declared=self.seed_declared, shipped=shipped,
            payload_sources=sources,
            affinity=tuple(d for d, s in sources.items()
                           if getattr(s, "remote", False)))

    def _submit(self) -> None:
        with self._lock:
            if self._state != _CREATED:
                return
            backend = self._backend or plan_mod.active_backend()
            self._backend = backend
            self._handle = backend.submit(self._task(backend))
            self._state = _SUBMITTED

    def _submit_nowait(self) -> bool:
        """Admission-controlled dispatch: offer this (lazy/created) future
        through ``Backend.try_submit``. Returns ``True`` when the future is
        submitted (now or previously), ``False`` when the backend had no
        free capacity — the future stays created and can be re-offered.

        This is the streaming pump's primitive: dispatch exactly when
        capacity exists, never park inside ``submit``.
        """
        with self._lock:
            if self._state != _CREATED:
                return True
            backend = self._backend or plan_mod.active_backend()
            if backend.free_slots() <= 0:
                return False             # cheap pre-check: skip task build
            handle = backend.try_submit(self._task(backend))
            if handle is None:
                return False             # lost the slot race — re-offer later
            self._backend = backend
            self._handle = handle
            self._state = _SUBMITTED
            return True

    def _register(self, cb: Callable[[Any], None]) -> None:
        """Register ``cb(handle)`` on this future's completion (launching a
        lazy future first). Fires synchronously if already resolved."""
        if self._state == _CREATED:
            self._submit()
        self._backend.add_done_callback(self._handle, cb)

    # -- the three constructs ---------------------------------------------------

    def resolved(self) -> bool:
        """Non-blocking: lazy futures are launched on first touch (paper)."""
        if self._state == _CREATED:
            self._submit()
            # fallthrough: freshly submitted may already be done (sequential)
        if self._state == _COLLECTED:
            return True
        self._relay_immediate()
        return self._backend.poll(self._handle)

    def value(self, timeout: "float | None" = None) -> Any:
        """Block until resolved; relay stdout/conditions (once) and the
        error (every call); return the value. With ``timeout=``, wait at
        most that many seconds: an unresolved future raises
        ``TimeoutError`` and stays valid — a later ``value()`` call can
        still collect it."""
        if self._state == _CREATED:
            self._submit()
        if self._state != _COLLECTED:
            if timeout is not None and \
                    not self._backend.wait([self._handle], timeout=timeout):
                raise TimeoutError(
                    f"future {self.label!r} unresolved after {timeout}s")
            run = self._backend.collect(self._handle)   # may raise FutureError
            # worker-resident result: value() is the explicit pull — fetch
            # the blob from its holder and hand back a writable copy (may
            # raise LineageExhaustedError/ChannelError like any infra
            # failure)
            run = _materialize_run(run)
            with self._lock:
                self._run, self._state = run, _COLLECTED
        assert self._run is not None
        if not self._relayed:
            self._relayed = True
            return relay(self._run)          # prints, warns, raises, returns
        if self._run.error is not None:
            raise self._run.error
        return self._run.value

    def __await__(self):
        """``await f`` ≡ ``value(f)``, suspending the awaiting coroutine
        instead of blocking its thread: completion is bridged off
        ``add_done_callback`` into the awaiting loop via
        ``call_soon_threadsafe`` — no thread parks per await, on any
        backend. Relays once and re-raises the error at every await, like
        ``value()``."""
        if self._state == _CREATED:
            self._submit()
        if self._state != _COLLECTED and not self._backend.poll(self._handle):
            loop = asyncio.get_running_loop()
            done = loop.create_future()

            def _wake(_h):
                try:
                    loop.call_soon_threadsafe(_resolve_loop_future, done)
                except RuntimeError:
                    pass                 # awaiting loop already closed
            self._backend.add_done_callback(self._handle, _wake)
            yield from done.__await__()
        return self.value()

    # -- continuation combinators ------------------------------------------------

    def then(self, fn: Callable[[Any], Any], *,
             label: str | None = None) -> "Future":
        """Chain: a future of ``fn(value(self))``.

        ``fn`` runs as a continuation once ``self`` resolves; if it returns
        a :class:`Future`, that future is flattened (monadic bind), so
        ``f.then(g)`` composes asynchronous stages without blocking anyone.
        Errors propagate: if ``self`` failed, ``fn`` is skipped and the
        chained future re-raises the same exception at ``value()``; an
        exception inside ``fn`` resolves the chained future with it.
        ``value()`` of the chained future relays the captured output of the
        whole chain in order.
        """
        out = Future._derived(label or f"{self.label}.then")
        self._register(lambda _h: _spawn_continuation(
            out, lambda: _step_then(self, fn, out, flatten=True),
            backend=self._backend))
        return out

    def map(self, fn: Callable[[Any], Any], *,
            label: str | None = None) -> "Future":
        """Inline transform: a future of ``fn(value(self))``, with
        :meth:`then`'s error propagation but no flattening — ``fn``'s
        return value is the chained value as-is."""
        out = Future._derived(label or f"{self.label}.map")
        self._register(lambda _h: _spawn_continuation(
            out, lambda: _step_then(self, fn, out, flatten=False),
            backend=self._backend))
        return out

    def recover(self, fn: Callable[[BaseException], Any], *,
                label: str | None = None) -> "Future":
        """Error path: if ``self`` fails — an evaluation error *or* an
        infrastructure :class:`FutureError` (worker death, cancellation) —
        resolve to ``fn(exception)`` instead; successes pass through."""
        out = Future._derived(label or f"{self.label}.recover")
        self._register(lambda _h: _spawn_continuation(
            out, lambda: _step_recover(self, fn, out),
            backend=self._backend))
        return out

    def fallback(self, other: "Future | Callable[[], Any]", *,
                 label: str | None = None) -> "Future":
        """Error path: if ``self`` fails, adopt ``other``'s outcome (a
        :class:`Future`, or a thunk evaluated on demand); on success the
        value passes through and a Future ``other`` is cancelled
        (speculation cleanup)."""
        out = Future._derived(label or f"{self.label}.fallback")
        self._register(lambda _h: _spawn_continuation(
            out, lambda: _step_fallback(self, other, out),
            backend=self._backend))
        return out

    # -- extras ------------------------------------------------------------------

    def cancel(self) -> bool:
        if self._state == _SUBMITTED:
            return self._backend.cancel(self._handle)
        return False

    def _relay_immediate(self) -> None:
        if self._state == _SUBMITTED and self._backend is not None:
            import sys
            for cond in self._backend.drain_immediate(self._handle):
                print(f"[progress] {cond.payload}", file=sys.stderr)

    def __repr__(self):
        return f"<Future {self.label} state={self._state}>"


# --------------------------------------------------------------------------
# Continuation steps (run on continuation threads, never in backend loops)
# --------------------------------------------------------------------------

def _materialize_run(run: CapturedRun) -> CapturedRun:
    """Pull a worker-resident result down to the driver: a RemoteValue
    value is fetched (writable copy) in place. Raises what the fetch
    raises (LineageExhaustedError when the bytes died with their holder)."""
    if getattr(run.value, "is_remote_value", False):
        run = dataclasses.replace(run, value=run.value.fetch())
    return run


def _chain_apply(v, _fn=None, _flatten=False):
    """Worker-side body of a locality-routed continuation hop: run the
    user's fn against the (peer-resolved) parent value; flatten a returned
    Future by resolving it in place (nested futures on a worker run on the
    worker's popped plan)."""
    r = _fn(v)
    if _flatten and isinstance(r, Future):
        r = r.value()
    return r


def _remote_chain(prun: CapturedRun, fn: Callable, out: Future, *,
                  flatten: bool, _attempts: int = 2) -> bool:
    """Try to route a continuation on a worker-resident parent value back
    through the holding cluster: the hop ships ~500 B of control frame (fn
    + the parent digest) and ``TaskSpec.affinity`` steers it to a worker
    already holding the bytes. Returns False when routing is impossible
    (backend gone / shut down) — the caller falls back to pulling the
    value and running the continuation driver-side. A hop that dies with
    its worker is retried up to ``_attempts`` times (``_step_hop``)."""
    rv = prun.value
    backend = rv.backend()
    if backend is None or not getattr(backend, "remote_chains", False):
        return False
    try:
        g = Future(_chain_apply, (rv,), {"_fn": fn, "_flatten": flatten},
                   backend=backend, seed=False, lazy=True,
                   label=f"{out.label}@worker")
        # continuation convention (see _spawn_continuation): the hop must
        # not trip RNG-misuse detection on the user's behalf
        g.seed_declared = True
        g._register(lambda _h: _spawn_continuation(
            out, lambda: _step_hop(g, prun, fn, out, flatten=flatten,
                                   attempts_left=_attempts)))
    except Exception:                                # noqa: BLE001
        return False                   # shut-down race etc.: pull instead
    return True


def _step_hop(g: Future, prun: CapturedRun, fn: Callable, out: Future, *,
              flatten: bool, attempts_left: int) -> None:
    """Adopt the outcome of one locality-routed hop, with recovery. A hop
    killed with its worker is re-routed; any other — or exhausted —
    infrastructure failure falls back to pulling the parent value and
    running the continuation driver-side (a parent whose every copy is
    gone fails there with LineageExhaustedError)."""
    run, infra = _outcome(g)
    if infra is None:
        prefix = dataclasses.replace(prun, value=None)
        _CHAIN.complete(out._handle,
                        run=_merge_runs(prefix, dataclasses.replace(run)))
        return
    if not isinstance(infra, FutureError) \
            or isinstance(infra, FutureCancelledError):
        _CHAIN.complete(out._handle, error=infra)
        return
    if isinstance(infra, WorkerDiedError) and attempts_left > 0 \
            and _remote_chain(prun, fn, out, flatten=flatten,
                              _attempts=attempts_left - 1):
        return
    try:
        mrun = _materialize_run(prun)
    except Exception as exc:                         # noqa: BLE001
        _CHAIN.complete(out._handle, error=exc)
        return
    _finish_local_step(mrun, fn, out, flatten=flatten)


def _step_then(parent: Future, fn: Callable, out: Future, *,
               flatten: bool) -> None:
    prun, infra = _outcome(parent)
    if infra is not None:
        _CHAIN.complete(out._handle, error=infra)
        return
    if prun.error is not None:
        # error propagates past fn; carry the parent's capture so relay
        # behaviour matches value(parent)
        _CHAIN.complete(out._handle, run=dataclasses.replace(prun))
        return
    if getattr(prun.value, "is_remote_value", False):
        # locality-scheduled continuation: dispatch fn to the worker that
        # already holds the parent's result instead of pulling it here
        if _remote_chain(prun, fn, out, flatten=flatten):
            return
        try:
            prun = _materialize_run(prun)
        except Exception as exc:                     # noqa: BLE001
            _CHAIN.complete(out._handle, error=exc)
            return
    _finish_local_step(prun, fn, out, flatten=flatten)


def _finish_local_step(prun: CapturedRun, fn: Callable, out: Future, *,
                       flatten: bool) -> None:
    """Run ``fn`` against the (materialized) parent value on this thread
    and complete ``out`` — the driver-side tail shared by ``_step_then``
    and ``_step_hop``'s fallback path."""
    crun = capture_run(lambda: fn(prun.value))
    if flatten and crun.error is None and isinstance(crun.value, Future):
        inner = crun.value
        inner._register(lambda _h: _spawn_continuation(
            out, lambda: _step_flatten(prun, crun, inner, out)))
        return
    _CHAIN.complete(out._handle, run=_merge_runs(prun, crun))


def _step_flatten(prun: CapturedRun, crun: CapturedRun, inner: Future,
                  out: Future) -> None:
    irun, infra = _outcome(inner)
    if infra is not None:
        _CHAIN.complete(out._handle, error=infra)
        return
    _CHAIN.complete(out._handle,
                    run=_merge_runs(prun, _merge_runs(crun, irun)))


def _step_recover(parent: Future, fn: Callable, out: Future) -> None:
    prun, infra = _outcome(parent)
    if infra is not None:
        _CHAIN.complete(out._handle, run=capture_run(lambda: fn(infra)))
        return
    if prun.error is None:
        _CHAIN.complete(out._handle, run=dataclasses.replace(prun))
        return
    crun = capture_run(lambda: fn(prun.error))
    _CHAIN.complete(out._handle, run=_merge_runs(
        dataclasses.replace(prun, error=None, error_tb=None), crun))


def _step_fallback(parent: Future, other, out: Future) -> None:
    prun, infra = _outcome(parent)
    if infra is None and prun.error is None:
        if isinstance(other, Future):
            other.cancel()
        _CHAIN.complete(out._handle, run=dataclasses.replace(prun))
        return
    # failed: adopt the alternative, still relaying whatever the parent
    # captured before it failed (same contract as then()/recover())
    prefix = None if prun is None else \
        dataclasses.replace(prun, error=None, error_tb=None)
    if isinstance(other, Future):
        other._register(lambda _h: _spawn_continuation(
            out, lambda: _step_adopt(other, out, prefix=prefix)))
    else:
        crun = capture_run(other)
        _CHAIN.complete(out._handle, run=crun if prefix is None
                        else _merge_runs(prefix, crun))


def _step_adopt(f: Future, out: Future,
                prefix: CapturedRun | None = None) -> None:
    """Complete ``out`` with the (resolved) outcome of ``f``, relaying
    ``prefix``'s capture first if given."""
    run, infra = _outcome(f)
    if infra is not None:
        _CHAIN.complete(out._handle, error=infra)
        return
    run = dataclasses.replace(run)
    _CHAIN.complete(out._handle, run=run if prefix is None
                    else _merge_runs(prefix, run))


# --------------------------------------------------------------------------
# Public constructors
# --------------------------------------------------------------------------

def future(fn: Callable, *args, **opts_and_kwargs) -> Future:
    """Create a future evaluating ``fn(*args, **kwargs)``.

    Options (consumed, not passed to fn): ``seed``, ``lazy``, ``globals``,
    ``label``, ``stdout``, ``conditions``, ``backend``.
    """
    opts = {}
    for name in ("seed", "lazy", "globals", "label", "stdout", "conditions",
                 "backend"):
        if name in opts_and_kwargs:
            opts[name] = opts_and_kwargs.pop(name)
    return Future(fn, args, opts_and_kwargs, **opts)


def resolved(f: "Future | Iterable[Future]") -> "bool | list[bool]":
    if isinstance(f, Future):
        return f.resolved()
    return [fi.resolved() for fi in f]


def value(f: "Future | Sequence | dict",
          timeout: "float | None" = None) -> Any:
    """Generic value(): works on a future, list/tuple of futures, or dict —
    the paper's value() S3 generic for containers. ``timeout=`` bounds the
    *total* wait across a whole container (one shared deadline, not one
    per element), raising ``TimeoutError`` when it elapses with futures
    still unresolved."""
    deadline = None if timeout is None else time.monotonic() + timeout
    return _value_by(f, deadline)


def _value_by(f, deadline: "float | None") -> Any:
    if isinstance(f, Future):
        if deadline is None:
            return f.value()
        return f.value(timeout=max(deadline - time.monotonic(), 0.0))
    if isinstance(f, dict):
        return {k: _value_by(v, deadline) for k, v in f.items()}
    if isinstance(f, (list, tuple)):
        # merged futures return lists of sub-values; flatten one level so
        # value(fs) after chunking equals value(fs) without chunking.
        flat = []
        for fi in f:
            v = _value_by(fi, deadline)
            if isinstance(fi, Future) and getattr(fi, "_merged_n", 0):
                flat.extend(v)
            else:
                flat.append(v)
        return type(f)(flat)
    return f


def _flatten_futures(fs) -> list[Future]:
    if isinstance(fs, Future):
        return [fs]
    if isinstance(fs, dict):
        fs = fs.values()
    out = []
    for f in fs:
        if isinstance(f, Future):
            out.append(f)
    return out


# --------------------------------------------------------------------------
# Cross-backend event wait
# --------------------------------------------------------------------------

class Waiter:
    """Cross-backend completion multiplexer: one done-callback registration
    per future feeding one condition variable.

    This is the event-wait kernel under :func:`wait_any`, :func:`resolve`,
    :func:`as_completed`, ``future_map`` and the multi-pod launcher: any
    number of futures on *any mix of backends* (including derived
    combinator futures) is a single event wait — the completing backend
    pushes, the waiter wakes. No per-backend grouping, no 0.05s round-robin
    slices.

    :meth:`wait` returns the futures *newly* completed since the previous
    call (each registered future is delivered exactly once across the
    waiter's lifetime — re-``add()``-ing an already-delivered future is a
    no-op, enforced by a tombstone on its id); :meth:`add` registers more
    futures mid-collection (retries, speculative duplicates). Lazy futures
    are launched at registration.
    """

    def __init__(self, fs: Iterable[Future] = ()):
        self._cv = threading.Condition()
        self._fresh: list[Future] = []
        self._known: dict[int, Future] = {}      # strong refs keep ids unique
        # delivered ids -> weakref of the delivered future: a tombstone that
        # makes late re-registration a silent no-op instead of a double
        # delivery. Weak, so tombstones never pin collected futures; the
        # weakref also disambiguates id reuse (a dead referent means the id
        # now names a different, never-delivered future).
        self._delivered: dict[int, weakref.ref] = {}
        for f in fs:
            self.add(f)

    def __len__(self) -> int:
        return len(self._known)

    def add(self, f: Future) -> None:
        if id(f) in self._known:
            return
        tomb = self._delivered.get(id(f))
        if tomb is not None:
            if tomb() is f:
                return                   # already delivered: no re-delivery
            del self._delivered[id(f)]   # stale tombstone: id was reused
        self._known[id(f)] = f
        # The registered callback outlives short-lived waiters (handles keep
        # their callback list until completion), so it must not pin the
        # waiter — or, through it, every registered future — once the
        # waiter itself is dropped (e.g. a timed-out wait_any()).
        wref = weakref.ref(self)

        def _fire(_h, f=f):
            waiter = wref()
            if waiter is None:
                return
            with waiter._cv:
                waiter._fresh.append(f)
                waiter._cv.notify_all()

        f._register(_fire)

    def wait(self, timeout: "float | None" = None) -> list[Future]:
        """Block until at least one registered future newly completed;
        return those (empty only if ``timeout`` elapsed first).

        Delivered futures are dropped from the waiter's registry: the
        waiter no longer pins them (or their collected runs) for the rest
        of a long collection loop. Their ids stay behind as (weak)
        tombstones, so re-``add()``-ing an already-delivered future is a
        no-op rather than a re-delivery.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._fresh:
                if deadline is None:
                    self._cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return []
                    self._cv.wait(remaining)
            fresh, self._fresh = self._fresh, []
            for f in fresh:
                self._known.pop(id(f), None)
                self._delivered[id(f)] = weakref.ref(f)
            return fresh


def _resolve_loop_future(fut: "asyncio.Future") -> None:
    """Resolve an asyncio future from its own loop (the far end of a
    ``call_soon_threadsafe`` bridge); a no-op if the awaiter was cancelled
    or already woken."""
    if not fut.done():
        fut.set_result(None)


class AsyncWaiter:
    """Loop-native :class:`Waiter`: the same completion multiplexer, but
    delivery is marshalled into the constructing coroutine's event loop
    (``call_soon_threadsafe``) and :meth:`wait` is a coroutine parking on an
    ``asyncio.Event`` instead of a condition variable — ``async for`` over
    thousands of in-flight futures costs zero blocked threads.

    Semantics mirror :class:`Waiter` exactly: one callback registration per
    future on any mix of backends, each future delivered exactly once,
    delivered futures un-pinned (weak tombstones make late re-``add()`` a
    no-op), lazy futures launched at registration. Must be constructed
    inside a running event loop.
    """

    def __init__(self, fs: Iterable[Future] = ()):
        self._loop = asyncio.get_running_loop()
        self._event = asyncio.Event()
        self._fresh: list[Future] = []
        self._known: dict[int, Future] = {}
        self._delivered: dict[int, weakref.ref] = {}
        for f in fs:
            self.add(f)

    def __len__(self) -> int:
        return len(self._known)

    def add(self, f: Future) -> None:
        if id(f) in self._known:
            return
        tomb = self._delivered.get(id(f))
        if tomb is not None:
            if tomb() is f:
                return
            del self._delivered[id(f)]
        self._known[id(f)] = f
        # weak self (like Waiter): the registered callback must not pin an
        # abandoned waiter — or, through it, every registered future
        wref = weakref.ref(self)
        loop = self._loop

        def _fire(_h, f=f):
            def _deliver():
                waiter = wref()
                if waiter is None:
                    return
                waiter._fresh.append(f)
                waiter._event.set()
            try:
                loop.call_soon_threadsafe(_deliver)
            except RuntimeError:
                pass                     # loop closed: waiter is gone

        f._register(_fire)

    async def wait(self, timeout: "float | None" = None) -> list[Future]:
        """Suspend until at least one registered future newly completed;
        return those (empty only if ``timeout`` elapsed first)."""
        if not self._fresh:
            # single-threaded with the _deliver callbacks (same loop), so
            # clear-then-await cannot lose a delivery
            self._event.clear()
            if timeout is None:
                await self._event.wait()
            else:
                try:
                    await asyncio.wait_for(self._event.wait(),
                                           max(timeout, 0.0))
                except asyncio.TimeoutError:
                    return []
        fresh, self._fresh = self._fresh, []
        for f in fresh:
            self._known.pop(id(f), None)
            self._delivered[id(f)] = weakref.ref(f)
        return fresh


async def as_completed_async(fs, timeout: "float | None" = None
                             ) -> AsyncIterator[Future]:
    """``async for f in as_completed_async(fs)``: yield futures in
    completion order without blocking the event loop — the cooperative
    analogue of :func:`as_completed`, usable from inside a running loop on
    any mix of backends. Raises ``TimeoutError`` if ``timeout`` elapses
    with futures still pending."""
    waiter = AsyncWaiter(_flatten_futures(fs))
    left = len(waiter)
    deadline = None if timeout is None else time.monotonic() + timeout
    while left:
        remaining = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"{left} futures unresolved after {timeout}s")
        got = await waiter.wait(remaining)
        if not got:
            raise TimeoutError(
                f"{left} futures unresolved after {timeout}s")
        for f in got:
            left -= 1
            yield f


def wait_any(fs: Sequence[Future], timeout: "float | None" = None
             ) -> list[Future]:
    """Block until at least one of ``fs`` is resolved (launching lazy
    futures); return the resolved subset — empty only if ``timeout``
    elapsed.

    One event wait even when ``fs`` spans several backends: each future's
    backend pushes its completion into a shared :class:`Waiter` and the
    caller sleeps on a single condition variable until the first push.
    Futures on a single backend take that backend's ``wait()`` directly —
    same event semantics, zero residual registration, so legacy
    ``while ...: wait_any(fs, timeout=t)`` poll loops stay stateless.
    """
    fs = list(fs)
    ready = [f for f in fs if f.resolved()]
    if ready or not fs:
        return ready
    backends = {id(f._backend) for f in fs}
    if len(backends) == 1:
        fs[0]._backend.wait([f._handle for f in fs], timeout=timeout)
        return [f for f in fs if f.resolved()]
    if Waiter(fs).wait(timeout=timeout):
        return [f for f in fs if f.resolved()]
    return []


def resolve(fs, timeout: "float | None" = None):
    """Block until every future in ``fs`` is resolved (R's ``resolve()``).

    Accepts a single future, an iterable, or a dict of futures; lazy futures
    are launched. Values are *not* collected and nothing is relayed — use
    ``value()`` for that. Returns ``fs`` with everything resolved; if
    ``timeout=`` elapses with futures still pending, raises ``TimeoutError``
    (like :func:`as_completed` and ``value(timeout=)``) — it used to return
    ``fs`` indistinguishably from success, forcing callers to re-scan
    ``resolved()`` themselves.
    """
    waiter = Waiter(_flatten_futures(fs))
    left = len(waiter)
    deadline = None if timeout is None else time.monotonic() + timeout
    while left:
        remaining = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"{left} futures unresolved after {timeout}s")
        got = waiter.wait(remaining)
        if not got and deadline is not None:
            raise TimeoutError(
                f"{left} futures unresolved after {timeout}s")
        left -= len(got)
    return fs


def as_completed(fs, timeout: "float | None" = None) -> Iterator[Future]:
    """Yield futures from ``fs`` in completion order (the
    ``concurrent.futures.as_completed`` analogue, push-driven through one
    :class:`Waiter`). Raises ``TimeoutError`` if ``timeout`` elapses with
    futures still pending."""
    waiter = Waiter(_flatten_futures(fs))
    left = len(waiter)
    deadline = None if timeout is None else time.monotonic() + timeout
    while left:
        remaining = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"{left} futures unresolved after {timeout}s")
        got = waiter.wait(remaining)
        if not got:
            raise TimeoutError(
                f"{left} futures unresolved after {timeout}s")
        for f in got:
            left -= 1
            yield f


# --------------------------------------------------------------------------
# Module-level combinators
# --------------------------------------------------------------------------

def gather(fs, *, label: str | None = None) -> Future:
    """One future resolving to ``[value(f) for f in fs]``.

    Completes once *all* inputs have (success or failure alike — no input
    is abandoned mid-flight); ``value()`` relays every input's captured
    output in input order, then re-raises the first failure by input order
    if any. Inputs may live on different backends.
    """
    fs = _flatten_futures(fs)
    out = Future._derived(label or f"gather[{len(fs)}]")
    if not fs:
        _CHAIN.complete(out._handle, run=CapturedRun(value=[]))
        return out
    left = [len(fs)]
    lock = threading.Lock()

    def _fire(_h):
        with lock:
            left[0] -= 1
            if left[0]:
                return
        _spawn_continuation(out, lambda: _step_gather(fs, out))

    for f in fs:
        f._register(_fire)
    return out


def _step_gather(fs: list[Future], out: Future) -> None:
    runs = []
    for f in fs:
        run, infra = _outcome(f)
        if infra is not None:
            _CHAIN.complete(out._handle, error=infra)
            return
        try:
            # gather crosses workers by construction: pull each worker-
            # resident input down (driver fallback of the dataflow path)
            run = _materialize_run(run)
        except Exception as exc:                     # noqa: BLE001
            _CHAIN.complete(out._handle, error=exc)
            return
        runs.append(run)
    merged = CapturedRun(value=[r.value for r in runs])
    for r in runs:
        merged.stdout += r.stdout
        merged.conditions = merged.conditions + r.conditions
        merged.immediate = merged.immediate + r.immediate
        merged.wall_time_s += r.wall_time_s
        merged.rng_touched |= r.rng_touched
    for r in runs:
        if r.error is not None:
            merged.value = None
            merged.error, merged.error_tb = r.error, r.error_tb
            break
    _CHAIN.complete(out._handle, run=merged)


def first(fs, *, label: str | None = None) -> Future:
    """The first future of ``fs`` to complete — value *or* error — wins
    (Hewitt & Baker's EITHER); every loser is cancelled. Ties (several
    already resolved at call time) break by input order."""
    fs = _flatten_futures(fs)
    if not fs:
        raise ValueError("first() needs at least one future")
    out = Future._derived(label or f"first[{len(fs)}]")
    won: list[Future] = []
    lock = threading.Lock()

    def _register_one(f: Future) -> None:
        def _fire(_h):
            with lock:
                if won:
                    return
                won.append(f)
            _spawn_continuation(out, lambda: _step_first(f, fs, out))
        f._register(_fire)

    for f in fs:
        _register_one(f)
    return out


def _step_first(winner: Future, fs: list[Future], out: Future) -> None:
    for f in fs:
        if f is not winner:
            f.cancel()
    _step_adopt(winner, out)


def first_successful(fs, *, label: str | None = None) -> Future:
    """The first future of ``fs`` to complete *successfully* wins and the
    rest are cancelled; failures (evaluation errors and infrastructure
    FutureErrors alike) are skipped. If every input fails, the failure of
    the lowest-index input propagates (deterministic across backends)."""
    fs = _flatten_futures(fs)
    if not fs:
        raise ValueError("first_successful() needs at least one future")
    out = Future._derived(label or f"first_successful[{len(fs)}]")
    state = {"won": False, "left": len(fs)}
    lock = threading.Lock()

    def _register_one(f: Future) -> None:
        f._register(lambda _h: _spawn_continuation(
            out, lambda: _step_first_successful(f, fs, state, lock, out)))

    for f in fs:
        _register_one(f)
    return out


def _step_first_successful(f: Future, fs: list[Future], state: dict,
                           lock: threading.Lock, out: Future) -> None:
    run, infra = _outcome(f)
    ok = infra is None and run.error is None
    with lock:
        if state["won"]:
            return
        state["left"] -= 1
        exhausted = state["left"] == 0
        if ok:
            state["won"] = True
    if ok:
        for other in fs:
            if other is not f:
                other.cancel()
        _CHAIN.complete(out._handle, run=dataclasses.replace(run))
    elif exhausted:
        _step_adopt(fs[0], out)


def merge(futures: Sequence[Future], *, label: str | None = None) -> Future:
    """Merge *lazy* futures into one future resolving them sequentially in a
    single task (paper §Future work): the chunking primitive that the
    map-reduce layer uses for load balancing. ``value()`` of the merged
    future returns the list of sub-values."""
    for f in futures:
        if f._state != _CREATED:
            raise GlobalsError("merge() requires lazy, unlaunched futures")

    subs = [(f._fn, f._args, f._kwargs, f.seed_declared) for f in futures]

    def _chunk(subs=subs):
        out = []
        for fn, args, kwargs, _seed in subs:
            out.append(fn(*args, **kwargs))
        return out

    merged = Future(_chunk, (), {}, label=label or
                    f"merge[{len(futures)}]",
                    seed=futures[0].seed_declared or None)
    merged._merged_n = len(futures)
    return merged


__all__ = ["Future", "future", "value", "resolved", "resolve",
           "as_completed", "as_completed_async", "wait_any", "merge",
           "gather", "first", "first_successful", "Waiter", "AsyncWaiter",
           "FutureError"]
