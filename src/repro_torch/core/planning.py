"""plan(): the end-user's choice of how/where futures are resolved.

The paper's central design split: *the developer decides what to
parallelize, the end-user decides how* — by setting ``plan(...)`` once,
without touching the algorithm code. Plans form a **stack** for nested
parallelism, e.g.::

    plan([spec("threads", workers=2), spec("threads", workers=3)])

runs at most 2×3 tasks: the first level resolves on a thread pool and
every worker receives the *popped* stack (``threads`` level), any deeper
nesting defaulting to ``sequential`` — the paper's built-in protection
against N² oversubscription.

Backend kwargs are passed through ``spec()`` to the backend constructor.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Sequence

from .backends.base import Backend, BACKEND_REGISTRY


# --------------------------------------------------------------------------
# availableCores() — parallelly analogue
# --------------------------------------------------------------------------

_CORE_ENV_VARS = (
    "REPRO_WORKERS",            # our own override
    "SLURM_CPUS_PER_TASK",      # slurm
    "NSLOTS",                   # SGE
    "PBS_NUM_PPN",              # torque/PBS
    "OMP_NUM_THREADS",
)

#: cgroup v2 unified-hierarchy CPU controller file ("QUOTA PERIOD" in us,
#: QUOTA == "max" when unlimited). Module-level so tests can point it at a
#: fake file.
_CGROUP_CPU_MAX = "/sys/fs/cgroup/cpu.max"


def _cgroup_cpu_limit(path: "str | None" = None) -> "int | None":
    """Effective CPU count granted by a cgroup v2 ``cpu.max`` quota, or
    None when absent/unlimited/unparseable. A 0.5-CPU container rounds up
    to 1 (quota ceil), never to the host's core count."""
    try:
        with open(path or _CGROUP_CPU_MAX) as fh:
            fields = fh.read().split()
    except OSError:
        return None
    if not fields or fields[0] == "max":
        return None
    try:
        quota = int(fields[0])
        period = int(fields[1]) if len(fields) > 1 else 100_000
    except ValueError:
        return None
    if quota <= 0 or period <= 0:
        return None
    return max(1, -(-quota // period))             # ceil(quota / period)


def available_cores() -> int:
    """Respect scheduler/env/container limits instead of blindly using
    every core — the paper's multi-tenant-friendly ``availableCores()``
    (vs the ``detectCores()`` anti-pattern).

    Order: an explicit env override wins outright; otherwise the host
    count is clamped by the scheduler CPU affinity mask
    (``os.sched_getaffinity``) and the cgroup v2 ``cpu.max`` quota, so a
    2-CPU container on a 64-core host gets 2 workers, not 64."""
    for var in _CORE_ENV_VARS:
        val = os.environ.get(var)
        if val:
            try:
                n = int(val)
                if n > 0:
                    return n
            except ValueError:
                pass
    limit = os.cpu_count() or 1
    try:
        affinity = len(os.sched_getaffinity(0))
        if affinity:
            limit = min(limit, affinity)
    except (AttributeError, OSError):
        pass                                       # not on this platform
    quota = _cgroup_cpu_limit()
    if quota is not None:
        limit = min(limit, quota)
    return max(limit, 1)


# --------------------------------------------------------------------------
# Backend specs & the plan stack
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """A picklable description of a backend level — shippable to workers so
    nested levels can be instantiated remotely."""
    name: str
    kwargs: tuple[tuple[str, Any], ...] = ()

    def instantiate(self) -> Backend:
        cls = BACKEND_REGISTRY[self.name]
        return cls(**dict(self.kwargs))

    def __repr__(self):
        kw = ", ".join(f"{k}={v!r}" for k, v in self.kwargs)
        return f"{self.name}({kw})"


def spec(name: str, **kwargs) -> BackendSpec:
    if name not in BACKEND_REGISTRY:
        raise ValueError(f"unknown backend {name!r}; "
                         f"known: {sorted(BACKEND_REGISTRY)}")
    return BackendSpec(name, tuple(sorted(kwargs.items())))


def tweak(base: "BackendSpec | str", **kwargs) -> BackendSpec:
    """paper: tweak(multisession, workers = 2)."""
    if isinstance(base, str):
        base = spec(base)
    merged = dict(base.kwargs)
    merged.update(kwargs)
    return BackendSpec(base.name, tuple(sorted(merged.items())))


_SEQUENTIAL = BackendSpec("sequential")


class _PlanState(threading.local):
    def __init__(self):
        self.stack: tuple[BackendSpec, ...] | None = None  # thread override
        # lazily-instantiated backend for nested contexts, cached on the
        # TLS stack entry and torn down when use_nested_stack exits
        self.nested_backend: Backend | None = None
        self.nested_spec: BackendSpec | None = None


_TLS = _PlanState()
_global_stack: tuple[BackendSpec, ...] = (_SEQUENTIAL,)
_active_backend: Backend | None = None
_active_spec: BackendSpec | None = None
_lock = threading.RLock()


def _drop_active_locked() -> list:
    """Detach the active backend (callers hold _lock) and return it for the
    caller to shut down after releasing the lock."""
    global _active_backend, _active_spec
    doomed = [] if _active_backend is None else [_active_backend]
    _active_backend = _active_spec = None
    return doomed


def _normalize(levels) -> tuple[BackendSpec, ...]:
    if isinstance(levels, (BackendSpec, str)):
        levels = [levels]
    out = []
    for lv in levels:
        out.append(spec(lv) if isinstance(lv, str) else lv)
    return tuple(out) or (_SEQUENTIAL,)


def plan(levels: "str | BackendSpec | Sequence[BackendSpec | str]" = "sequential",
         **kwargs) -> tuple[BackendSpec, ...]:
    """Set the plan stack; returns the previous stack (like R's plan()).

    ``plan("threads", workers=4)`` is sugar for ``plan(spec("threads",
    workers=4))``. Changing the plan shuts the previously active backend
    down once its running futures finish. A level that cannot run on this
    host (``cuda_async`` without a card) raises here, not at the first
    future.
    """
    global _global_stack
    if kwargs:
        if not isinstance(levels, (str, BackendSpec)):
            raise ValueError("kwargs only allowed with a single backend level")
        levels = tweak(levels if isinstance(levels, BackendSpec)
                       else spec(levels), **kwargs)
    new = _normalize(levels)
    for lv in new:            # refuse a level that cannot run here, now
        BACKEND_REGISTRY[lv.name].validate_spec(**dict(lv.kwargs))
    doomed: list = []
    with _lock:
        prev = _global_stack
        if new != prev:
            doomed = _drop_active_locked()
            _global_stack = new
    for b in doomed:
        b.shutdown()
    return prev


def current_stack() -> tuple[BackendSpec, ...]:
    return _TLS.stack if _TLS.stack is not None else _global_stack


def nested_stack() -> tuple[BackendSpec, ...]:
    """The stack a worker of the current level must adopt (protection
    against nested oversubscription: default tail = sequential)."""
    stack = current_stack()
    return stack[1:] if len(stack) > 1 else (_SEQUENTIAL,)


class use_nested_stack:
    """Context manager installed by backends around in-process evaluation so
    any future created *inside* a future sees the popped stack.

    The backend lazily instantiated for the nested level is cached on the
    TLS entry (one per context, not one per ``active_backend()`` call) and
    shut down when the context exits — nested levels no longer leak a
    worker pool per future creation.
    """

    def __init__(self, stack: tuple[BackendSpec, ...] | None = None):
        self.stack = stack if stack is not None else nested_stack()

    def __enter__(self):
        self._prev = (_TLS.stack, _TLS.nested_backend, _TLS.nested_spec)
        _TLS.stack = self.stack
        _TLS.nested_backend = None
        _TLS.nested_spec = None
        return self

    def __exit__(self, *exc):
        created = _TLS.nested_backend
        _TLS.stack, _TLS.nested_backend, _TLS.nested_spec = self._prev
        if created is not None:
            created.shutdown()
        return False


def thread_stack_override() -> "tuple[BackendSpec, ...] | None":
    """This thread's plan-stack override, or None outside any worker /
    continuation context. ``None`` doubles as the "this thread holds no
    bounded worker slot" signal the continuation dispatcher keys on:
    backend worker threads always run under :class:`use_nested_stack`, so
    a set override marks a thread that must never execute blocking
    continuation work inline."""
    return _TLS.stack


class use_global_stack:
    """Continuation scope: evaluate under the *global* plan stack.

    Continuation steps used to run on fresh parent-side threads, whose
    thread-local plan override is unset — i.e. they saw the end-user's
    global plan. Now that they dispatch through a backend's worker pool
    (which installs ``use_nested_stack`` around everything it runs), this
    scope restores that contract: futures created inside a ``then``/
    ``map``/``recover``/``fallback`` callback land on the active global
    plan, not the worker's popped (sequential) stack.
    """

    def __enter__(self):
        self._prev = (_TLS.stack, _TLS.nested_backend, _TLS.nested_spec)
        _TLS.stack = None
        _TLS.nested_backend = None
        _TLS.nested_spec = None
        return self

    def __exit__(self, *exc):
        # with stack=None, active_backend() takes the global branch and
        # never populates the TLS nested cache — but guard anyway
        created = _TLS.nested_backend
        _TLS.stack, _TLS.nested_backend, _TLS.nested_spec = self._prev
        if created is not None:
            created.shutdown()
        return False


def active_backend() -> Backend:
    """Instantiate (lazily) the backend for the current stack head."""
    global _active_backend, _active_spec
    head = current_stack()[0]
    if _TLS.stack is not None:
        # Nested context: a private backend, cached on the TLS stack entry
        # so repeated future creation inside one context reuses it; the
        # enclosing use_nested_stack tears it down on exit.
        if _TLS.nested_spec != head or _TLS.nested_backend is None:
            if _TLS.nested_backend is not None:
                _TLS.nested_backend.shutdown()
            _TLS.nested_backend = head.instantiate()
            _TLS.nested_spec = head
        return _TLS.nested_backend
    doomed: list = []
    try:
        with _lock:
            if _active_spec != head or _active_backend is None:
                doomed = _drop_active_locked()
                _active_backend = head.instantiate()
                _active_spec = head
            return _active_backend
    finally:
        for b in doomed:
            b.shutdown()


def shutdown() -> None:
    """Release the active backend's workers."""
    with _lock:
        doomed = _drop_active_locked()
    for b in doomed:
        b.shutdown()
