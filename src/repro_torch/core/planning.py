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
For ``processes``: ``workers=N`` and ``blob_store_bytes=`` (each worker's
payload cache bound; see ``backends/processes.py``). For the TCP
``cluster``: ``workers=N`` / ``hosts=N`` (launch N local connect-back
workers), ``hosts=("a", "b")`` (one worker per named host — ssh by
default), ``launcher=`` (a ``launchers.Launcher`` instance,
``"local"``/``"ssh"``, a scheduler command template containing
``{driver}``, or ``"external"``), ``bind=``/``port=``/``advertise=``,
``connect_timeout=``, ``heartbeat_interval=``/``heartbeat_timeout=``,
``relaunch_backoff=``/``relaunch_backoff_cap=``, ``token=``, ``tls=``,
``blob_store_bytes=``, ``min_replicas=``, the ``lineage_*`` caps and
``tenants=`` — see ``backends/cluster.py``; ``serving`` takes ``addr=``,
``token=`` and ``tls_ca=`` (``core/serving``) — and
``backends/launchers.py``. Launchers are hashable frozen dataclasses, so
they ride inside the spec — and the warm-pool key below hashes the whole
spec: re-planning to the same spec re-attaches to the live workers.
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
_active_key: "tuple | None" = None
_lock = threading.RLock()


# --------------------------------------------------------------------------
# Warm backend pool: re-plan()ing to a previously used BackendSpec
# re-attaches to its live workers (blob caches intact, no torch re-import,
# no CUDA re-init) instead of cold-starting a new pool. Only worker-owning
# backends are parked; explicit shutdown() still tears everything down.
#
# The cluster backend's dataflow state — the digest->holder location map
# behind locality-scheduled continuations and peer fetch — lives on the
# backend *object*, so parking/re-attaching preserves it structurally: a
# RemoteValue produced before a plan() swap still knows where its bytes
# live after planning back, and chains on it keep their locality.
# --------------------------------------------------------------------------

#: parked backends, key -> Backend (insertion-ordered for LRU eviction)
_WARM_POOL: "dict[tuple, Backend]" = {}
_WARM_POOL_MAX = 3
#: backends worth keeping warm (expensive worker startup). Deliberately
#: excludes the in-process backends — threads are cheap to respawn, and the
#: asyncio and cuda_async backends' whole cost is one thread: parking them
#: buys nothing over a cold start, so plan() swaps shut them down instead.
#: The serving *client* is also excluded: its session holds the
#: process-wide state-client override and a server-side TTL — parking it
#: would keep routing state calls to a session the user has planned away
#: from.
_POOLABLE = ("processes", "cluster")


def _freeze(obj) -> "Any":
    """Recursively hashable view of a spec kwarg value: ``tenants={"a":
    {"weight": 3.0}}`` must be poolable even though dicts aren't
    hashable. Dicts become
    tagged sorted item-tuples (the tag keeps ``{"a": 1}`` distinct from
    ``(("a", 1),)``)."""
    if isinstance(obj, dict):
        return ("{}", tuple(sorted((k, _freeze(v)) for k, v in obj.items())))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    if isinstance(obj, (set, frozenset)):
        return ("set", tuple(sorted(map(repr, obj))))
    try:
        hash(obj)
    except TypeError:
        return ("repr", repr(obj))
    return obj


def _security_fingerprint(head: BackendSpec) -> tuple:
    """Credential identity of a secured backend spec. Two plans can be
    kwarg-identical yet security-distinct — the cluster token defaults to
    ``$REPRO_CLUSTER_TOKEN`` (mutable between plans) and ``tls=True``
    generates a fresh cert per instantiation — and reattaching a warm pool
    across a credential change would serve the new plan with the old
    secrets. Tokens enter the key hashed, never raw."""
    if head.name not in ("cluster", "serving"):
        return ()
    import hashlib
    kwargs = dict(head.kwargs)
    token = kwargs.get("token")
    if token is None:
        token = os.environ.get("REPRO_CLUSTER_TOKEN", "")
    token_fp = hashlib.blake2b(str(token).encode(),
                               digest_size=8).hexdigest() if token else ""
    tls = kwargs.get("tls") or kwargs.get("tls_ca")
    if tls is True:
        # a fresh self-signed cert per instantiation: make the fingerprint
        # spec-stable ("auto") — the *same spec* re-planned still
        # reattaches, and the parked backend carries its cert with it
        tls_fp = "auto"
    elif hasattr(tls, "fingerprint"):
        tls_fp = tls.fingerprint()
    else:
        tls_fp = _freeze(tls) if tls else ""
    return (token_fp, tls_fp, _freeze(kwargs.get("tenants")))


def _backend_key(head: BackendSpec, stack: "tuple[BackendSpec, ...]"
                 ) -> tuple:
    """Identity under which a live backend may be reused: same head spec
    (kwargs deep-frozen so dict-valued ones like ``tenants=`` hash), same
    nested stack (workers captured it at init),
    same session seed (worker RNG streams derive from it), same security
    credentials (:func:`_security_fingerprint`)."""
    from . import rng as rng_mod
    nested = stack[1:] if len(stack) > 1 else (_SEQUENTIAL,)

    def _kw(s: BackendSpec):
        # the raw token must never sit in a long-lived pool key; the
        # security fingerprint covers it (hashed)
        return _freeze({k: v for k, v in s.kwargs if k != "token"})

    return (head.name, _kw(head),
            tuple((s.name, _kw(s)) for s in nested),
            rng_mod._session_seed,
            _security_fingerprint(head))


def _park_active_locked() -> list:
    """Move the active backend into the warm pool (callers hold _lock).

    Returns the backends displaced in the process — non-poolable actives,
    stale pool entries, LRU evictions — for the *caller* to shut down
    after releasing the lock (a pool's shutdown reaps processes for
    seconds; holding the planning lock through that would stall every
    concurrent plan()/active_backend())."""
    global _active_backend, _active_spec, _active_key
    doomed: list = []
    backend, key = _active_backend, _active_key
    _active_backend = _active_spec = _active_key = None
    if backend is None:
        return doomed
    if key is None or key[0] not in _POOLABLE:
        doomed.append(backend)
        return doomed
    stale = _WARM_POOL.pop(key, None)
    if stale is not None:
        doomed.append(stale)
    _WARM_POOL[key] = backend
    while len(_WARM_POOL) > _WARM_POOL_MAX:
        oldest = next(iter(_WARM_POOL))
        doomed.append(_WARM_POOL.pop(oldest))
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
    down once its running futures finish — except a worker-owning one
    (``processes``), which is *parked* in a small warm pool: re-planning
    back to the same spec (same nested stack and session seed) re-attaches
    to the live workers, their imports, CUDA contexts and payload caches
    intact. Call :func:`shutdown` to really release every worker. A level
    that cannot run on this host (``cuda_async`` without a card) raises
    here, not at the first future.
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
            doomed = _park_active_locked()
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
    global _active_backend, _active_spec, _active_key
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
                doomed = _park_active_locked()
                key = _backend_key(head, _global_stack)
                warm = _WARM_POOL.pop(key, None)
                if warm is not None:
                    _active_backend = warm
                else:
                    try:
                        _active_backend = head.instantiate()
                    except Exception:
                        # a parked backend may still pin a resource the new
                        # spec needs (e.g. a cluster listener on an explicit
                        # port): flush the pool and retry once
                        stale = doomed + list(_WARM_POOL.values())
                        doomed = []
                        _WARM_POOL.clear()
                        if not stale:
                            raise
                        for b in stale:
                            b.shutdown()
                        _active_backend = head.instantiate()
                _active_spec, _active_key = head, key
            return _active_backend
    finally:
        for b in doomed:
            b.shutdown()


def shutdown() -> None:
    """Release every worker: the active backend *and* the warm pool."""
    global _active_backend, _active_spec, _active_key
    with _lock:
        doomed = list(_WARM_POOL.values())
        _WARM_POOL.clear()
        if _active_backend is not None:
            doomed.append(_active_backend)
            _active_backend = _active_spec = _active_key = None
    for b in doomed:
        b.shutdown()
