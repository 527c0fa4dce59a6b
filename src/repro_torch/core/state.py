"""Shared-state subsystem: a driver-hosted, versioned key-value service
callable from *inside task bodies* on every backend of the port.

The paper's Future API models independent task evaluation; many parallel
algorithms (async hyperparameter search, parameter-server training,
bandit/evolutionary loops) additionally need workers to communicate through
shared state between task boundaries. This module is that lane::

    from repro_torch.core import state

    def body(grads):
        params = state.get("params")
        state.update("step", lambda s: (s or 0) + 1)
        ...

    future(body, g)          # works under every backend of the port

Model
-----

One :class:`StateService` per process (``service()``): a dict of entries,
each ``key -> (value, version)``. Versions are per-key integers starting at
1 on first ``put`` and bumping by exactly one per committed write; the
counter survives ``delete`` (a later re-``put`` continues the sequence), so
version numbers are *monotone for the lifetime of the session* and a reader
can never confuse a re-created entry with a stale one. Values are treated
as immutable by contract: every backend of the port runs its task bodies in
this process, so a reader gets the live object — ``state.get`` of a dict of
CUDA tensors copies nothing, on the host or on the card. Mutate-in-place is
outside the contract; rebind through ``put``/``update`` instead.

Primitives:

* ``put(key, value) -> version``
* ``get(key, default=..., min_version=0)`` / ``read(...) -> (value, ver)``
* ``cas(key, expected_version, value) -> (ok, version, current)`` —
  commits iff the entry's version is exactly ``expected_version``
  (``0`` = create); on failure returns the current version + value so a
  retry loop needs no extra round trip
* ``update(key, fn, default=None) -> (value, version)`` — atomic
  read-modify-write, folded under the service lock: the committed history
  is the exact sequential fold (no lost updates, no torn versions). ``fn``
  must be fast and pure.
* ``add`` / ``extend`` — the two hot folds (counters and logs);
* ``delete(key) -> bool``; ``wait(key, min_version=1, timeout=None)`` —
  block until the entry reaches ``min_version`` (:class:`StateTimeout`
  on expiry); ``wait_async`` for coroutines; ``keys(prefix="")``;
  ``version(key)``.

Task bodies reach the service through the ambient client: none is
installed by the port's backends (all run in process), so module calls
fall through to the in-process singleton. :class:`state_context` and
:func:`set_default_client` are the hooks an out-of-process backend installs
its client through.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Callable

_MISSING = object()


class StateError(RuntimeError):
    """A state operation failed for a non-timeout reason (service gone,
    blob unservable, malformed op)."""


class StateTimeout(StateError, TimeoutError):
    """``wait(key, min_version, timeout=)`` expired before the entry
    reached the requested version."""


#: first element of a tenant-scoped key tuple (serving tier): tenant keys
#: are wrapped server-side as ``(_TENANT_NS, tenant, key)`` so two tenants'
#: namespaces can never collide — and a tenant cannot *name* another's keys
#: at all, because the wrapper is applied after its identity is established
_TENANT_NS = "~tenant~"


def scoped_key(tenant: "str | None", key):
    """The storage key for ``key`` in ``tenant``'s namespace (identity for
    ``tenant=None`` — direct library use is unscoped)."""
    if tenant is None:
        return key
    return (_TENANT_NS, tenant, key)


def scope_args(op: str, args: tuple, tenant: "str | None") -> tuple:
    """Rewrite a wire op's key into ``tenant``'s namespace. ``blob`` is
    content-addressed (digests are unguessable, no key to scope) and
    ``keys`` is scoped by the service itself (it must list + unwrap)."""
    if tenant is None or op in ("blob", "keys"):
        return args
    return (scoped_key(tenant, args[0]),) + tuple(args[1:])


def _safe_exc(exc: Exception) -> Exception:
    """An exception instance that survives pickling (mirrors worker.py's
    ``_sanitize_run``)."""
    try:
        pickle.dumps(exc)
        return exc
    except Exception:                                     # noqa: BLE001
        return StateError(f"{type(exc).__name__}: {exc}")


class _Watch:
    __slots__ = ("key", "min_version", "cb", "deadline")

    def __init__(self, key, min_version: int, cb, deadline):
        self.key = key
        self.min_version = int(min_version)
        self.cb = cb
        self.deadline = deadline


# --------------------------------------------------------------------------
# The service
# --------------------------------------------------------------------------

class StateService:
    """Thread-safe versioned KV store + watch registry. Hosted in the
    driver process; every backend of the port calls it directly (an
    out-of-process backend would reach it through an RPC client)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._values: dict = {}
        #: per-key commit counter; SURVIVES delete so versions are monotone
        #: across re-creation (0 = never written)
        self._versions: dict = {}
        self._watches: "list[_Watch]" = []
        self.counters = {"puts": 0, "gets": 0, "cas_ok": 0, "cas_fail": 0,
                         "deletes": 0, "waits": 0, "updates": 0, "folds": 0}

    # -- core ops (in-process surface) --------------------------------------

    def _commit_locked(self, key, value):
        """Install ``value`` as the next version of ``key``; returns
        ``(version, satisfied_watches)``. Caller holds ``_lock`` and MUST
        fire the watches after releasing it."""
        version = self._versions.get(key, 0) + 1
        self._versions[key] = version
        self._values[key] = value
        fired, rest = [], []
        for wch in self._watches:
            if wch.key == key and version >= wch.min_version:
                fired.append(wch)
            else:
                rest.append(wch)
        self._watches = rest
        self._cv.notify_all()
        return version, fired

    @staticmethod
    def _fire(watches, value, version) -> None:
        for wch in watches:
            try:
                wch.cb(True, value, version)
            except Exception:                             # noqa: BLE001
                pass

    def put(self, key, value) -> int:
        with self._lock:
            self.counters["puts"] += 1
            version, fired = self._commit_locked(key, value)
        self._fire(fired, value, version)
        return version

    def read(self, key, default=_MISSING, min_version: int = 0):
        """``(value, version)`` — the versioned read. An absent (or
        older-than-``min_version``) entry returns ``(default, version)``
        when a default was given, else raises ``KeyError``. The returned
        version is the key's commit counter either way (0 = never
        written), which is exactly what a CAS retry loop needs."""
        with self._lock:
            self.counters["gets"] += 1
            version = self._versions.get(key, 0)
            if key in self._values and version >= min_version:
                return self._values[key], version
        if default is _MISSING:
            raise KeyError(key)
        return default, version

    def get(self, key, default=_MISSING, min_version: int = 0):
        return self.read(key, default, min_version)[0]

    def cas(self, key, expected_version: int, value):
        """Commit ``value`` iff the entry's version is exactly
        ``expected_version`` (0 = entry never written / at its post-delete
        counter). Returns ``(ok, version, current)``: on success the new
        version (``current`` is None); on failure the live version and
        value (None when absent) so the caller retries without another
        read."""
        with self._lock:
            current_version = self._versions.get(key, 0)
            if current_version != int(expected_version):
                self.counters["cas_fail"] += 1
                current = self._values.get(key)
                return False, current_version, current
            self.counters["cas_ok"] += 1
            version, fired = self._commit_locked(key, value)
        self._fire(fired, value, version)
        return True, version, None

    def update(self, key, fn: Callable, default=None):
        """Atomic read-modify-write: ``value = fn(current or default)``
        committed as the next version, folded under the service lock (the
        in-process fast path — RPC clients implement this as a CAS loop).
        ``fn`` must be fast and pure."""
        with self._lock:
            self.counters["updates"] += 1
            current = self._values.get(key, default)
            value = fn(current)
            version, fired = self._commit_locked(key, value)
        self._fire(fired, value, version)
        return value, version

    # -- server-side folds ---------------------------------------------------
    #
    # ``add``/``extend`` are the two hot fold shapes (counters and logs).
    # Folding under the service lock makes them exact at any contention in
    # ONE round trip — remote ``update`` is a CAS retry loop whose expected
    # cost grows with the number of concurrent writers.

    def add(self, key, delta, default=0):
        """Atomically commit ``(current or default) + delta`` as the next
        version of ``key``; returns ``(new_value, version)``. Works for any
        type with ``+`` (ints, floats, ndarrays...)."""
        with self._lock:
            self.counters["folds"] += 1
            current = self._values.get(key, _MISSING)
            value = (default if current is _MISSING else current) + delta
            version, fired = self._commit_locked(key, value)
        self._fire(fired, value, version)
        return value, version

    def extend(self, key, items):
        """Atomically append ``items`` to the list at ``key`` (absent key
        starts from ``[]``); returns ``(new_length, version)``. The stored
        list is replaced, never mutated in place — readers holding the old
        value keep a consistent snapshot."""
        items = list(items)
        with self._lock:
            self.counters["folds"] += 1
            current = self._values.get(key, _MISSING)
            value = (list(current) if current is not _MISSING else []) + items
            version, fired = self._commit_locked(key, value)
        self._fire(fired, value, version)
        return len(value), version

    def delete(self, key) -> bool:
        """Remove the entry. The version counter is retained (monotone
        across re-creation); watchers are unaffected (no new version)."""
        with self._lock:
            self.counters["deletes"] += 1
            present = self._values.pop(key, _MISSING) is not _MISSING
        return present

    def wait(self, key, min_version: int = 1, timeout: "float | None" = None):
        """Block until ``key`` exists at ``version >= min_version``;
        returns ``(value, version)``. Raises :class:`StateTimeout`."""
        with self._lock:
            self.counters["waits"] += 1

            def ready():
                return (key in self._values
                        and self._versions.get(key, 0) >= min_version)

            if not self._cv.wait_for(ready, timeout):
                raise StateTimeout(
                    f"state.wait({key!r}, min_version={min_version}) timed "
                    f"out after {timeout}s at version "
                    f"{self._versions.get(key, 0)}")
            return self._values[key], self._versions[key]

    def keys(self, prefix: str = "") -> list:
        with self._lock:
            if not prefix:
                return sorted(self._values, key=repr)
            return sorted(k for k in self._values
                          if isinstance(k, str) and k.startswith(prefix))

    def version(self, key) -> int:
        with self._lock:
            return self._versions.get(key, 0)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._values),
                    "watches": len(self._watches), **self.counters}

    # -- watch registry (cluster driver's async wait) ------------------------

    def add_watch(self, key, min_version: int, cb,
                  deadline: "float | None" = None) -> None:
        """Register ``cb(ok, value, version)`` to fire once ``key``
        reaches ``min_version`` (fires immediately when already there), or
        with ``ok=False`` once ``deadline`` (monotonic) passes — swept by
        :meth:`expire_watches`. Callbacks run on whatever thread commits
        the satisfying version; they must not block."""
        with self._lock:
            self.counters["waits"] += 1
            version = self._versions.get(key, 0)
            if key in self._values and version >= min_version:
                value = self._values[key]
            else:
                self._watches.append(_Watch(key, min_version, cb, deadline))
                return
        try:
            cb(True, value, version)
        except Exception:                                 # noqa: BLE001
            pass

    def expire_watches(self, now: "float | None" = None) -> None:
        """Fire ``cb(False, None, current_version)`` on every watch whose
        deadline passed (called periodically by the cluster loop)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if not self._watches:
                return
            expired, rest = [], []
            for wch in self._watches:
                if wch.deadline is not None and now >= wch.deadline:
                    expired.append((wch, self._versions.get(wch.key, 0)))
                else:
                    rest.append(wch)
            self._watches = rest
        for wch, version in expired:
            try:
                wch.cb(False, None, version)
            except Exception:                             # noqa: BLE001
                pass


# --------------------------------------------------------------------------
# Clients + the ambient per-task context
# --------------------------------------------------------------------------

class _InProcClient:
    """Direct client for backends whose task bodies share the driver's
    address space (sequential / threads / asyncio / cuda_async, and driver
    code itself): every call is a method on the singleton service."""

    def __init__(self, svc: StateService):
        self._svc = svc
        self.cas_retries = 0

    def put(self, key, value):
        return self._svc.put(key, value)

    def read(self, key, default=_MISSING, min_version=0):
        return self._svc.read(key, default, min_version)

    def get(self, key, default=_MISSING, min_version=0):
        return self._svc.get(key, default, min_version)

    def cas(self, key, expected_version, value):
        return self._svc.cas(key, expected_version, value)

    def update(self, key, fn, default=None):
        return self._svc.update(key, fn, default)

    def add(self, key, delta, default=0):
        return self._svc.add(key, delta, default)

    def extend(self, key, items):
        return self._svc.extend(key, items)

    def delete(self, key):
        return self._svc.delete(key)

    def wait(self, key, min_version=1, timeout=None):
        return self._svc.wait(key, min_version, timeout)

    async def wait_async(self, key, min_version=1, timeout=None):
        """Event-loop-native wait: resolves via the service's watch
        registry, so the asyncio backend's cooperative tasks never park a
        thread (nor block the loop) on a KV wait."""
        import asyncio
        loop = asyncio.get_running_loop()
        fut: "asyncio.Future" = loop.create_future()
        svc = self._svc

        def cb(ok, value, version):
            def _settle():
                if fut.done():
                    return
                if ok:
                    fut.set_result((value, version))
                else:
                    fut.set_exception(StateTimeout(
                        f"state.wait_async({key!r}, min_version="
                        f"{min_version}) timed out after {timeout}s at "
                        f"version {version}"))
            try:
                loop.call_soon_threadsafe(_settle)
            except RuntimeError:
                pass                         # loop closed mid-wait

        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        svc.add_watch(key, int(min_version), cb, deadline)
        if timeout is not None:
            # in-process there is no cluster loop sweeping expired
            # watches — schedule the sweep ourselves, just past the
            # deadline so the satisfied-first race favours success
            loop.call_later(timeout + 0.005, svc.expire_watches)
        return await fut

    def keys(self, prefix=""):
        return self._svc.keys(prefix)

    def version(self, key):
        return self._svc.version(key)

    def stats(self):
        return {**self._svc.stats(), "cas_retries": self.cas_retries}


# --------------------------------------------------------------------------
# Module-level API (what task bodies call)
# --------------------------------------------------------------------------

_TLS = threading.local()
_SERVICE: "StateService | None" = None
_DEFAULT_CLIENT: "_InProcClient | None" = None
#: process-wide client override (the serving tier: a client process's
#: driver-side ``state.*`` calls must reach the *server's* service, not a
#: local singleton). Checked after the per-thread task context.
_OVERRIDE_CLIENT = None
_SERVICE_LOCK = threading.Lock()


def service() -> StateService:
    """The driver-process singleton service (created on first use)."""
    global _SERVICE
    with _SERVICE_LOCK:
        if _SERVICE is None:
            _SERVICE = StateService()
        return _SERVICE


def reset() -> None:
    """Replace the singleton with a fresh, empty service (test isolation;
    pending watches on the old service die with it)."""
    global _SERVICE, _DEFAULT_CLIENT, _OVERRIDE_CLIENT
    with _SERVICE_LOCK:
        _SERVICE = None
        _DEFAULT_CLIENT = None
        _OVERRIDE_CLIENT = None


def set_default_client(client) -> None:
    """Install ``client`` as the process-wide ambient state client —
    every ``state.*`` call outside a worker task context routes through
    it. ``None`` restores the in-process singleton. Used by the serving
    client backend so a tenant process's driver-side KV calls reach the
    server's (tenant-scoped) service."""
    global _OVERRIDE_CLIENT
    _OVERRIDE_CLIENT = client


def _client():
    client = getattr(_TLS, "client", None)
    if client is not None:
        return client
    if _OVERRIDE_CLIENT is not None:
        return _OVERRIDE_CLIENT
    global _DEFAULT_CLIENT
    if _DEFAULT_CLIENT is None or _DEFAULT_CLIENT._svc is not service():
        _DEFAULT_CLIENT = _InProcClient(service())
    return _DEFAULT_CLIENT


class state_context:
    """Install ``client`` as the ambient state client for this thread —
    the task-execution wrapper used by remote workers, mirroring
    ``globals_capture.payload_resolver``. Driver threads never enter one:
    their calls fall through to the in-process singleton."""

    def __init__(self, client):
        self._client = client
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_TLS, "client", None)
        _TLS.client = self._client
        return self._client

    def __exit__(self, *exc):
        _TLS.client = self._prev
        return False


def put(key, value) -> int:
    """Commit ``value`` as the next version of ``key``; returns it."""
    return _client().put(key, value)


def get(key, default=_MISSING, min_version: int = 0):
    """Current value of ``key`` (KeyError when absent and no default)."""
    return _client().get(key, default, min_version)


def read(key, default=_MISSING, min_version: int = 0):
    """``(value, version)`` — the versioned read for CAS users."""
    return _client().read(key, default, min_version)


def cas(key, expected_version: int, value):
    """Compare-and-set on the version counter: ``(ok, version, current)``."""
    return _client().cas(key, expected_version, value)


def update(key, fn: Callable, default=None):
    """Atomic read-modify-write; returns ``(new_value, version)``. ``fn``
    must be pure — over the wire it retries on CAS conflicts."""
    return _client().update(key, fn, default)


def add(key, delta, default=0):
    """Server-side atomic fold ``(current or default) + delta``; returns
    ``(new_value, version)``. One RPC — exact at any contention, unlike a
    remote :func:`update` CAS loop."""
    return _client().add(key, delta, default)


def extend(key, items):
    """Server-side atomic list append; returns ``(new_length, version)``.
    An absent key starts from ``[]``."""
    return _client().extend(key, items)


def delete(key) -> bool:
    return _client().delete(key)


def wait(key, min_version: int = 1, timeout: "float | None" = None):
    """Block until ``key`` reaches ``min_version``; ``(value, version)``.
    Raises :class:`StateTimeout` on expiry."""
    return _client().wait(key, min_version, timeout)


async def wait_async(key, min_version: int = 1,
                     timeout: "float | None" = None):
    """Awaitable :func:`wait` — in ``plan("asyncio")`` bodies (or any
    coroutine) the event loop keeps running while this parks on the key's
    version watch. Returns ``(value, version)``; raises
    :class:`StateTimeout` on expiry."""
    return await _client().wait_async(key, min_version, timeout)


def keys(prefix: str = "") -> list:
    return _client().keys(prefix)


def version(key) -> int:
    return _client().version(key)


def stats() -> dict:
    """Ambient client's op counters (plus the service's, in process)."""
    return _client().stats()


__all__ = [
    "StateService", "StateError", "StateTimeout", "state_context",
    "service", "reset", "set_default_client",
    "put", "get", "read", "cas", "update", "add", "extend", "delete",
    "wait", "wait_async", "keys", "version", "stats",
    "scoped_key", "scope_args",
]
