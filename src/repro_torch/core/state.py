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
as immutable by contract: the in-process backends hand back the live
object — ``state.get`` of a dict of CUDA tensors copies nothing, on the
host or on the card — and the processes backend a decoded copy (a tensor
is rebuilt on its device type, see ``backends/blobstore.py``).
Mutate-in-place is outside the contract; rebind through ``put``/``update``
instead.

Primitives:

* ``put(key, value) -> version``
* ``get(key, default=..., min_version=0)`` / ``read(...) -> (value, ver)``
* ``cas(key, expected_version, value) -> (ok, version, current)`` —
  commits iff the entry's version is exactly ``expected_version``
  (``0`` = create); on failure returns the current version + value so a
  retry loop needs no extra round trip
* ``update(key, fn, default=None) -> (value, version)`` — atomic
  read-modify-write. In process it folds under the service lock; over the
  pipe it is a client-side CAS retry loop, so ``fn`` may run more than
  once under contention and must be pure. Either way the committed history
  is the exact sequential fold: no lost updates, no torn versions.
* ``add`` / ``extend`` — the two hot folds (counters and logs);
* ``delete(key) -> bool``; ``wait(key, min_version=1, timeout=None)`` —
  block until the entry reaches ``min_version`` (:class:`StateTimeout`
  on expiry); ``wait_async`` for coroutines; ``keys(prefix="")``;
  ``version(key)``.

Ambient per-task context
------------------------

Task bodies address the *driver's* service through a thread-local client
installed around task execution, mirroring how ``payload_resolver``
injects content-addressed globals:

* sequential / threads / asyncio / cuda_async (and driver code itself): no
  client is installed — module calls fall through to the in-process
  singleton.
* processes: ``worker_main`` wraps execution in a :class:`PipeStateClient`
  speaking ``("state", rid, op, args)`` / ``("state_rep", rid, status,
  payload)`` messages over the existing task pipe; the parent's ``_drive``
  thread services them against the shared singleton.
* cluster: ``cluster_worker._serve`` installs a :class:`SockStateClient`.
  Requests ride the control socket as ``state`` frames; the driver's
  select loop executes small ops inline and bounces large-value serves and
  ``wait`` notifications to side threads (exactly like ``need``
  backfills). Replies are routed by the worker's *reader thread* straight
  into per-request wait slots — the main thread is blocked inside user
  code at that moment.

Wire value encoding reuses the content-addressed blob machinery: a value
whose lossless ``transport.encode_payload`` form is smaller than
``PAYLOAD_REF_THRESHOLD`` travels inline as ``("b", blob)``; larger values
travel as ``("r", digest, blob|None, nbytes)`` with the bytes parked in
``DRIVER_STORE`` / the worker's :class:`BlobStore` — a repeated ``get`` of
a large tensor costs a ~100 B message plus a decoded-object cache hit,
never a re-encode. A receiver that evicted the digest asks it back with
the ``blob`` op.
"""

from __future__ import annotations

import itertools
import pickle
import threading
import time
from typing import Any, Callable

_MISSING = object()

#: replies/serves at or above this many bytes are bounced off the cluster
#: select loop onto a side thread (mirrors the ``need`` backfill rule)
STATE_INLINE_MAX = 256 * 1024


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
# Wire value encoding (shared by the RPC client and the driver)
# --------------------------------------------------------------------------

def _wire_encode(value: Any):
    """Encode a value for a state message. Returns ``("b", blob)`` below the
    content-addressing threshold, else ``("r", digest, blob, nbytes)``.
    Uploads always carry their bytes (values change per commit); download
    dedup happens driver-side against the per-worker ``known`` set."""
    from .backends import transport
    from .backends.blobstore import PAYLOAD_REF_THRESHOLD, blob_digest
    blob = transport.encode_payload(value, int8=False)
    if len(blob) < PAYLOAD_REF_THRESHOLD:
        return ("b", blob)
    return ("r", blob_digest(blob), blob, len(blob))


def _wire_decode(payload, store=None, fetch_blob: "Callable | None" = None):
    """Decode a state value payload. ``store`` (worker side) lands ref
    blobs in the local :class:`BlobStore` so repeated large gets hit the
    decoded-object cache; ``fetch_blob(digest)`` recovers a ref whose
    bytes were omitted (sender believed we hold them) but evicted."""
    from .backends import transport
    if payload[0] == "b":
        value, _ = transport.decode_payload(payload[1])
        return value
    _, digest, blob, _nbytes = payload
    if store is not None:
        if blob is not None:
            store.put(digest, blob)
        elif digest not in store:
            if fetch_blob is None:
                raise StateError(
                    f"state blob {digest.hex()[:12]} was omitted but is "
                    f"not held locally")
            store.put(digest, fetch_blob(digest))
        return store.resolve(digest)
    if blob is None:
        from .backends.blobstore import DRIVER_STORE
        blob = DRIVER_STORE.get(digest)
        if blob is None:
            if fetch_blob is None:
                raise StateError(
                    f"state blob {digest.hex()[:12]} was omitted but is "
                    f"not in the driver store")
            blob = fetch_blob(digest)
    value, _ = transport.decode_payload(blob)
    return value


def oob(payload):
    """Socket-transport variant of a value payload: the blob travels as a
    protocol-5 out-of-band buffer (no concatenation copy; see frame codec
    2 in ``transport.py``). Pipe transports skip this."""
    if payload is not None and payload[0] == "r" and payload[2] is not None:
        blob = payload[2]
        if not isinstance(blob, pickle.PickleBuffer):
            return ("r", payload[1], pickle.PickleBuffer(blob), payload[3])
    return payload


# --------------------------------------------------------------------------
# The service
# --------------------------------------------------------------------------

class StateService:
    """Thread-safe versioned KV store + watch registry. Hosted in the
    driver process; the processes backend reaches it through
    :class:`PipeStateClient`, in-process backends call it directly."""

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
        #: key -> (version, digest, nbytes): lazily cached encoding of the
        #: current value, so serving the same large value to N workers
        #: costs one encode, not N
        self._enc: dict = {}
        self._digest_key: dict = {}

    # -- core ops (in-process surface) --------------------------------------

    def _commit_locked(self, key, value, enc=None):
        """Install ``value`` as the next version of ``key``; returns
        ``(version, satisfied_watches)``. Caller holds ``_lock`` and MUST
        fire the watches after releasing it."""
        version = self._versions.get(key, 0) + 1
        self._versions[key] = version
        self._values[key] = value
        old = self._enc.pop(key, None)
        if old is not None:
            self._digest_key.pop(old[1], None)
        if enc is not None:
            digest, nbytes = enc
            self._enc[key] = (version, digest, nbytes)
            self._digest_key[digest] = key
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
            enc = self._enc.pop(key, None)
            if enc is not None:
                self._digest_key.pop(enc[1], None)
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

    # -- wire surface (the processes driver) ---------------------------------

    def estimated_nbytes(self, key) -> int:
        """Cheap size estimate for the *current* value of ``key`` (a CUDA
        tensor is not copied to find it). 0 means "assume small"."""
        from .backends.blobstore import array_nbytes
        with self._lock:
            enc = self._enc.get(key)
            if enc is not None and enc[0] == self._versions.get(key, 0):
                return enc[2]
            value = self._values.get(key)
        return array_nbytes(value) or 0

    def reply_payload(self, key, value, version: int, known: "set | None"):
        """Build the wire payload for serving ``(key, value, version)`` to
        a peer whose held-digest set is ``known``. Returns ``(payload,
        digest)`` — the caller adds ``digest`` to ``known`` after a
        successful send. Encodes at most once per version per key (the
        encoding is cached; bytes live in ``DRIVER_STORE``)."""
        from .backends import transport
        from .backends.blobstore import (DRIVER_STORE, PAYLOAD_REF_THRESHOLD,
                                         blob_digest)
        digest = nbytes = blob = None
        with self._lock:
            enc = self._enc.get(key)
            if enc is not None and enc[0] == version:
                _v, digest, nbytes = enc
        if digest is None:
            blob = transport.encode_payload(value, int8=False)
            if len(blob) < PAYLOAD_REF_THRESHOLD:
                return ("b", blob), None
            digest, nbytes = blob_digest(blob), len(blob)
            DRIVER_STORE.put(digest, blob)
            with self._lock:
                if self._versions.get(key, 0) == version \
                        and key in self._values:
                    old = self._enc.pop(key, None)
                    if old is not None:
                        self._digest_key.pop(old[1], None)
                    self._enc[key] = (version, digest, nbytes)
                    self._digest_key[digest] = key
        if known is not None and digest in known:
            return ("r", digest, None, nbytes), digest
        if blob is None:
            blob = DRIVER_STORE.get(digest)
            if blob is None:
                blob = transport.encode_payload(value, int8=False)
                DRIVER_STORE.put(digest, blob)
        return ("r", digest, blob, nbytes), digest

    def blob_for(self, digest: bytes) -> bytes:
        """Serve the raw bytes behind a previously advertised state digest
        (the ``blob`` op: a receiver evicted them). Driver store first,
        else re-encode the live entry that digest names."""
        from .backends import transport
        from .backends.blobstore import DRIVER_STORE
        blob = DRIVER_STORE.get(digest)
        if blob is not None:
            return blob
        with self._lock:
            key = self._digest_key.get(digest)
            current = (key is not None and key in self._values
                       and self._enc.get(key, (None, None))[1] == digest)
            value = self._values.get(key) if current else None
        if not current:
            raise StateError(
                f"state blob {digest.hex()[:12]} is no longer current "
                f"(entry rewritten or deleted)")
        blob = transport.encode_payload(value, int8=False)
        DRIVER_STORE.put(digest, blob)
        return blob

    def handle(self, op: str, args: tuple, known: "set | None" = None):
        """Execute one non-blocking wire op. Returns ``(status, payload,
        sent_digest)`` with status ``"ok"`` or ``"err"`` — never raises
        (malformed ops are the *request's* failure, not the driver's).
        ``wait`` is not handled here: it blocks, so the driver routes it
        through a side thread."""
        try:
            if op == "get":
                key, min_version = args
                with self._lock:
                    self.counters["gets"] += 1
                    version = self._versions.get(key, 0)
                    present = key in self._values \
                        and version >= int(min_version)
                    value = self._values.get(key) if present else None
                if not present:
                    return "ok", (False, version, None), None
                payload, digest = self.reply_payload(key, value, version,
                                                     known)
                return "ok", (True, version, payload), digest
            if op == "put":
                key, vp = args
                value = _wire_decode(vp)
                enc = (bytes(vp[1]), vp[3]) if vp[0] == "r" else None
                if enc is not None:
                    from .backends.blobstore import DRIVER_STORE
                    if vp[2] is not None:
                        DRIVER_STORE.put(enc[0], vp[2])
                with self._lock:
                    self.counters["puts"] += 1
                    version, fired = self._commit_locked(key, value, enc)
                self._fire(fired, value, version)
                return "ok", version, None
            if op == "cas":
                key, expected, vp = args
                value = _wire_decode(vp)
                enc = (bytes(vp[1]), vp[3]) if vp[0] == "r" else None
                if enc is not None and vp[2] is not None:
                    from .backends.blobstore import DRIVER_STORE
                    DRIVER_STORE.put(enc[0], vp[2])
                with self._lock:
                    current_version = self._versions.get(key, 0)
                    if current_version == int(expected):
                        self.counters["cas_ok"] += 1
                        version, fired = self._commit_locked(key, value, enc)
                        committed = True
                    else:
                        self.counters["cas_fail"] += 1
                        committed = False
                        present = key in self._values
                        current = self._values.get(key)
                if committed:
                    self._fire(fired, value, version)
                    return "ok", (True, version, False, None), None
                if not present:
                    return "ok", (False, current_version, False, None), None
                payload, digest = self.reply_payload(
                    key, current, current_version, known)
                return "ok", (False, current_version, True, payload), digest
            if op == "add":
                key, vp = args
                delta, default = _wire_decode(vp)
                with self._lock:
                    self.counters["folds"] += 1
                    current = self._values.get(key, _MISSING)
                    value = (default if current is _MISSING
                             else current) + delta
                    version, fired = self._commit_locked(key, value)
                self._fire(fired, value, version)
                payload, digest = self.reply_payload(key, value, version,
                                                     known)
                return "ok", (version, payload), digest
            if op == "extend":
                key, vp = args
                length, version = self.extend(key, _wire_decode(vp))
                return "ok", (version, length), None
            if op == "delete":
                return "ok", self.delete(args[0]), None
            if op == "keys":
                return "ok", self.keys(args[0]), None
            if op == "version":
                return "ok", self.version(args[0]), None
            if op == "blob":
                return "ok", self.blob_for(args[0]), None
            return "err", _safe_exc(StateError(f"unknown state op {op!r}")), \
                None
        except Exception as exc:                          # noqa: BLE001
            return "err", _safe_exc(exc), None

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


class _RPCClient:
    """Request/decode logic of a client that reaches the driver's service
    over a channel. The transport subclass supplies ``_call(op, args,
    wait_timeout=None)`` returning the reply payload (raising on
    ``err``/``timeout``)."""

    def __init__(self, store=None):
        self._store = store
        self._rid = itertools.count(1)
        self.cas_retries = 0
        self._ops = 0

    # transport hook ---------------------------------------------------------
    def _call(self, op, args, wait_timeout=None):
        raise NotImplementedError

    def _fetch_blob(self, digest):
        blob = self._call("blob", (digest,))
        return bytes(blob) if not isinstance(blob, bytes) else blob

    def _decode(self, payload):
        return _wire_decode(payload, store=self._store,
                            fetch_blob=self._fetch_blob)

    # API --------------------------------------------------------------------
    def put(self, key, value) -> int:
        return self._call("put", (key, _wire_encode(value)))

    def read(self, key, default=_MISSING, min_version=0):
        found, version, payload = self._call("get", (key, int(min_version)))
        if not found:
            if default is _MISSING:
                raise KeyError(key)
            return default, version
        return self._decode(payload), version

    def get(self, key, default=_MISSING, min_version=0):
        return self.read(key, default, min_version)[0]

    def cas(self, key, expected_version, value):
        ok, version, present, cur = self._call(
            "cas", (key, int(expected_version), _wire_encode(value)))
        if ok:
            return True, version, None
        return False, version, (self._decode(cur) if present else None)

    def update(self, key, fn, default=None):
        """Client-side CAS retry loop — the linearizable read-modify-write.
        ``fn`` may run several times under contention; the commit history
        is still the exact sequential fold."""
        value, version = self.read(key, default=default)
        while True:
            new = fn(value)
            ok, version2, cur = self.cas(key, version, new)
            if ok:
                return new, version2
            self.cas_retries += 1
            if cur is not None:
                value, version = cur, version2
            elif version2 == 0:
                # concurrently deleted: fold restarts from the default
                value, version = default, version2
            else:
                # version moved but no value came back: read() settles it
                value, version = self.read(key, default=default)

    def add(self, key, delta, default=0):
        """Server-side atomic ``(current or default) + delta`` — one RPC,
        exact under any contention (no CAS retry loop)."""
        version, payload = self._call(
            "add", (key, _wire_encode((delta, default))))
        return self._decode(payload), version

    def extend(self, key, items):
        """Server-side atomic list append; ``(new_length, version)``."""
        version, length = self._call(
            "extend", (key, _wire_encode(list(items))))
        return length, version

    def delete(self, key) -> bool:
        return self._call("delete", (key,))

    def wait(self, key, min_version=1, timeout=None):
        version, payload = self._call(
            "wait", (key, int(min_version), timeout), wait_timeout=timeout)
        return self._decode(payload), version

    async def wait_async(self, key, min_version=1, timeout=None):
        """Awaitable wait over the wire: the blocking RPC is parked on a
        worker thread so the caller's event loop stays live."""
        import asyncio
        return await asyncio.to_thread(self.wait, key, min_version, timeout)

    def keys(self, prefix=""):
        return self._call("keys", (prefix,))

    def version(self, key) -> int:
        return self._call("version", (key,))

    def stats(self) -> dict:
        return {"cas_retries": self.cas_retries, "ops": self._ops}


class SockStateClient(_RPCClient):
    """Cluster-worker client: sends ``("state", rid, op, args)`` frames on
    the control socket; the worker's dedicated *reader thread* routes the
    matching ``("state_rep", rid, status, payload)`` into a per-request
    wait slot (the main thread is inside user code, blocked right here).
    Connection loss fails every outstanding call with the reader's
    exception."""

    def __init__(self, sock, send_lock, store):
        super().__init__(store=store)
        self._sock = sock
        self._send_lock = send_lock
        self._lock = threading.Lock()
        self._waits: dict = {}                  # rid -> [Event, reply|None]
        self._down: "BaseException | None" = None

    def deliver(self, msg) -> None:
        """Reader-thread entry: hand one state_rep to its waiter."""
        with self._lock:
            entry = self._waits.pop(msg[1], None)
        if entry is not None:
            entry[1] = (msg[2], msg[3])
            entry[0].set()

    def fail_all(self, exc: BaseException) -> None:
        """Reader-thread entry on connection loss: every blocked state
        call raises (the task fails cleanly via its error run)."""
        with self._lock:
            self._down = exc
            entries, self._waits = list(self._waits.values()), {}
        for entry in entries:
            entry[0].set()

    def _call(self, op, args, wait_timeout=None):
        from .backends.transport import send_frame
        if self._down is not None:
            raise StateError(f"state service unreachable: {self._down!r}")
        rid = next(self._rid)
        self._ops += 1
        entry = [threading.Event(), None]
        with self._lock:
            self._waits[rid] = entry
        if op in ("put", "cas", "add", "extend"):
            args = args[:-1] + (oob(args[-1]),)
        try:
            send_frame(self._sock, ("state", rid, op, args), self._send_lock)
        except OSError as exc:
            with self._lock:
                self._waits.pop(rid, None)
            raise StateError(f"state send failed: {exc!r}") from exc
        # no local deadline beyond the op's own: driver death reaches us
        # through the reader's EOF -> fail_all; a wait op gets its
        # server-side timeout plus generous slack for the reply to travel
        budget = None if wait_timeout is None else wait_timeout + 60.0
        if not entry[0].wait(budget):
            with self._lock:
                self._waits.pop(rid, None)
            raise StateTimeout(f"state {op} reply never arrived "
                               f"(waited {budget}s)")
        if entry[1] is None:
            raise StateError(
                f"state service unreachable: {self._down!r}")
        status, payload = entry[1]
        if status == "timeout":
            raise StateTimeout(
                f"state.wait({args[0]!r}, min_version={args[1]}) timed out "
                f"after {args[2]}s")
        if status == "err":
            raise payload if isinstance(payload, Exception) \
                else StateError(repr(payload))
        return payload


class PipeStateClient(_RPCClient):
    """Processes-worker client: state ops ride the task pipe. The worker's
    main thread both sends the request and pumps the pipe for the reply —
    it is the only reader, and it is only ever here while inside user
    code, so nothing else is draining the pipe concurrently. Non-reply
    messages encountered mid-wait (a racing ``stop``) abort the call."""

    def __init__(self, conn, store=None):
        super().__init__(store=store)
        self._conn = conn

    def _call(self, op, args, wait_timeout=None):
        rid = next(self._rid)
        self._ops += 1
        try:
            self._conn.send(("state", rid, op, args))
        except (OSError, ValueError) as exc:
            raise StateError(f"state send failed: {exc!r}") from exc
        while True:
            try:
                msg = self._conn.recv()
            except (EOFError, OSError) as exc:
                raise StateError(
                    f"state service unreachable: {exc!r}") from exc
            if msg[0] == "state_rep" and msg[1] == rid:
                status, payload = msg[2], msg[3]
                if status == "timeout":
                    raise StateTimeout(
                        f"state.wait({args[0]!r}) timed out after "
                        f"{args[2]}s")
                if status == "err":
                    raise payload if isinstance(payload, Exception) \
                        else StateError(repr(payload))
                return payload
            if msg[0] == "stop":
                raise StateError("backend stopped mid state op")
            # anything else (a stray late message) is dropped: the parent
            # serializes per-worker traffic, so task messages cannot arrive
            # while this worker is still executing the current task


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
    "SockStateClient", "PipeStateClient", "service", "reset",
    "set_default_client",
    "put", "get", "read", "cas", "update", "add", "extend", "delete",
    "wait", "wait_async", "keys", "version", "stats",
    "scoped_key", "scope_args",
]
