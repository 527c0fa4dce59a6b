"""plan("cluster"): resolve futures on workers connected over TCP sockets.

The paper's ``makeClusterPSOCK`` analogue: a driver that listens on a TCP
socket and a fleet of worker processes that dial in — *launched by the
backend itself* through the launcher subsystem (``launchers.py``): local
subprocesses by default, ssh or an arbitrary scheduler command template
for multi-host runs, or hand-launched anywhere with network reach
(``launcher="external"``)::

    python -m repro_torch.core.backends.cluster_worker DRIVER_HOST:PORT

The workers speak the shipped-blob protocol of the processes backend (the
content-addressed blob store, the payload codec, ``worker.execute_shipped``
and ``ensure_refs``) over sockets instead of pipes; frames are pickled by
the shipping pickler, so a tensor crosses as its bytes and a worker on the
card computes with its own CUDA context.

Spec kwargs (``plan("cluster", ...)`` / ``spec("cluster", ...)``):

* ``workers=N`` — launch N local worker processes that connect back over
  127.0.0.1 (default: ``available_cores()``).
* ``hosts=N`` or ``hosts=("nodeA", "nodeB")`` — where workers run. An int
  launches that many via :class:`~.launchers.LocalLauncher`; named hosts
  default to :class:`~.launchers.SSHLauncher` (the paper's
  ``makeClusterPSOCK`` default).
* ``launcher=`` — who bootstraps the workers: a
  :class:`~.launchers.Launcher` instance, ``"local"``, ``"ssh"``, a
  ``CommandLauncher`` template string containing ``{driver}`` (SLURM/k8s as
  config), or ``"external"`` to spawn nothing — ``backend.address`` is the
  ``(host, port)`` to hand hand-launched workers; ``wait_for_workers()``
  blocks until they arrive.
* ``bind="0.0.0.0"``, ``port=0`` — listener address (loopback + ephemeral
  port by default; bind ``0.0.0.0`` for real multi-host runs), and
  ``advertise=`` — the hostname remote launched workers dial (default: the
  machine's hostname when bound to 0.0.0.0).
* ``connect_timeout=60`` — seconds to wait for the expected worker count.
* ``heartbeat_interval=1.0`` / ``heartbeat_timeout=10.0`` — liveness:
  workers push a heartbeat frame every interval; one silent for longer than
  the timeout is declared dead (set ``heartbeat_timeout=0`` to disable).
* ``relaunch_backoff=0.1`` / ``relaunch_backoff_cap=5.0`` /
  ``relaunch_reset_after=30.0`` — relaunch policy for launched workers
  (see below).
* ``blob_store_bytes=`` — each worker's blob store bound.
* ``token=`` — shared-secret authentication: every dialing socket must
  pass the HMAC preamble (``transport.serve_auth``) **before any frame is
  decoded**; default is ``$REPRO_CLUSTER_TOKEN`` (empty = open listener).
  Launched workers inherit the credential via their environment;
  hand-launched ones take ``--token``.
* ``tls=`` — transport encryption: a :class:`~.transport.TLSConfig`
  (cert/key for the listener, optional CA pin for dialers) or ``True`` to
  generate an ephemeral self-signed cert (needs the ``openssl`` binary).
  The driver listener, worker dials, and the worker-to-worker peer-fetch
  servers all wrap in TLS; the cert/key PEM material and a per-backend
  random peer secret ride to workers inside the (already authenticated)
  ``init`` frame.

Not in the port yet, and refused by name: the reference's tenant scheduler
(``tenants=``, for the serving tier) and its lineage reconstruction and
proactive replication (``min_replicas=``, ``lineage_max_depth=``,
``lineage_max_attempts=``, ``lineage_keep=``); ``ROADMAP.md`` names the
slices that bring them.

Worker-to-worker dataflow (locality scheduling + the location map): a task
dispatched with ``keep`` parks any large result in the producing worker's
blob store and answers with ``run.value = PayloadRef(digest)`` plus a
``held`` manifest; the driver records ``digest -> {holder wids}`` in its
location map and surfaces the value as a lazy
:class:`~.blobstore.RemoteValue`. A continuation chained onto such a future
ships the *digest* back out (``TaskSpec.affinity`` names it) and
``submit``/``try_submit`` prefer an idle worker already holding it — the
holder receives a ~500 B control frame instead of the multi-MB value. When
locality is impossible (holder busy or dead, cross-worker ``gather``), the
task frame carries per-digest peer addresses (``hints``) from the location
map and the assigned worker fetches the blob worker-to-worker over the
``fetch``/``offer``/``onak`` frames; a peer that cannot serve (partitioned,
evicted) degrades to the ordinary ``("need", digest)`` driver fallback, for
which the driver itself pulls the blob from a live holder over the same
fetch protocol (results are content-addressed, so every copy is
self-validating). ``Future.value()`` triggers an explicit driver pull via
:meth:`ClusterBackend.pull_value`. ``remote_results=False`` disables the
whole mechanism (results always travel inline). The location map lives on
the backend object, so warm-pool re-attach (``planning._WARM_POOL``)
preserves it across ``plan()`` swaps.

A held result whose every copy is gone — its only holder died, or it was
evicted everywhere — cannot be rebuilt in the port (no lineage is
recorded): wherever the reference would re-execute the producing task
(``_reconstruct``), the dependent pull or dispatch fails with
:class:`LineageExhaustedError`, the reference's own behaviour when no
lineage is recorded for the digest.

Wire protocol (tags on a cluster connection):

  worker -> driver : ("hello", meta)       handshake; meta = {"pid", "host"
                                           [, "tag", "peer"]}
                     ("hb",)               heartbeat (liveness only)
                     ("bye", reason)       deliberate exit (--max-idle-s)
                     ("progress", task_id, cond)    live ImmediateCondition
                     ("result", task_id, run[, held])  CapturedRun; held =
                                           ((digest, nbytes), ...) of result
                                           blobs parked worker-resident
                     ("need", digest)      blob-store backfill request
                     ("state", rid, op, args)   shared-state op (state.py)
                     ("offer", digest, blob) / ("onak", digest)   answer to
                                           a driver-side fetch
  driver -> worker : ("init", nested_blob, seed, hb_interval_s, extras)
                     ("put", digest, blob)          content-addressed payload
                     ("task", task_id, blob, refs, hints, keep)
                     ("nak", digest)       driver cannot serve the digest
                     ("state_rep", rid, status, payload)
                     ("fetch", digest)     send me this blob
                     ("evict", digest)     the last RemoteValue handle for
                                           this result died at the driver
                     ("stop",)

Two lanes ride the same control socket besides tasks and blobs: the
*shared-state* lane (``state``/``state_rep`` frames — task bodies calling
``repro_torch.core.state`` reach the driver-hosted
:class:`~..state.StateService`; small ops are answered inline on the select
loop, large values and ``wait`` notifications from side threads) and the
*GC* lane (``("evict", digest)`` — when the last :class:`RemoteValue`
handle for a worker-resident result is garbage-collected at the driver,
holders are told to drop the bytes instead of waiting for LRU pressure).

Fault model: EOF / reset / heartbeat loss on a busy worker surfaces as
:class:`WorkerDiedError` on that future, and the driver — which **owns**
every launched :class:`~.launchers.WorkerProc` — relaunches a replacement
on the same host through the same launcher, with capped exponential
backoff (``relaunch_backoff`` doubling to ``relaunch_backoff_cap``; a
worker that survived ``relaunch_reset_after`` seconds resets its host's
backoff). A launched worker that dies *before its first hello* is a
misconfiguration, not churn: its slot is not relaunched, and its captured
stderr is quoted in the startup error. Externally-launched capacity just
shrinks until the operator relaunches. ``shutdown()`` reaps every launched
process — no orphans. Everything is select-driven — one driver thread
multiplexes every worker socket — so ``Backend.wait()`` is a genuine event
wait, never a poll loop, and completion is *pushed*: ``add_done_callback``
continuations fire straight from the select loop the moment a result frame
lands.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import pickle
import selectors
import socket
import threading
import time
import weakref
from typing import Any

from ..conditions import CapturedRun, ImmediateCondition
from ..errors import (ChannelError, FutureCancelledError, FutureError,
                      LineageExhaustedError, WorkerDiedError)
from .. import planning as plan_mod
from .base import (Backend, CompletionHandle, EventWaitMixin, TaskSpec,
                   register_backend)
from .blobstore import (DRIVER_STORE, PayloadRef, RemoteValue,
                        encode_backfill)
from .launchers import WorkerProc, resolve_launcher
from .transport import (FrameReader, TLSConfig, generate_self_signed_cert,
                        send_frame, serve_auth, server_tls_context)

#: pre-hello launch failures retained for error messages
_LAUNCH_FAILURES_KEEP = 8

#: the reference's kwargs that come with later slices of the port, and the
#: ROADMAP.md item that brings each
_LATER = {
    "tenants": "the tenant scheduler, with the core/serving/ item",
    "min_replicas": "slice 18: lineage reconstruction and min_replicas "
                    "replication",
    "lineage_max_depth": "slice 18: lineage reconstruction and "
                         "min_replicas replication",
    "lineage_max_attempts": "slice 18: lineage reconstruction and "
                            "min_replicas replication",
    "lineage_keep": "slice 18: lineage reconstruction and min_replicas "
                    "replication",
}


def _refuse_later(kwargs) -> None:
    """Refuse, by name, a kwarg of the reference that the port does not
    have yet (a TypeError, as for any other unknown kwarg)."""
    for name in kwargs:
        if name in _LATER:
            raise TypeError(
                f"plan('cluster', {name}=...) is not in the port yet: it "
                f"comes with ROADMAP.md's {_LATER[name]}")
    if kwargs:
        raise TypeError(f"unexpected cluster kwargs: {sorted(kwargs)}")


class _Handle(CompletionHandle):
    def __init__(self, task: TaskSpec):
        super().__init__()
        self.task = task
        self.run: CapturedRun | None = None
        self.error: Exception | None = None          # infrastructure error
        self.immediate: list[ImmediateCondition] = []
        self.ilock = threading.Lock()
        self.worker: "_SockWorker | None" = None
        self.cancelled = False
        # digest -> PayloadSource, pinned while in flight so ("need", digest)
        # backfills can always be served
        self.sources: dict = task.payload_sources
        #: the DRIVER_STORE pin of the sources' encoded blobs while in
        #: flight (a need is served without encoding a payload again)
        self.pin = None


def _queue_release(backend_ref, digest: bytes) -> None:
    """RemoteValue finalizer target (module-level so the finalizer holds
    no strong backend reference). Never sends frames — a finalizer can
    fire during GC on *any* thread, possibly one already holding a send
    lock; it only flips the refcount and queues the digest for the select
    loop's ``_service_releases``."""
    be = backend_ref()
    if be is None or not be._open:
        return
    with be._release_lock:
        n = be._rv_refs.get(digest, 0) - 1
        if n > 0:
            be._rv_refs[digest] = n
            return
        be._rv_refs.pop(digest, None)
        be._pending_releases.append(digest)
    try:
        os.write(be._wake_w, b"g")           # service promptly, not at tick
    except (OSError, ValueError):
        pass


class _SockWorker:
    """Driver-side state for one connected worker socket."""

    def __init__(self, wid: int, sock: socket.socket, addr):
        self.wid = wid
        self.sock: socket.socket | None = sock
        self.addr = addr
        self.reader = FrameReader(sock)
        self.send_lock = threading.Lock()
        #: payload digests this worker is believed to hold (guarded by
        #: send_lock; its LRU may still evict them -> ("need", d) backfill).
        #: A replacement worker starts with a fresh, empty set: cold cache.
        self.known: set[bytes] = set()
        self.busy: _Handle | None = None
        self.ready = False                 # hello received
        self.retired = False               # deliberate down-scale, not a death
        self.meta: dict = {}
        self.proc: WorkerProc | None = None          # driver-launched only
        self.hello_at: "float | None" = None
        self.last_seen = time.monotonic()
        #: arrival of the last heartbeat, and the longest gap between two
        #: (diagnostics: a task that holds the worker's GIL delays them)
        self.last_hb: "float | None" = None
        self.max_hb_gap = 0.0
        #: bytes of ``put`` frames sent to this worker, and the seconds
        #: their sends took (diagnostics)
        self.put_bytes = 0
        self.put_seconds = 0.0

    def put(self, digest: bytes, blob) -> None:
        """Send one content-addressed payload. The blob rides the frame
        out-of-band: handed to sendmsg as is (no copy into the frame, and
        never zlib'd a second time)."""
        t0 = time.perf_counter()
        self.put_bytes += send_frame(
            self.sock, ("put", digest, pickle.PickleBuffer(blob)),
            self.send_lock)
        self.put_seconds += time.perf_counter() - t0
        self.known.add(digest)

    def describe(self) -> str:
        host = self.meta.get("host", self.addr[0] if self.addr else "?")
        return f"worker {self.wid} ({host} pid={self.meta.get('pid', '?')})"

    def close(self) -> None:
        sock, self.sock = self.sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


@register_backend("cluster")
class ClusterBackend(EventWaitMixin, Backend):
    """TCP socket cluster: select-driven driver + connect-back workers."""

    supports_immediate = True
    #: the Future layer may route continuations on RemoteValue parents back
    #: through this backend (locality-scheduled chains)
    remote_chains = True

    def __init__(self, workers: int | None = None,
                 hosts: "int | tuple | list | None" = None,
                 launcher: Any = None,
                 bind: str = "127.0.0.1", port: int = 0,
                 advertise: "str | None" = None,
                 connect_timeout: float = 60.0,
                 heartbeat_interval: float = 1.0,
                 heartbeat_timeout: float = 10.0,
                 relaunch_backoff: float = 0.1,
                 relaunch_backoff_cap: float = 5.0,
                 relaunch_reset_after: float = 30.0,
                 blob_store_bytes: "int | None" = None,
                 remote_results: bool = True,
                 token: "str | None" = None,
                 tls: "TLSConfig | bool | None" = None,
                 **later):
        _refuse_later(later)
        self._blob_store_bytes = blob_store_bytes
        #: keep large results worker-resident (RemoteValue dataflow); False
        #: restores the pre-dataflow wire shape: every result travels inline
        self._remote_results = bool(remote_results)
        self._hb_interval = float(heartbeat_interval or 0.0)
        # no heartbeats flowing -> a liveness deadline would falsely kill
        # every quiet worker; either knob at 0 disables the check
        self._hb_timeout = float(heartbeat_timeout or 0.0) \
            if self._hb_interval else 0.0
        self._connect_timeout = float(connect_timeout)
        if hosts is None:
            self._n = int(workers) if workers else plan_mod.available_cores()
            self._hosts = ("127.0.0.1",) * self._n
        elif isinstance(hosts, int):
            self._n = hosts
            self._hosts = ("127.0.0.1",) * self._n
        else:
            self._hosts = tuple(hosts)
            self._n = len(self._hosts)
        #: who bootstraps workers; None = external (hand-launched) capacity
        self._launcher = resolve_launcher(launcher, hosts)
        self._relaunch_backoff = max(float(relaunch_backoff), 0.0)
        self._relaunch_cap = max(float(relaunch_backoff_cap),
                                 self._relaunch_backoff)
        self._relaunch_reset_after = float(relaunch_reset_after)
        self._nested_blob = pickle.dumps(plan_mod.nested_stack())
        from .. import rng as rng_mod
        self._session_seed = rng_mod._session_seed

        self._pool_cv = threading.Condition()
        self._init_wait()
        self._all: list[_SockWorker] = []      # connected workers (pool_cv)
        self._idle: list[_SockWorker] = []
        self._pending: list[WorkerProc] = []   # launched, not yet hello
        #: expired detached-bootstrap records — a late hello matching one
        #: restores the capacity slot that was written off at expiry
        self._expired: "collections.deque[WorkerProc]" = \
            collections.deque(maxlen=8)
        self._launch_failures: list[str] = []  # pre-hello deaths (stderr)
        self._backoff: dict[str, float] = {}   # host -> next relaunch delay
        self._relaunch_q: list[tuple[float, str]] = []   # (deadline, host)
        #: delays actually scheduled, oldest first (tests/diagnostics;
        #: bounded like _launch_failures so a weeks-long flapping host
        #: cannot grow it without limit)
        self._relaunch_log: "collections.deque[float]" = \
            collections.deque(maxlen=256)
        self._capacity = self._n               # live-or-expected worker count
        self._shrink_debt = 0
        # -- worker-to-worker dataflow state (guarded by _pool_cv) --
        #: digest -> set of wids currently holding that result blob
        self._locations: dict[bytes, set] = {}
        #: digests whose *last* holder died with no driver copy: dependent
        #: dispatches/pulls fail fast, quoting the holder (bounded memory)
        self._lost: "collections.OrderedDict[bytes, str]" = \
            collections.OrderedDict()
        # -- driver-side fetch waits (guarded by _fetch_lock, NOT _pool_cv:
        # offers land on the select loop, which must never need _pool_cv
        # held by a blocked puller) --
        self._fetch_lock = threading.Lock()
        #: (wid, digest) -> [(event, result_slot), ...]
        self._fetch_waits: dict = {}
        self._fetch_timeout = max(30.0, self._hb_timeout * 3.0) \
            if self._hb_timeout else 60.0
        # -- driver-side GC of worker-resident blobs: RemoteValue handles
        # are refcounted per digest; when the last one is collected its
        # finalizer queues the digest here and the select loop sends
        # ("evict", digest) to the holders. RLock: a finalizer can run at
        # any allocation, including while this thread already holds it.
        self._release_lock = threading.RLock()
        self._rv_refs: dict[bytes, int] = {}
        self._pending_releases: list[bytes] = []
        self._open = True
        self._cleaned = False
        self._cleanup_lock = threading.Lock()
        self._wid = itertools.count()
        # `or`: hosts=() still leaves resize() a host to grow onto
        self._host_iter = itertools.cycle(self._hosts or ("127.0.0.1",))
        self._tag_seq = itertools.count()
        self._tag_base = os.urandom(4).hex()

        # -- transport security: shared token + optional TLS ----------------
        self._token = token if token is not None \
            else os.environ.get("REPRO_CLUSTER_TOKEN", "")
        if tls is True:
            import tempfile
            tls = generate_self_signed_cert(
                tempfile.mkdtemp(prefix="repro-tls-"))
        self._tls: "TLSConfig | None" = tls or None
        self._tls_ctx = server_tls_context(self._tls) \
            if self._tls is not None else None
        self._secured = bool(self._token) or self._tls is not None
        #: credentials the workers' peer-fetch servers enforce, shipped in
        #: the init frame over the already-authenticated control channel
        self._peer_secret = os.urandom(16).hex() if self._secured else ""
        self._init_extras: dict = {"blob_store_bytes": blob_store_bytes}
        if self._peer_secret:
            self._init_extras["peer_secret"] = self._peer_secret
        if self._tls is not None:
            with open(self._tls.certfile, "rb") as f:
                cert_pem = f.read()
            with open(self._tls.keyfile or self._tls.certfile, "rb") as f:
                key_pem = f.read()
            self._init_extras["tls_material"] = (cert_pem, key_pem)
        #: authenticated-but-unregistered connections handed from the
        #: handshake threads to the select loop (guarded by _pool_cv)
        self._joiners: list[_SockWorker] = []

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((bind, int(port)))
        self._listener.listen(128)
        #: (host, port) that workers dial; hand this to cluster_worker
        self.address = self._listener.getsockname()[:2]
        self._connect_back = ("127.0.0.1" if bind in ("0.0.0.0", "")
                              else bind, self.address[1])
        #: what *remote* launched workers dial (ssh/scheduler bootstrap)
        self._advertise = (advertise
                           or (socket.gethostname()
                               if bind in ("0.0.0.0", "") else bind),
                           self.address[1])

        self._wake_r, self._wake_w = os.pipe()
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, "listen")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._loop_thread = threading.Thread(
            target=self._loop, name="cluster-driver", daemon=True)
        self._loop_thread.start()

        if self._launcher is not None:
            for _ in range(self._n):
                self._launch_worker(next(self._host_iter))
            self.wait_for_workers(self._n, timeout=self._connect_timeout)

    # -- pool management ----------------------------------------------------

    def _launch_worker(self, host: str, *, relaunch: bool = False) -> None:
        """Bootstrap one connect-back worker on ``host`` via the launcher.

        ``relaunch`` marks self-heal replacements: their failures re-queue
        with ramping backoff (a transient host outage must not burn the
        slot), whereas a *startup* launch failure is a misconfiguration
        and fails fast with the captured stderr."""
        launcher = self._launcher
        assert launcher is not None
        tag = f"{self._tag_base}-{next(self._tag_seq)}"
        local_only = getattr(launcher, "local_only", False)
        addr = self._connect_back if local_only else self._advertise
        if not local_only \
                and host not in ("127.0.0.1", "localhost", "") \
                and addr[0] in ("127.0.0.1", "localhost") \
                and not getattr(launcher, "reverse_tunnel", False):
            # a remote worker told to dial the driver's loopback will hang
            # until connect_timeout with no hint why — say so up front.
            # (Best-effort: hosts=N keeps placeholder loopback host names,
            # so a remote scheduler template with hosts=N still needs the
            # documented bind='0.0.0.0' — see examples/cluster_faults.py.)
            import warnings
            warnings.warn(
                f"launching a worker on {host!r} that will dial the "
                f"driver's loopback address {addr[0]}:{addr[1]}; bind a "
                f"reachable interface (bind='0.0.0.0' [+ advertise=]) or "
                f"use SSHLauncher(reverse_tunnel=True)", RuntimeWarning,
                stacklevel=2)
        extra_env = []
        if self._token:
            extra_env.append(("REPRO_CLUSTER_TOKEN", self._token))
        if self._tls is not None:
            extra_env.append(("REPRO_CLUSTER_TLS", "1"))
            if local_only and self._tls.cafile:
                # the CA pin is a local file path — only forwardable to
                # workers sharing this filesystem; remote dials still
                # encrypt + token-auth, just without cert verification
                extra_env.append(("REPRO_CLUSTER_TLS_CA", self._tls.cafile))
        try:
            if extra_env:
                wp = launcher.launch(host, addr, tag=tag,
                                     extra_env=tuple(extra_env))
            else:
                wp = launcher.launch(host, addr, tag=tag)
        except Exception as exc:                 # noqa: BLE001
            with self._pool_cv:
                if not relaunch:
                    self._capacity -= 1
                self._note_launch_failure_locked(
                    f"launcher {launcher.describe()} failed on host "
                    f"{host!r}: {exc!r}")
                self._pool_cv.notify_all()
            if relaunch:
                self._queue_relaunch(host, lifetime=0.0)
            return
        wp.is_relaunch = relaunch
        with self._pool_cv:
            self._pending.append(wp)

    def _note_launch_failure_locked(self, msg: str) -> None:
        self._launch_failures.append(msg)
        del self._launch_failures[:-_LAUNCH_FAILURES_KEEP]

    def wait_for_workers(self, n: "int | None" = None,
                         timeout: "float | None" = None) -> None:
        """Block until ``n`` workers (default: all expected) are connected
        and handshaken; raise ChannelError on timeout or startup failure."""
        n = self._n if n is None else n
        timeout = self._connect_timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        with self._pool_cv:
            while True:
                ready = sum(1 for w in self._all
                            if w.ready and w.sock is not None)
                if ready >= n:
                    return
                if self._capacity < n:
                    break
                if time.monotonic() > deadline:
                    break
                self._pool_cv.wait(0.1)
        with self._pool_cv:
            failures = list(self._launch_failures)
        self.shutdown()
        msg = (f"cluster startup failed: {ready}/{n} workers connected "
               f"within {timeout}s (capacity={self._capacity})")
        if failures:
            msg += ("; worker launch failures:\n  "
                    + "\n  ".join(failures))
        raise ChannelError(msg)

    def _pick_idle_locked(self, prefer) -> "_SockWorker | None":
        """Pop one live idle worker, preferring wids in ``prefer`` (locality
        scheduling: an idle holder of the task's affinity digests beats any
        other idle worker). Caller holds ``_pool_cv``."""
        if prefer:
            for w in reversed(self._idle):
                if w.wid in prefer and w.sock is not None:
                    self._idle.remove(w)
                    return w
        while self._idle:
            w = self._idle.pop()
            if w.sock is not None:
                return w
        return None

    def _checkout(self, prefer=frozenset()) -> _SockWorker:
        """Blocking acquire of an idle worker (paper: future() blocks until
        a worker frees up). ``prefer`` biases towards affinity holders."""
        with self._pool_cv:
            while True:
                w = self._pick_idle_locked(prefer)
                if w is not None:
                    return w
                if not self._open:
                    raise ChannelError("cluster backend is shut down")
                if self._capacity <= 0:
                    raise ChannelError(
                        "no live cluster workers (all died and none were "
                        "respawnable)")
                self._pool_cv.wait(0.5)

    def _try_checkout(self, prefer=frozenset()) -> "_SockWorker | None":
        """Non-blocking acquire for the admission protocol: an idle live
        worker or None — never waits for capacity. Relaunch-pending slots
        are absent by construction (they are not in the idle set until
        their replacement says hello)."""
        with self._pool_cv:
            if not self._open:
                raise ChannelError("cluster backend is shut down")
            return self._pick_idle_locked(prefer)

    def _holders(self, digests) -> frozenset:
        """Wids currently holding any of ``digests`` (affinity -> prefer)."""
        if not digests:
            return frozenset()
        with self._pool_cv:
            out: set = set()
            for d in digests:
                out |= self._locations.get(d, set())
            return frozenset(out)

    def _note_location_locked(self, digest: bytes, wid: int) -> None:
        self._locations.setdefault(digest, set()).add(wid)
        self._lost.pop(digest, None)         # re-held (e.g. re-executed)

    def _drop_location(self, digest: bytes, wid: int) -> None:
        with self._pool_cv:
            wids = self._locations.get(digest)
            if wids is not None:
                wids.discard(wid)
                if not wids:
                    self._locations.pop(digest, None)

    def locations(self, digest: bytes) -> frozenset:
        """Wids believed to hold ``digest`` (diagnostics/tests)."""
        with self._pool_cv:
            return frozenset(self._locations.get(digest, ()))

    def free_slots(self) -> int:
        """Live idle workers, i.e. dispatches that would not block right
        now. A dead-but-unreaped socket in the idle set does not count; a
        slot awaiting its relaunched worker does not count either."""
        with self._pool_cv:
            return sum(1 for w in self._idle if w.sock is not None)

    def resize(self, workers: int) -> None:
        """Elastic scaling: grow by launching connect-back workers (round-
        robin over the host list; external mode just raises the expected
        count), shrink by retiring idle ones (busy workers retire as they
        finish). Launcher-owned pools resize against *live* capacity, so
        resizing to the current nominal count regrows slots lost to idle
        exits or burned launches."""
        with self._pool_cv:
            delta = workers - self._n
            self._n = workers
            if self._launcher is not None:
                grow = max(workers - self._capacity, 0)
                shrink = max(self._capacity - workers, 0)
            else:
                grow, shrink = max(delta, 0), max(-delta, 0)
            self._capacity += grow
            self._shrink_debt += shrink
            to_retire = []
            while self._shrink_debt > 0 and self._idle:
                to_retire.append(self._idle.pop())
                self._shrink_debt -= 1
        if self._launcher is not None:
            for _ in range(grow):
                self._launch_worker(next(self._host_iter))
        for w in to_retire:
            self._retire(w)
        # Growth is best-effort: new workers join the idle pool as they
        # connect, and submit() blocks until then. Deliberately NOT
        # wait_for_workers() here — its timeout path tears down the whole
        # backend, which would turn one slow replacement into total loss
        # of the in-flight work.

    def _retire(self, w: _SockWorker) -> None:
        """Deliberately shed one worker (down-scale, not a fault)."""
        w.retired = True
        with self._pool_cv:
            self._capacity -= 1
        try:
            if w.sock is not None:
                send_frame(w.sock, ("stop",), w.send_lock)
                w.sock.shutdown(socket.SHUT_RDWR)   # loop reaps it via EOF
        except OSError:
            pass

    # -- select-driven driver loop -----------------------------------------

    def _loop(self) -> None:
        tick = max(0.05, min(self._hb_timeout / 4.0, 1.0)) \
            if self._hb_timeout else 1.0
        while True:
            try:
                timeout = tick
                # unlocked emptiness hint keeps the hot path lock-free;
                # _schedule_relaunch writes the wake pipe, so a just-queued
                # relaunch re-arms the timeout on the next iteration anyway
                if self._relaunch_q:
                    with self._pool_cv:
                        if self._relaunch_q:
                            due = min(dl for dl, _ in self._relaunch_q)
                            timeout = min(tick, max(0.01,
                                                    due - time.monotonic()))
                events = self._sel.select(timeout=timeout)
                if not self._open:
                    break
                for key, _mask in events:
                    data = key.data
                    if data == "listen":
                        self._accept()
                    elif data == "wake":
                        try:
                            os.read(self._wake_r, 4096)
                        except OSError:
                            pass
                    else:
                        self._pump(data)
                self._service_joiners()
                self._service_relaunches()
                self._service_releases()
                self._service_state_timeouts()
                self._reap_and_check()
            except Exception:                        # noqa: BLE001
                # The driver thread is a singleton: an escaped exception
                # here would wedge every pending future with no error.
                # Report and keep multiplexing.
                import traceback
                traceback.print_exc()
        self._cleanup()

    def _accept(self) -> None:
        try:
            conn, addr = self._listener.accept()
        except OSError:
            return
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._secured:
            # TLS + auth handshakes block (and must be able to *time out*
            # on a silent or plaintext dialer) — never on the select loop,
            # where they would stall every worker's heartbeats. A short-
            # lived side thread negotiates, then hands the authenticated
            # connection back through _joiners + the wake pipe.
            threading.Thread(target=self._handshake_accept,
                             args=(conn, addr), name="cluster-handshake",
                             daemon=True).start()
            return
        w = _SockWorker(next(self._wid), conn, addr)
        try:
            send_frame(conn, ("init", self._nested_blob, self._session_seed,
                              self._hb_interval, self._init_extras),
                       w.send_lock)
        except OSError:
            w.close()
            return
        self._sel.register(conn, selectors.EVENT_READ, w)
        with self._pool_cv:
            self._all.append(w)

    def _handshake_accept(self, conn, addr) -> None:
        """Side-thread TLS + token negotiation for one inbound connection.
        Any failure — bad token, plaintext bytes on a TLS listener, a
        dialer that never speaks — closes the socket within the auth
        timeout; nothing it sent is ever decoded as a frame."""
        from .transport import AUTH_TIMEOUT_S
        try:
            conn.settimeout(AUTH_TIMEOUT_S)
            if self._tls_ctx is not None:
                conn = self._tls_ctx.wrap_socket(conn, server_side=True)
            if self._token:
                serve_auth(conn, {"cluster": self._token})
            conn.settimeout(None)
        except Exception:                            # noqa: BLE001
            try:
                conn.close()
            except OSError:
                pass
            return
        w = _SockWorker(next(self._wid), conn, addr)
        try:
            send_frame(conn, ("init", self._nested_blob, self._session_seed,
                              self._hb_interval, self._init_extras),
                       w.send_lock)
        except OSError:
            w.close()
            return
        with self._pool_cv:
            if not self._open:
                w.close()
                return
            self._joiners.append(w)
        try:
            os.write(self._wake_w, b"j")
        except (OSError, ValueError):
            pass

    def _service_joiners(self) -> None:
        """Register handshake-thread connections with the selector (on the
        loop thread, where every other register/unregister happens)."""
        if not self._joiners:                # unlocked hint, same as _loop
            return
        with self._pool_cv:
            joiners, self._joiners = self._joiners, []
            for w in joiners:
                self._all.append(w)
        for w in joiners:
            try:
                self._sel.register(w.sock, selectors.EVENT_READ, w)
            except (KeyError, ValueError, OSError):
                self._on_dead(w, "could not register handshaken socket")

    def _pump(self, w: _SockWorker) -> None:
        try:
            frames = w.reader.feed()
        except Exception as exc:                     # noqa: BLE001
            # EOF/reset, truncated frame, or an undecodable pickle (e.g. a
            # result type importable on the worker but not here): the
            # channel is unusable either way — treat it as worker death.
            self._on_dead(w, repr(exc))
            return
        w.last_seen = time.monotonic()
        for frame in frames:
            tag = frame[0]
            if tag == "hello":
                w.meta = frame[1]
                with self._pool_cv:
                    w.proc = self._match_pending_locked(w.meta)
                    w.ready = True
                    w.hello_at = time.monotonic()
                    self._idle.append(w)
                    self._pool_cv.notify_all()
            elif tag == "hb":
                now = w.last_seen                     # updated above
                if w.last_hb is not None:
                    w.max_hb_gap = max(w.max_hb_gap, now - w.last_hb)
                w.last_hb = now
            elif tag == "bye":
                # deliberate worker exit (--max-idle-s farewell): treat as
                # a down-scale, not a death — capacity shrinks, no relaunch
                # (an idle-capped worker would otherwise churn launch/
                # idle-exit forever). The worker keeps serving until we
                # answer ("stop",): if it was already checked out by a
                # racing dispatch, the in-flight task completes normally
                # and _finish stops it afterwards.
                if not w.retired:
                    w.retired = True
                    with self._pool_cv:
                        was_idle = w in self._idle
                        if was_idle:
                            self._idle.remove(w)
                        self._capacity -= 1
                        self._pool_cv.notify_all()
                    if was_idle:
                        try:
                            send_frame(w.sock, ("stop",), w.send_lock)
                        except OSError:
                            pass
            elif tag == "need":
                # blob-store backfill: the worker evicted (or never had) a
                # payload the current task references; re-serve it from the
                # in-flight handle's pinned sources. Encoding + sending a
                # multi-MB blob must not stall the select loop (heartbeats
                # of every other worker would sit unread past their
                # timeout), so the transfer runs on its own thread; a
                # failed send is left for the loop to discover as EOF, but
                # an encode failure (pickling/codec error) must nak — the
                # worker is blocked in ensure_refs and its heartbeats keep
                # flowing, so nothing else would ever unstick the task.
                h, digest = w.busy, frame[1]
                src = h.sources.get(digest) if h is not None else None

                def _serve(w=w, digest=digest, src=src):
                    blob = encode_backfill(src)
                    try:
                        if blob is not None:
                            w.put(digest, blob)
                        else:
                            send_frame(w.sock, ("nak", digest), w.send_lock)
                    except (OSError, AttributeError):
                        pass
                threading.Thread(target=_serve, name="payload-backfill",
                                 daemon=True).start()
            elif tag == "state":
                # shared-state op from the task running on this worker
                # (see state.py for op/reply shapes)
                self._handle_state(w, frame)
            elif tag == "progress":
                h = w.busy
                if h is not None:
                    with h.ilock:
                        h.immediate.append(frame[2])
            elif tag == "result":
                h = w.busy
                if h is not None and frame[1] == h.task.task_id:
                    held = frame[3] if len(frame) > 3 else ()
                    if held:
                        # even a discarded late result stays in the
                        # holder's store — record it either way
                        with self._pool_cv:
                            for digest, _nbytes in held:
                                w.known.add(digest)
                                self._note_location_locked(digest, w.wid)
                    if h.done.is_set():
                        # soft-cancelled future (external worker): discard
                        # the late result, worker rejoins the pool healthy
                        w.busy = None
                        with self._pool_cv:
                            self._idle.append(w)
                            self._pool_cv.notify_all()
                    else:
                        run = frame[2]
                        if held and isinstance(run.value, PayloadRef):
                            sizes = dict(held)
                            nbytes = sizes.get(run.value.digest, 0)
                            rv = RemoteValue(run.value.digest, nbytes, self,
                                             label=h.task.label)
                            self._track_remote(rv)
                            run = dataclasses.replace(run, value=rv)
                        h.run = run
                        self._finish(w, h)
            elif tag == "offer":
                # answer to a driver-side ("fetch", digest): hand the blob
                # to every puller parked on (wid, digest)
                self._resolve_fetch(w.wid, frame[1], bytes(frame[2]))
            elif tag == "onak":
                # holder no longer has the digest (evicted): forget the
                # location and fail the parked pullers over to other holders
                self._drop_location(frame[1], w.wid)
                self._resolve_fetch(w.wid, frame[1], None)

    def _match_pending_locked(self, meta: dict) -> "WorkerProc | None":
        """Pair a hello with the WorkerProc that bootstrapped it: by the
        ``--tag`` token the launcher forwarded, else by pid (LocalLauncher:
        the bootstrap process *is* the worker), else first-come-first-
        served for hellos whose bootstrap could not forward the tag (a
        CommandLauncher template using ``{tag}`` in a pod name rather than
        as ``--tag``, or omitting it entirely). A hello carrying an
        *unknown* tag is someone else's worker and matches nothing; a
        tagless hello only FIFO-matches bootstraps that did *not* forward
        the tag, so it can never steal a LocalLauncher/SSHLauncher record
        whose tagged worker is still on its way."""
        tag, pid = meta.get("tag"), meta.get("pid")
        wp = self._match_from(self._pending, tag, pid)
        if wp is not None:
            return wp
        wp = self._match_from(self._expired, tag, pid)
        if wp is not None:
            # its slot was written off when the record aged out of pending
            # (scheduler was slow to place it): the worker showed up after
            # all — restore the capacity it still occupies
            self._capacity += 1
            return wp
        return None

    @staticmethod
    def _match_from(records, tag, pid) -> "WorkerProc | None":
        for wp in records:
            if wp.tag and tag and wp.tag == tag:
                records.remove(wp)
                return wp
        for wp in records:
            # a tag-forwarding bootstrap's worker always matches by tag
            # above, so a pid hit on one here is a collision with a
            # foreign worker's remote pid — skip those records
            if pid is not None and wp.pid == pid and not wp.tag_forwarded:
                records.remove(wp)
                return wp
        if not tag:
            for wp in records:
                if not wp.tag_forwarded:
                    records.remove(wp)
                    return wp
        return None

    def _finish(self, w: _SockWorker, h: _Handle) -> None:
        w.busy = None
        if h.cancelled:
            # cancel() already began killing this worker; don't reuse it.
            # Full death bookkeeping (busy already detached, so the handle
            # keeps its result): removes it from the pool and self-heals,
            # instead of leaking the slot.
            self._on_dead(w, "worker killed by cancel()")
        else:
            bye_stop = False
            with self._pool_cv:
                if w.retired:
                    # bye'd worker that finished a racing in-flight task:
                    # its capacity already shrank, just let it exit now
                    retire = False
                    bye_stop = True
                elif self._shrink_debt > 0:
                    self._shrink_debt -= 1
                    retire = True
                else:
                    self._idle.append(w)
                    retire = False
                self._pool_cv.notify_all()
            if bye_stop:
                try:
                    if w.sock is not None:
                        send_frame(w.sock, ("stop",), w.send_lock)
                except OSError:
                    pass
            elif retire:
                self._retire(w)
        # push completion from the select loop: done-callbacks (continuation
        # dispatch, cross-backend Waiter wake-ups) fire here
        self._complete(h)

    def _retire_dead_worker(self, w: _SockWorker) -> None:
        """Remove a worker without the death/self-heal bookkeeping."""
        try:
            if w.sock is not None:
                self._sel.unregister(w.sock)
        except (KeyError, ValueError, OSError):
            pass
        w.close()
        if w.proc is not None:
            try:
                w.proc.kill()
            except OSError:
                pass

    def _on_dead(self, w: _SockWorker, reason: str) -> None:
        self._retire_dead_worker(w)
        if w.proc is not None:
            # quote the launched worker's captured stderr (crash traceback,
            # OOM-killer note) — best-effort, the drain thread may still be
            # flushing, but it beats dropping the last words entirely
            tail = w.proc.stderr_tail()
            if tail:
                reason += ("; worker stderr:\n    "
                           + "\n    ".join(tail.splitlines()[-10:]))
        h, w.busy = w.busy, None
        self._fail_fetches(w.wid)
        relaunch = False
        with self._pool_cv:
            if w in self._idle:
                self._idle.remove(w)
            if w in self._all:
                self._all.remove(w)
            # prune the location map: digests whose *last* holder this was
            # (and that the driver never pulled) are now lost — remember
            # why (the LineageExhaustedError quotes it)
            for digest, wids in list(self._locations.items()):
                if w.wid in wids:
                    wids.discard(w.wid)
                    if not wids:
                        del self._locations[digest]
                        if digest not in DRIVER_STORE:
                            self._lost[digest] = w.describe()
                            while len(self._lost) > 512:
                                self._lost.popitem(last=False)
            if self._open and not w.retired:
                if w.proc is not None and self._launcher is not None:
                    relaunch = True                  # self-heal, same capacity
                elif w.ready:
                    self._capacity -= 1              # external: shrink
            self._pool_cv.notify_all()
        if relaunch:
            self._schedule_relaunch(w)
        if h is not None and not h.done.is_set():
            if h.cancelled:
                h.error = FutureCancelledError(
                    f"future {h.task.label!r} cancelled; {w.describe()} "
                    f"was terminated", future_label=h.task.label, worker=w.wid)
            else:
                h.error = WorkerDiedError(
                    f"{w.describe()} died while resolving future "
                    f"{h.task.label or h.task.task_id!r}: {reason}",
                    future_label=h.task.label, worker=w.wid)
            self._complete(h)

    def _schedule_relaunch(self, w: _SockWorker) -> None:
        """Queue a replacement for a dead *launched* worker on its host,
        with capped exponential backoff: the delay doubles per churn on the
        host up to ``relaunch_backoff_cap`` and resets once a worker
        survives ``relaunch_reset_after`` seconds (rush-style restart
        hardening: a crash-looping node backs off, a one-off kill heals
        fast)."""
        host = w.proc.host if w.proc is not None else "127.0.0.1"
        lifetime = (time.monotonic() - w.hello_at) \
            if w.hello_at is not None else 0.0
        self._queue_relaunch(host, lifetime)

    def _queue_relaunch(self, host: str, lifetime: float) -> None:
        now = time.monotonic()
        with self._pool_cv:
            if not self._open:
                return
            delay = self._backoff.get(host, self._relaunch_backoff)
            if lifetime >= self._relaunch_reset_after:
                delay = self._relaunch_backoff
            delay = min(delay, self._relaunch_cap)
            self._backoff[host] = min(max(delay, self._relaunch_backoff)
                                      * 2.0, self._relaunch_cap)
            self._relaunch_log.append(delay)
            self._relaunch_q.append((now + delay, host))
        try:
            os.write(self._wake_w, b"r")     # re-arm the select timeout
        except OSError:
            pass

    def _service_relaunches(self) -> None:
        if not self._relaunch_q:             # unlocked hint, same as _loop
            return
        now = time.monotonic()
        due: list[str] = []
        with self._pool_cv:
            if not self._open or not self._relaunch_q:
                return
            rest: list[tuple[float, str]] = []
            for deadline, host in self._relaunch_q:
                if deadline <= now:
                    due.append(host)
                else:
                    rest.append((deadline, host))
            self._relaunch_q = rest
        for host in due:
            self._launch_worker(host, relaunch=True)

    def _reap_and_check(self) -> None:
        with self._pool_cv:
            pending = list(self._pending)
        for wp in pending:
            rc = wp.poll()
            if rc == 0 and (time.monotonic() - wp.launched_at
                            <= self._connect_timeout):
                # a *clean* pre-hello exit is a detaching bootstrap
                # (kubectl run / sbatch submit-and-return): the worker it
                # created is still on its way — keep the pairing record and
                # the capacity slot for up to connect_timeout.
                continue
            if rc is not None:               # died before ever saying hello
                tail = wp.stderr_tail()
                expired = rc == 0
                why = (f"detached (rc=0) but no worker dialed in within "
                       f"connect_timeout={self._connect_timeout}s — "
                       f"scheduler failed to place it?" if expired
                       else "died before hello")
                is_relaunch = getattr(wp, "is_relaunch", False)
                removed = False
                with self._pool_cv:
                    if wp in self._pending:
                        self._pending.remove(wp)
                        removed = True
                        if expired:
                            # detached bootstrap whose worker never dialed
                            # in: write the slot off — uniformly, so that a
                            # worker the scheduler places *late* restores
                            # exactly the capacity that was deducted when
                            # its record matches in _match_pending_locked
                            # (no double-count, no untracked worker)
                            self._capacity -= 1
                            self._expired.append(wp)
                        elif not is_relaunch:
                            self._capacity -= 1
                        self._note_launch_failure_locked(
                            f"{wp.describe()} {why}"
                            + (f"; stderr:\n    "
                               + "\n    ".join(tail.splitlines())
                               if tail else ""))
                        self._pool_cv.notify_all()
                if removed and is_relaunch and not expired:
                    # transient outage during self-heal (ssh refused while
                    # the host reboots): keep retrying with ramping backoff
                    # instead of burning the slot — startup launches above
                    # still fail fast.
                    self._queue_relaunch(wp.host, lifetime=0.0)
        if not self._hb_timeout:
            return
        now = time.monotonic()
        with self._pool_cv:
            stale = [w for w in self._all
                     if w.sock is not None and w.ready
                     and now - w.last_seen > self._hb_timeout]
        for w in stale:
            self._on_dead(w, f"heartbeat timeout ({self._hb_timeout}s)")

    # -- shared-state service (driver side; op/reply shapes in state.py) ----

    def _handle_state(self, w: _SockWorker, frame) -> None:
        """Execute one ``("state", rid, op, args)`` frame from the task
        running on ``w``. Small ops run inline on the select loop (dict
        ops on the singleton service); a ``wait`` registers a service
        watch whose notification — and any multi-hundred-KiB value serve —
        runs on a side thread, so the loop never blocks on user values and
        never stalls heartbeats (the same rule as ``need`` backfills)."""
        from .. import state as state_mod
        _tag, rid, op, args = frame
        svc = state_mod.service()

        def _send(status, payload, digest=None):
            try:
                send_frame(w.sock, ("state_rep", rid, status, payload),
                           w.send_lock)
                if digest is not None:
                    w.known.add(digest)
            except (OSError, AttributeError):
                pass                 # the loop reaps the dead socket

        if op == "wait":
            key, min_version, timeout = args
            deadline = (time.monotonic() + float(timeout)) \
                if timeout is not None else None

            def _notify(ok, value, version):
                # satisfying commits can land on any thread (this select
                # loop included): encode + send on a side thread always
                def _run():
                    if not ok:
                        _send("timeout", None)
                        return
                    try:
                        payload, digest = svc.reply_payload(
                            key, value, version, w.known)
                    except Exception as exc:         # noqa: BLE001
                        _send("err", state_mod._safe_exc(exc))
                        return
                    _send("ok", (version, state_mod.oob(payload)), digest)
                threading.Thread(target=_run, name="state-notify",
                                 daemon=True).start()

            svc.add_watch(key, int(min_version), _notify, deadline)
            return

        def _wrap(payload):
            # out-of-band the large-value halves of ok replies (zero-copy
            # frame path); everything else ships as-is
            if op == "get" and payload[0]:
                return (True, payload[1], state_mod.oob(payload[2]))
            if op == "cas" and payload[2]:
                return (payload[0], payload[1], True,
                        state_mod.oob(payload[3]))
            if op == "blob":
                return pickle.PickleBuffer(payload)
            return payload

        def _serve():
            status, payload, digest = svc.handle(op, args, w.known)
            if status == "ok":
                payload = _wrap(payload)
            _send(status, payload, digest)

        big = op == "blob" \
            or (op == "get" and svc.estimated_nbytes(args[0])
                >= state_mod.STATE_INLINE_MAX) \
            or (op in ("put", "cas", "add", "extend") and args[-1][0] == "r"
                and args[-1][3] >= state_mod.STATE_INLINE_MAX)
        if big:
            threading.Thread(target=_serve, name="state-serve",
                             daemon=True).start()
        else:
            _serve()

    def _service_state_timeouts(self) -> None:
        """Sweep expired state watches (their workers get a ``timeout``
        reply). Tick-resolution (≤1 s) is the contract for wait timeouts."""
        from .. import state as state_mod
        svc = state_mod._SERVICE
        if svc is not None:
            svc.expire_watches()

    # -- driver-side GC of worker-resident blobs ----------------------------

    def _track_remote(self, rv: RemoteValue) -> None:
        """Refcount a new RemoteValue handle for its digest and arm a
        finalizer: when the *last* handle for a digest is collected the
        digest is queued for release and the select loop tells every
        holder to evict its copy — without this, a dropped handle's bytes
        squat worker memory until LRU pressure happens to reclaim them."""
        digest = rv.digest
        with self._release_lock:
            self._rv_refs[digest] = self._rv_refs.get(digest, 0) + 1
        weakref.finalize(rv, _queue_release, weakref.ref(self), digest)

    def _service_releases(self) -> None:
        if not self._pending_releases:       # unlocked hint, same as _loop
            return
        with self._release_lock:
            digests, self._pending_releases = self._pending_releases, []
        for digest in digests:
            with self._release_lock:
                if self._rv_refs.get(digest, 0) > 0:
                    continue                 # re-produced since queued
            with self._pool_cv:
                wids = self._locations.pop(digest, set())
                # nothing can reference it anymore: the lost-blob memory
                # of it (if any) is noise now too
                self._lost.pop(digest, None)
                holders = [w for w in self._all
                           if w.wid in wids and w.sock is not None]
            for w in holders:
                try:
                    send_frame(w.sock, ("evict", digest), w.send_lock)
                except (OSError, AttributeError):
                    pass

    # -- lost worker-resident results --------------------------------------
    #
    # The reference re-executes a lost digest's producing task here; the
    # port records no lineage yet, so a digest with no live copy fails with
    # the reference's message for a digest that has no lineage.

    def _ensure_remote_inputs(self, task: TaskSpec) -> None:
        """Pre-dispatch gate for ``submit()``: every remote input digest
        must have a live copy somewhere (holder or driver store) *before* a
        worker is checked out; one that has none fails the future with
        :class:`LineageExhaustedError`. ``try_submit`` skips this (it must
        never block); its dispatches fail through the need path instead."""
        for digest, src in task.payload_sources.items():
            if not getattr(src, "remote", False):
                continue
            if digest in DRIVER_STORE \
                    or self._live_holder(digest) is not None:
                continue
            self._reconstruct(digest, task.label or "")

    def _reconstruct(self, digest: bytes, label: str = "") -> None:
        """Return when a live copy of ``digest`` exists (a holder in the
        location map, or the bytes in DRIVER_STORE); otherwise raise
        :class:`LineageExhaustedError` — no producing task is recorded."""
        if digest in DRIVER_STORE or self._live_holder(digest) is not None:
            return
        tag = digest.hex()[:12] + (f" ({label})" if label else "")
        with self._pool_cv:
            if not self._open:
                raise ChannelError(
                    f"cluster backend shut down before remote payload "
                    f"{tag} could be rebuilt")
            where = self._lost.get(digest)
        cause = (f"its last holder {where} died" if where
                 else "every copy was evicted")
        raise LineageExhaustedError(
            f"remote payload {tag} was lost ({cause}) and no producing task "
            f"is recorded for it (lineage evicted, or the bytes were not "
            f"task-produced)", digest=digest, future_label=label or None)

    # -- remote-result pulls (driver side of the fetch protocol) ------------
    #
    # ``pull_blob``/``pull_value`` run on *caller* threads (a user thread in
    # Future.value(), a payload-backfill thread serving a worker's ``need``)
    # — never on the select loop, which is the thread that pumps the
    # ``offer``/``onak`` answers they wait for.

    def _resolve_fetch(self, wid: int, digest: bytes,
                       blob: "bytes | None") -> None:
        with self._fetch_lock:
            entries = self._fetch_waits.pop((wid, digest), [])
        for event, slot in entries:
            slot[0] = blob
            event.set()

    def _fail_fetches(self, wid: int) -> None:
        """Unblock every puller parked on a now-dead worker (blob=None:
        they move on to the next holder or raise cleanly)."""
        with self._fetch_lock:
            keys = [k for k in self._fetch_waits if k[0] == wid]
            entries = [e for k in keys for e in self._fetch_waits.pop(k)]
        for event, _slot in entries:
            event.set()

    def _fail_all_fetches(self) -> None:
        with self._fetch_lock:
            waits, self._fetch_waits = list(self._fetch_waits.values()), {}
        for entries in waits:
            for event, _slot in entries:
                event.set()

    def _fetch_blob_from(self, w: _SockWorker, digest: bytes
                         ) -> "bytes | None":
        """Ask one worker for one blob over its control socket; block until
        the select loop pumps the offer/onak (or the worker dies / times
        out). None = this holder could not serve it."""
        event = threading.Event()
        slot: list = [None]
        key = (w.wid, digest)
        entry = (event, slot)
        with self._fetch_lock:
            self._fetch_waits.setdefault(key, []).append(entry)
        try:
            try:
                send_frame(w.sock, ("fetch", digest), w.send_lock)
            except (OSError, AttributeError):
                return None
            if not event.wait(self._fetch_timeout):
                return None
            return slot[0]
        finally:
            with self._fetch_lock:
                entries = self._fetch_waits.get(key)
                if entries and entry in entries:
                    entries.remove(entry)
                    if not entries:
                        self._fetch_waits.pop(key, None)

    def _live_holder(self, digest: bytes) -> "_SockWorker | None":
        with self._pool_cv:
            wids = self._locations.get(digest, ())
            for w in self._all:
                if w.wid in wids and w.sock is not None and w.ready:
                    return w
        return None

    def _peer_addrs(self, digest: bytes, exclude: "int | None" = None
                    ) -> "tuple[list, str | None]":
        """Peer-server addresses of live holders of ``digest`` (excluding
        wid ``exclude`` — the dispatch target itself), plus a lost-holder
        description when *no* live holder remains and the driver store
        cannot serve it either (the fail-fast signal for _dispatch)."""
        with self._pool_cv:
            wids = self._locations.get(digest, set())
            addrs, live = [], 0
            for w in self._all:
                if w.wid in wids and w.sock is not None and w.ready:
                    live += 1
                    if w.wid != exclude:
                        peer = w.meta.get("peer")
                        if peer:
                            addrs.append(tuple(peer))
            lost = None
            if not live and digest not in DRIVER_STORE:
                lost = self._lost.get(digest)
        return addrs, lost

    def pull_blob(self, digest: bytes, label: str = "") -> bytes:
        """Materialize one remote result blob on the driver: driver store
        first, then each live holder over the fetch protocol (caching the
        copy in DRIVER_STORE — later pulls, backfills, and holder deaths
        are then served locally). A digest with no live copy anywhere
        raises LineageExhaustedError (``_reconstruct``)."""
        blob = DRIVER_STORE.get(digest)
        if blob is not None:
            return blob
        tag = f"{digest.hex()[:12]}" + (f" ({label})" if label else "")
        while True:
            with self._pool_cv:
                if not self._open:
                    raise ChannelError(
                        f"cluster backend shut down before remote payload "
                        f"{tag} was fetched")
            w = self._live_holder(digest)
            if w is None:
                # lost holder or evicted everywhere: raises
                # LineageExhaustedError (the reference rebuilds here)
                self._reconstruct(digest, label)
                blob = DRIVER_STORE.get(digest)
                if blob is not None:
                    return blob
                continue
            blob = self._fetch_blob_from(w, digest)
            if blob is not None:
                DRIVER_STORE.put(digest, blob)
                return blob
            # this holder could not serve it (onak / died / timed out):
            # forget the location and try the next holder, if any
            self._drop_location(digest, w.wid)

    def pull_value(self, digest: bytes, label: str = "") -> Any:
        """Pull + decode one remote result (Future.value()'s explicit
        materialization). A tensor decodes on this process's device of its
        type into memory of its own; numpy arrays decode zero-copy
        read-only, and RemoteValue.fetch(writable=True) copies those."""
        from . import transport
        value, _cacheable = transport.decode_payload(
            self.pull_blob(digest, label=label))
        return value

    # -- Backend API ---------------------------------------------------------

    def submit(self, task: TaskSpec) -> _Handle:
        try:
            self._ensure_remote_inputs(task)
        except FutureError as exc:
            # a lost input: surface it through the normal completion path
            # (value()/callbacks), not at submit
            handle = _Handle(task)
            handle.error = exc
            self._complete(handle)
            return handle
        worker = self._checkout(prefer=self._holders(task.affinity))
        return self._dispatch(task, worker)

    def try_submit(self, task: TaskSpec) -> "_Handle | None":
        worker = self._try_checkout(prefer=self._holders(task.affinity))
        if worker is None:
            return None
        return self._dispatch(task, worker)

    def _dispatch(self, task: TaskSpec, worker: _SockWorker,
                  handle: "_Handle | None" = None) -> _Handle:
        if handle is None:
            handle = _Handle(task)
        blob = task.shipped
        assert blob is not None, "cluster backend requires a shipped fn"
        worker.busy = handle
        handle.worker = worker
        handle.pin = DRIVER_STORE.pinned(
            tuple(d for d, s in task.payload_sources.items()
                  if not getattr(s, "remote", False)))
        handle.pin.__enter__()
        # Encode payloads this worker does not hold yet *before* sending
        # anything: an encode failure (pickling/codec error) then fails
        # this future cleanly and returns the still-healthy worker to the
        # pool, instead of leaking a checked-out worker mid-dispatch.
        # (A digest the worker evicted comes back via the ("need", d) path.)
        # Remote-result inputs are NOT pre-put: the whole point of the
        # dataflow path is that their bytes never route through the driver
        # unless they must. The task frame instead carries per-digest peer
        # addresses (hints); the worker's resolution order is own store ->
        # peer fetch -> ("need", d) driver fallback (which naks a digest
        # with no live copy, failing the task with ChannelError).
        try:
            puts, hints = [], {}
            for digest, src in task.payload_sources.items():
                if getattr(src, "remote", False):
                    addrs, _lost = self._peer_addrs(digest,
                                                    exclude=worker.wid)
                    if addrs:
                        hints[digest] = addrs
                elif digest not in worker.known:
                    puts.append((digest, src.encode()))
        except Exception as exc:                     # noqa: BLE001
            handle.error = exc
            # _finish does the full healthy-worker return (shrink-debt /
            # retire bookkeeping, idle requeue, completion push) — the same
            # path a normal result takes
            self._finish(worker, handle)
            return handle
        try:
            for digest, pblob in puts:
                worker.put(digest, pblob)
            send_frame(worker.sock,
                       ("task", task.task_id, blob, task.refs,
                        hints, self._remote_results),
                       worker.send_lock)
        except (OSError, AttributeError):
            worker.busy = None
            handle.error = WorkerDiedError(
                f"{worker.describe()} died at dispatch of future "
                f"{task.label or task.task_id!r}",
                future_label=task.label, worker=worker.wid)
            self._complete(handle)
        return handle

    def _complete(self, handle: _Handle) -> None:
        with handle._cb_lock:
            pin, handle.pin = getattr(handle, "pin", None), None
        if pin is not None:
            pin.__exit__(None, None, None)
        super()._complete(handle)

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
            if w.proc is not None:
                # driver-launched: hard-cancel — kill the bootstrap and
                # sever the socket; the driver loop sees EOF, fails the
                # handle with FutureCancelledError, and relaunches a
                # replacement. For LocalLauncher the bootstrap *is* the
                # worker; for ssh the HUP chain tears the remote one down;
                # a detached bootstrap's remote worker keeps computing
                # until its next send hits the severed socket, then exits.
                try:
                    w.proc.kill()
                except OSError:
                    pass
                try:
                    if w.sock is not None:
                        w.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            else:
                # externally launched: soft-cancel — killing it would
                # permanently drain hand-launched capacity (nothing can
                # respawn it). Fail the future now; the worker finishes its
                # task, the late result is discarded, and it rejoins idle.
                handle.error = FutureCancelledError(
                    f"future {handle.task.label!r} cancelled "
                    f"(soft: external {w.describe()} keeps running)",
                    future_label=handle.task.label, worker=w.wid)
                self._complete(handle)
        return True

    def shutdown(self) -> None:
        with self._pool_cv:
            if not self._open and self._cleaned:
                return
            self._open = False
            self._pool_cv.notify_all()
        try:
            os.write(self._wake_w, b"x")
        except OSError:
            pass
        self._loop_thread.join(timeout=10)
        self._cleanup()

    def _cleanup(self) -> None:
        with self._cleanup_lock:
            if self._cleaned:
                return
            self._cleaned = True
        self._fail_all_fetches()     # unblock pull_blob callers (they see
        #                              _open=False and raise ChannelError)
        with self._pool_cv:
            workers = list(self._all)
            self._all, self._idle = [], []
            pending, self._pending = list(self._pending), []
            self._relaunch_q = []
        for w in workers:
            try:
                if w.sock is not None:
                    send_frame(w.sock, ("stop",), w.send_lock)
            except OSError:
                pass
            self._retire_dead_worker(w)
            h, w.busy = w.busy, None
            if h is not None and not h.done.is_set():
                h.error = ChannelError(
                    f"cluster backend shut down while future "
                    f"{h.task.label!r} was in flight",
                    future_label=h.task.label, worker=w.wid)
                self._complete(h)
        self._notify_done()
        for wp in pending:
            wp.kill()
        # reap killed children so they don't linger as zombies/orphans
        # (tests assert the reap through WorkerProc.poll)
        for wp in pending + [w.proc for w in workers
                             if w.proc is not None]:
            try:
                wp.wait(timeout=5)
            except Exception:                # noqa: BLE001
                pass
        for fd_obj in (self._listener,):
            try:
                fd_obj.close()
            except OSError:
                pass
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass
        try:
            self._sel.close()
        except (OSError, RuntimeError):
            pass

    @property
    def workers(self) -> int:
        return self._n

    def worker_pids(self) -> list:
        """PIDs of the currently-connected workers (diagnostics/tests)."""
        with self._pool_cv:
            return [w.meta.get("pid") for w in self._all
                    if w.ready and w.sock is not None]

    def put_bytes(self) -> dict:
        """``{pid: bytes of put frames sent}`` of the connected workers,
        counted at the driver's sockets (a worker holding a payload is
        sent none)."""
        with self._pool_cv:
            return {w.meta.get("pid"): w.put_bytes for w in self._all
                    if w.ready and w.sock is not None}

    def put_seconds(self) -> dict:
        """``{pid: seconds the put frames' sends took}`` (their GB/s over
        the connection beside :meth:`put_bytes`)."""
        with self._pool_cv:
            return {w.meta.get("pid"): w.put_seconds for w in self._all
                    if w.ready and w.sock is not None}

    def heartbeat_gaps(self) -> dict:
        """``{pid: longest gap in seconds between two heartbeats}`` of the
        connected workers (diagnostics: a task holding a worker's GIL for
        long delays its heartbeats towards ``heartbeat_timeout``)."""
        with self._pool_cv:
            return {w.meta.get("pid"): w.max_hb_gap for w in self._all
                    if w.ready and w.sock is not None}

    @classmethod
    def validate_spec(cls, **kwargs) -> None:
        """Refuse at ``plan()`` a kwarg of a later slice, by name."""
        _refuse_later({k: v for k, v in kwargs.items() if k in _LATER})
