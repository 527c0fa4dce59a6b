"""Standalone TCP cluster worker.

The ``ClusterBackend`` driver normally *launches* these itself through the
launcher subsystem (``launchers.py``): local subprocesses for
``workers=N``/``hosts=N``, ssh or a scheduler command template for named
hosts. Running one by hand (or from a scheduler script pointed at
``backend.address``) is still first-class::

    python -m repro_torch.core.backends.cluster_worker DRIVER_HOST:PORT \\
        [--tag TOKEN] [--reconnect] [--max-idle-s 600]

This is the paper's ``makeClusterPSOCK`` topology: the driver listens,
workers dial in, futures are shipped as pickled blobs and resolved remotely.
Driver-launched and hand-launched workers share this code path, so
single-host tests exercise the real multi-host transport.

Flags for scheduler-launched fleets:

* ``--tag TOKEN`` — echoed in the hello frame so the driver can pair this
  worker with the ``WorkerProc`` bootstrap that launched it (relaunch
  policy, cancel kills, shutdown reaping).
* ``--reconnect`` — on connection loss keep redialing the driver (capped
  backoff) instead of exiting. The default (exit, let the driver relaunch)
  is right for driver-owned workers; ``--reconnect`` is right when the
  *scheduler* owns the process and a driver restart should not strand the
  allocation.
* ``--max-idle-s S`` — exit cleanly after ``S`` seconds without any frame
  from the driver (and bound reconnect attempts the same way), so a
  scheduler-launched worker cannot outlive a dead driver and squat its
  allocation forever. ``0`` (default): never.
* ``--token`` / ``--tls`` / ``--tls-ca`` — the driver's security settings
  (see the *security preamble* in ``transport.py``). Default from
  ``REPRO_CLUSTER_TOKEN`` / ``REPRO_CLUSTER_TLS`` /
  ``REPRO_CLUSTER_TLS_CA``, which driver-side launchers export for the
  workers they spawn.

Protocol (see transport.py): the driver sends ``init`` (nested plan stack,
session seed, heartbeat interval, extras) immediately on accept; the worker
replies ``hello`` and from then on pushes a heartbeat frame every interval
from a side thread so the driver can tell a wedged/partitioned worker from
a slow task. Tasks arrive as ``("task", id, blob, refs[, hints, keep])`` —
large globals referenced by digest, their bytes delivered in preceding
``("put", digest, blob)`` frames at most once per worker and cached in a
bounded LRU :class:`BlobStore` (``("need", digest)`` asks evicted ones
back) — and are answered with ``("progress", id, cond)`` streams and one
``("result", id, run[, held])``.

The worker imports ``repro_torch`` and torch, never ``jax`` or ``repro``.
A task that touches the card makes this process's own CUDA context (the
worker is a fresh interpreter, never a fork of the driver); tensors reach
it and leave it as their bytes (see ``transport.py``).

Worker-to-worker dataflow: each worker also runs a tiny *peer server* on an
ephemeral port, advertised as ``meta["peer"]`` in the hello frame. Any
requester (a sibling worker following the driver's per-task location
``hints``, or the driver itself pulling a ``Future.value()``) connects —
peers dial the advertised port, the driver just reuses this control socket
— and speaks the symmetric fetch protocol: ``("fetch", digest)`` is
answered with ``("offer", digest, blob)`` when the store holds the bytes,
``("onak", digest)`` when it does not (evicted — the requester falls back
to the driver's ``need`` path; never a silent wrong answer, since blobs
are content-addressed). A dedicated reader thread owns every read on the
driver socket and serves ``fetch`` frames *inline*, so a holder busy with
a long task still serves its blobs; it likewise routes ``state_rep``
frames (shared-state replies — the main thread is blocked inside user
code awaiting them; see ``state.py``) straight into the state client's
wait slots, and applies ``("evict", digest, n)`` frames (driver-side GC
of a dead ``RemoteValue``) directly to the blob store, unless this worker
has reported holding the digest more than ``n`` times since the last evict
(a copy the driver had not heard of when it released the digest), keeping
only the count of those unread reports; a ``("replicate",
digest, addrs)`` frame (proactive replication under ``min_replicas``)
spawns a side thread that peer-fetches a copy and confirms with
``("stored", digest, nbytes, "replicate")`` — the same frame, with
``"fetch"``, registers a task-path peer fetch as a replica promotion; all
other frames are queued to the main loop in arrival order. When a task
arrives with
``keep`` set, a large result is parked in the local store (a tensor on the
card through a host copy) and the result frame carries ``run.value =
PayloadRef(digest)`` plus a ``held`` manifest instead of the bytes — the
driver records holder locations and schedules continuations onto them
(see ``cluster.py``).

Tip for hand-launched workers: export ``OMP_NUM_THREADS=1`` before
launching several per machine; the worker sets torch's intra-op pool to
match. (Driver-side launchers set this for you.)
"""

from __future__ import annotations

import argparse
import os
import pickle
import queue
import socket
import threading
import time

from ..errors import ChannelError
from .transport import (TLSConfig, client_tls_context, dial_auth,
                        recv_frame, send_frame, serve_auth,
                        server_tls_context)


class HeldReports:
    """This worker's reports of holding each digest (held manifests and
    ``stored`` frames) that no ``("evict", digest, n)`` has answered yet.
    A copy is stored and counted as one step, and an evict compares and
    subtracts under the same lock, so a copy reported after the driver
    released the digest survives the late evict."""

    def __init__(self, store):
        self.store = store
        self.counts: dict = {}
        self._lock = threading.Lock()

    def put(self, digest, blob) -> None:
        """Store ``blob`` and count its report."""
        with self._lock:
            self.store.put(digest, blob)
            self.counts[digest] = self.counts.get(digest, 0) + 1

    def count(self, digest) -> None:
        """Count a report of a copy stored already (pinned by a task)."""
        with self._lock:
            self.counts[digest] = self.counts.get(digest, 0) + 1

    def evict(self, digest, n: int) -> bool:
        """The driver released ``digest`` after reading ``n`` reports:
        drop the copy unless more were sent since, and keep only the count
        of those. True iff the copy was dropped."""
        with self._lock:
            left = self.counts.pop(digest, 0) - n
            if left > 0:
                self.counts[digest] = left
                return False
            return self.store.drop(digest)


def _answer_fetch(sock, send_lock, store, digest) -> None:
    """Answer one ``("fetch", digest)``: offer the blob out-of-band, or
    onak when the store no longer holds it (LRU eviction) — the requester
    falls back to the driver. Send failures are the requester's problem."""
    blob = store.get(digest)
    try:
        if blob is None:
            send_frame(sock, ("onak", digest), send_lock)
        else:
            send_frame(sock, ("offer", digest, pickle.PickleBuffer(blob)),
                       send_lock)
    except OSError:
        pass


class _PeerServer:
    """Ephemeral listener serving this worker's blob store to sibling
    workers (the worker-to-worker half of the fetch/offer protocol).
    Best-effort: if the bind fails, ``addr`` stays ``None`` and peers
    simply use the driver-fallback path.

    On a secured cluster the driver ships per-cluster peer credentials in
    the init extras (over the already-authenticated control channel):
    every peer connection must then pass the same TLS wrap and/or auth
    preamble as the driver listener — an attacker who can reach a worker's
    ephemeral port cannot fetch blobs, the same guarantee as the driver
    port."""

    def __init__(self, store, host_hint: str, *, tls_ctx=None,
                 secret: str = ""):
        self._store = store
        self._tls_ctx = tls_ctx
        self._secret = secret
        self.addr: "tuple[str, int] | None" = None
        self._ls: "socket.socket | None" = None
        try:
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.bind(("", 0))
            ls.listen(16)
        except OSError:
            return
        self._ls = ls
        self.addr = (host_hint, ls.getsockname()[1])
        threading.Thread(target=self._accept_loop, name="peer-serve",
                         daemon=True).start()

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._ls.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(conn,),
                             name="peer-conn", daemon=True).start()

    def _serve_one(self, conn):
        try:
            conn.settimeout(30.0)
            if self._tls_ctx is not None:
                conn = self._tls_ctx.wrap_socket(conn, server_side=True)
            if self._secret:
                serve_auth(conn, {"peer": self._secret})
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while True:
                msg = recv_frame(conn)
                if msg[0] != "fetch":
                    return
                _answer_fetch(conn, None, self._store, msg[1])
        except (EOFError, ChannelError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        if self._ls is not None:
            try:
                self._ls.close()
            except OSError:
                pass


def _peer_fetch(digest, addrs, timeout: float = 5.0, *, tls_ctx=None,
                secret: str = "") -> "bytes | None":
    """Try each peer address for ``digest``; first offer wins. ``None``
    when no peer can serve it (unreachable, partitioned, evicted) — the
    caller falls back to the driver's ``need`` path. Failures are bounded
    by ``timeout`` per address, so a partitioned peer costs seconds, not a
    stuck task. ``tls_ctx``/``secret`` are the cluster's peer credentials
    (mandatory on both sides when the driver armed them)."""
    for addr in addrs or ():
        ps = None
        try:
            ps = socket.create_connection(tuple(addr), timeout=timeout)
            ps.settimeout(timeout)
            if tls_ctx is not None:
                ps = tls_ctx.wrap_socket(ps)
            if secret:
                dial_auth(ps, secret)
            ps.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            send_frame(ps, ("fetch", digest))
            msg = recv_frame(ps)
            if msg[0] == "offer" and msg[1] == digest:
                return bytes(msg[2])
        except (EOFError, ChannelError, OSError):
            continue
        finally:
            if ps is not None:
                try:
                    ps.close()
                except OSError:
                    pass
    return None


def _serve(sock: socket.socket, *, tag: str = "",
           max_idle_s: float = 0.0,
           handshake_timeout: float = 30.0) -> str:
    """Serve one driver connection until it ends; returns why:
    ``"stop"`` (stop frame), ``"idle"`` (``max_idle_s`` with no driver
    frames), or ``"eof"`` (connection lost / driver died)."""
    # the init frame must arrive promptly — a peer that accepted but never
    # serves (driver host crashed post-accept, port squatted by another
    # service) must not hang us forever before the idle watchdog even
    # starts. socket.timeout is an OSError: callers treat it as "eof".
    sock.settimeout(handshake_timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    send_lock = threading.Lock()

    msg = recv_frame(sock)
    if not msg or msg[0] != "init":
        raise ChannelError(f"expected init frame from driver, got {msg!r}")
    sock.settimeout(None)
    nested_blob, session_seed, hb_interval = msg[1], msg[2], msg[3]
    extras = msg[4] if len(msg) > 4 else {}

    stop = threading.Event()
    state = {"last": time.monotonic(), "idle": False, "busy": False}
    if hb_interval:
        def _beat():
            while not stop.wait(hb_interval):
                try:
                    send_frame(sock, ("hb",), send_lock)
                except OSError:
                    return
        threading.Thread(target=_beat, name="cluster-hb", daemon=True).start()
    if max_idle_s:
        # Idle watchdog: no frames *from* the driver (tasks, puts) for
        # max_idle_s -> sever the socket; the main loop's read error is
        # then reported as "idle", not "eof", so --reconnect does not undo
        # the exit. Heartbeats we *send* do not count as activity, but a
        # task mid-execution does ("busy") — idleness means *unused*, and
        # a task running longer than max_idle_s must never be killed.
        def _watch():
            grace_until = None
            while not stop.wait(max(min(max_idle_s / 4.0, 1.0), 0.05)):
                if state["busy"]:
                    continue
                if grace_until is None:
                    if time.monotonic() - state["last"] <= max_idle_s:
                        continue
                    # farewell first: a deliberate idle exit must read as
                    # a retire on the driver (capacity shrinks, no relaunch
                    # churn). Keep serving until its ("stop",) answer so a
                    # task already racing toward us completes normally
                    # instead of hitting a severed socket.
                    state["idle"] = True
                    try:
                        send_frame(sock, ("bye", "idle"), send_lock)
                    except OSError:
                        return
                    grace_until = time.monotonic() \
                        + max(2.0, min(max_idle_s, 10.0))
                elif time.monotonic() >= grace_until:
                    # driver never answered (pre-bye driver, lost frame):
                    # sever and exit the old way
                    try:
                        sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    return
        threading.Thread(target=_watch, name="cluster-idle",
                         daemon=True).start()

    from .. import planning as plan_mod
    from .. import rng as rng_mod

    # Workers see the *popped* plan stack (nested-parallelism protection)
    # and the driver's session seed (RNG-stream invariance across backends).
    plan_mod._TLS.stack = tuple(pickle.loads(nested_blob))
    rng_mod.set_session_seed(session_seed)

    from ..state import SockStateClient, state_context
    from .blobstore import BlobStore
    from .worker import ensure_refs, error_run, execute_shipped, hold_result

    store = BlobStore(extras.get("blob_store_bytes"))
    # shared-state client: task bodies calling `repro_torch.core.state.*` go to
    # the driver's StateService over this control socket (see state.py)
    st_client = SockStateClient(sock, send_lock, store)
    try:
        local_ip = sock.getsockname()[0]
    except OSError:
        local_ip = "127.0.0.1"
    # Peer-fetch credentials arrive in the init extras over the (already
    # authenticated) control channel: a random per-cluster secret, plus the
    # cluster's TLS cert/key PEM bytes when the driver is TLS-armed. Both
    # sides of every worker-to-worker connection then enforce them.
    peer_secret = extras.get("peer_secret", "")
    peer_srv_ctx = peer_cli_ctx = None
    if extras.get("tls_material") is not None:
        import tempfile
        cert_pem, key_pem = extras["tls_material"]
        tdir = tempfile.mkdtemp(prefix="repro-peer-tls-")
        certfile = os.path.join(tdir, "cert.pem")
        keyfile = os.path.join(tdir, "key.pem")
        with open(certfile, "wb") as fh:
            fh.write(cert_pem)
        with open(keyfile, "wb") as fh:
            fh.write(key_pem)
        os.chmod(keyfile, 0o600)
        tls_cfg = TLSConfig(certfile=certfile, keyfile=keyfile,
                            cafile=certfile)
        peer_srv_ctx = server_tls_context(tls_cfg)
        peer_cli_ctx = client_tls_context(tls_cfg)

    def peer_fetch(digest, addrs):
        return _peer_fetch(digest, addrs, tls_ctx=peer_cli_ctx,
                           secret=peer_secret)

    peer_srv = _PeerServer(store, local_ip, tls_ctx=peer_srv_ctx,
                           secret=peer_secret)

    meta = {"pid": os.getpid(), "host": socket.gethostname()}
    if tag:
        meta["tag"] = tag
    if peer_srv.addr is not None:
        meta["peer"] = peer_srv.addr
    send_frame(sock, ("hello", meta), send_lock)

    # One reader thread owns every read on the driver socket: it serves
    # ("fetch", digest) frames inline — so this worker keeps offering its
    # held blobs even while the main thread is deep in a long task — and
    # queues everything else to the main loop in arrival order (pre-task
    # puts still precede their task frame). Read errors surface as a
    # ("__down__", exc) sentinel so the main loop keeps the existing
    # stop/idle/eof return semantics.
    inbox: "queue.SimpleQueue" = queue.SimpleQueue()
    reports = HeldReports(store)

    def _reader():
        while True:
            try:
                msg = recv_frame(sock)
            except BaseException as exc:             # noqa: BLE001
                # unblock any task thread parked inside a state call before
                # the main loop even sees the sentinel
                st_client.fail_all(exc)
                inbox.put(("__down__", exc))
                return
            state["last"] = time.monotonic()
            if msg[0] == "fetch":
                _answer_fetch(sock, send_lock, store, msg[1])
                continue
            if msg[0] == "state_rep":
                # the main thread is blocked inside user code waiting on
                # exactly this reply — route it straight to the wait slot
                st_client.deliver(msg)
                continue
            if msg[0] == "evict":
                # driver-side GC: the RemoteValue handle for this digest
                # died at the driver — drop our copy (no-op if pinned/gone)
                # unless we stored and reported it again since
                reports.evict(msg[1], msg[2])
                continue
            if msg[0] == "replicate":
                # proactive replication: pull a copy of the digest from a
                # holder peer and confirm, making this worker a registered
                # replica. The fetch can take a while (multi-MB blob), so
                # it runs on its own thread — the reader must keep pumping
                # frames (the main thread may be mid-task).
                def _replicate(digest=msg[1], addrs=msg[2]):
                    blob = store.get(digest)
                    if blob is None:
                        blob = peer_fetch(digest, addrs)
                        if blob is None:
                            return       # no holder reachable: best-effort
                    reports.put(digest, blob)
                    try:
                        send_frame(sock, ("stored", digest, len(blob),
                                          "replicate"), send_lock)
                    except OSError:
                        pass
                threading.Thread(target=_replicate, name="blob-replicate",
                                 daemon=True).start()
                continue
            inbox.put(msg)

    threading.Thread(target=_reader, name="cluster-read",
                     daemon=True).start()

    def recv_msg():
        msg = inbox.get()
        if msg[0] == "__down__":
            raise msg[1]
        return msg

    def _reason() -> str:
        return "idle" if state["idle"] else "eof"

    try:
        while True:
            try:
                msg = recv_msg()
            except (EOFError, ChannelError, OSError):
                return _reason()
            if msg[0] == "stop":
                return "stop"
            if msg[0] == "put":
                store.put(msg[1], msg[2])
                continue
            if msg[0] != "task":
                continue
            task_id, blob = msg[1], msg[2]
            refs = msg[3] if len(msg) > 3 else ()
            hints = msg[4] if len(msg) > 4 else None
            keep = bool(msg[5]) if len(msg) > 5 else False

            def emit(cond, _tid=task_id):
                try:
                    send_frame(sock, ("progress", _tid, cond), send_lock)
                except OSError:
                    pass

            def _promoted(d, nbytes):
                # task-path peer fetch: this worker now holds a copy —
                # register as a replica with the driver (the copy is
                # pinned by the task, so no evict lands before the count)
                reports.count(d)
                try:
                    send_frame(sock, ("stored", d, nbytes, "fetch"),
                               send_lock)
                except OSError:
                    pass

            state["busy"] = True
            try:
                with store.pinned(refs):     # siblings survive backfill puts
                    stopped = ensure_refs(
                        store, refs,
                        lambda d: send_frame(sock, ("need", d), send_lock),
                        recv_msg,
                        peer_fetch=(
                            (lambda d: peer_fetch(d, hints.get(d)))
                            if hints else None),
                        on_peer_fetched=_promoted)
                    if stopped == "stop":
                        return "stop"
                    with state_context(st_client):
                        run = execute_shipped(
                            blob, emit,
                            resolve_ref=lambda r: store.resolve(r.digest))
            except (EOFError, OSError):
                return _reason()
            except Exception as exc:                 # noqa: BLE001
                # a task blob that fails to decode (e.g. a function pickled
                # by reference to a module this worker cannot import) is
                # that task's failure, not the worker's: relay a clean
                # error run and keep serving
                run = error_run(exc)
            finally:
                state["last"] = time.monotonic()
                state["busy"] = False
            held = ()
            if keep:
                run, held = hold_result(store, run, put=reports.put)
            try:
                send_frame(sock, ("result", task_id, run, held), send_lock)
            except OSError:
                return _reason()
    finally:
        stop.set()
        peer_srv.close()
        try:
            sock.close()
        except OSError:
            pass


def _secure_dial(sock, host: str, *, token: str = "",
                 tls: "TLSConfig | None" = None, timeout: float = 30.0):
    """Upgrade a fresh driver connection per the cluster's security
    settings: TLS wrap first (so the auth preamble travels encrypted),
    then the shared-token handshake. Returns the (possibly wrapped)
    socket; raises :class:`ChannelError` on any refusal — bounded by
    ``timeout``, so dialing a mismatched listener fails fast instead of
    hanging."""
    if tls is None and not token:
        return sock
    sock.settimeout(timeout)
    if tls is not None:
        ctx = client_tls_context(tls)
        try:
            sock = ctx.wrap_socket(sock, server_hostname=host)
        except OSError as exc:
            raise ChannelError(
                f"TLS handshake with driver {host!r} failed: {exc!r} "
                f"(is the listener TLS-armed?)") from exc
    if token:
        dial_auth(sock, token, timeout=timeout)
    return sock


def run_worker(host: str, port: int, *, connect_timeout: float = 30.0,
               tag: str = "", reconnect: bool = False,
               max_idle_s: float = 0.0, token: str = "",
               tls: "TLSConfig | None" = None) -> None:
    """Connect to the driver and resolve shipped futures until told to stop
    or the connection drops. Default: exit on disconnect and let the
    driver's relaunch policy self-heal; with ``reconnect=True`` keep
    redialing (scheduler-owned workers), bounded by ``max_idle_s``.
    ``token``/``tls`` must match the driver's security settings (launched
    workers inherit them via ``REPRO_CLUSTER_TOKEN`` / ``REPRO_CLUSTER_TLS``
    / ``REPRO_CLUSTER_TLS_CA``)."""
    if "OMP_NUM_THREADS" not in os.environ:
        os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    # torch read OMP_NUM_THREADS when it was imported; its intra-op pool
    # follows the variable the launcher set (several workers a machine)
    threads = os.environ["OMP_NUM_THREADS"]
    torch.set_num_threads(int(threads) if threads.isdigit()
                          and int(threads) > 0 else 1)

    retry_delay = 0.5
    #: last time a driver connection was genuinely useful — max_idle_s
    #: bounds the time since then across *every* failure shape (connect
    #: refused, accept-then-drop, handshake hang), not just one branch
    useful_at = time.monotonic()
    while True:
        if reconnect and max_idle_s \
                and time.monotonic() - useful_at > max_idle_s:
            return
        try:
            sock = socket.create_connection((host, port),
                                            timeout=connect_timeout)
        except OSError:
            if not reconnect:
                raise
            time.sleep(retry_delay)
            retry_delay = min(retry_delay * 2.0, 5.0)
            continue
        served_at = time.monotonic()
        try:
            sock = _secure_dial(sock, host, token=token, tls=tls,
                                timeout=connect_timeout)
            reason = _serve(sock, tag=tag, max_idle_s=max_idle_s,
                            handshake_timeout=connect_timeout)
        except (EOFError, ChannelError, OSError):
            # connection lost inside the init/security handshake (driver
            # mid-restart accepted then closed, credential mismatch): same
            # as any other drop — redial when --reconnect,
            # die-and-be-relaunched otherwise
            try:
                sock.close()
            except OSError:
                pass
            if not reconnect:
                raise
            reason = "eof"
        if reason in ("stop", "idle") or not reconnect:
            return
        # back off on the redial too: a driver that accepts-then-drops
        # (mid-restart, port stolen by another service) must not turn this
        # into a hot connect loop. A connection that held for a while
        # counts as useful and resets the backoff.
        if time.monotonic() - served_at >= 2.0:
            retry_delay = 0.5
            useful_at = time.monotonic()
        time.sleep(retry_delay)
        retry_delay = min(retry_delay * 2.0, 5.0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="repro_torch cluster worker: connect to a "
                    "ClusterBackend driver and resolve futures over TCP")
    ap.add_argument("address", help="driver HOST:PORT to connect to")
    ap.add_argument("--connect-timeout", type=float, default=30.0)
    ap.add_argument("--tag", default="",
                    help="launch token echoed in the hello frame so the "
                         "driver pairs this worker with the bootstrap "
                         "process that launched it")
    ap.add_argument("--reconnect", action="store_true",
                    help="keep redialing the driver after connection loss "
                         "instead of exiting (scheduler-owned workers)")
    ap.add_argument("--max-idle-s", type=float, default=0.0,
                    help="exit after this many seconds without any frame "
                         "from the driver (0: never) — keeps scheduler-"
                         "launched workers from outliving a dead driver")
    ap.add_argument("--token", default=os.environ.get(
                        "REPRO_CLUSTER_TOKEN", ""),
                    help="shared cluster token for the auth preamble "
                         "(default: $REPRO_CLUSTER_TOKEN)")
    ap.add_argument("--tls", action="store_true",
                    default=bool(os.environ.get("REPRO_CLUSTER_TLS")),
                    help="wrap the driver connection in TLS (default: "
                         "$REPRO_CLUSTER_TLS non-empty)")
    ap.add_argument("--tls-ca", default=os.environ.get(
                        "REPRO_CLUSTER_TLS_CA", ""),
                    help="PEM file to verify the driver's certificate "
                         "against (default: $REPRO_CLUSTER_TLS_CA; empty: "
                         "encrypt without verifying)")
    args = ap.parse_args(argv)
    host, _, port = args.address.rpartition(":")
    if not port.isdigit():
        ap.error(f"address must be HOST:PORT, got {args.address!r}")
    tls = TLSConfig(cafile=args.tls_ca) if (args.tls or args.tls_ca) \
        else None
    run_worker(host or "127.0.0.1", int(port),
               connect_timeout=args.connect_timeout, tag=args.tag,
               reconnect=args.reconnect, max_idle_s=args.max_idle_s,
               token=args.token, tls=tls)


if __name__ == "__main__":
    main()
