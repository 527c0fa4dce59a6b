"""Multi-tenant serving tier: one warm cluster, many client sessions.

The paper's design split — *developers say what to parallelize, end-users
choose the backend* — assumed the end-user also owns the worker pool. This
module removes that assumption: a long-lived **serving server** wraps one
:class:`~.backends.cluster.ClusterBackend` and accepts many concurrent
client *sessions*, each authenticated (token handshake, optional TLS — see
the *security preamble* in ``backends/transport.py``) and mapped to a
**tenant**. Each session gets the full Future/stream/state API through
:class:`ServingClientBackend` (``plan("serving", addr=..., token=...)``):

* futures ship their pickled-function blobs over the session socket and are
  submitted into the cluster's weighted fair-share scheduler under the
  session's tenant — a flooding tenant cannot starve the others beyond its
  weight (``cluster.configure_tenants``);
* ``repro_torch.core.state`` calls are namespaced per tenant server-side
  (:func:`~.state.scope_args`): tenants cannot read or clobber each
  other's keys;
* ``wire_stats()``/``tenant_stats()`` attribution is per tenant.

Server::

    from repro_torch.core.serving import serve
    srv = serve({"workers": 4}, tokens={"alice": "s1", "bob": "s2"},
                tenants={"alice": 3.0, "bob": 1.0}, tls=True)
    print(srv.address)          # ("127.0.0.1", 40123)
    srv.serve_forever()         # or keep it in-process and srv.close()

or ``python -m repro_torch.core.serving --workers 4 --tenant alice=s1 ...``.

Client (separate process)::

    plan("serving", addr="127.0.0.1:40123", token="s1", tls_ca="cert.pem")
    value(future(lambda: 2 + 2))

Session wire protocol (rides the framed transport, after the preamble):
client sends ``("sub", fid, shipped, refs, blobs, opts)``, ``("free",
rid)``, ``("state", rid, op, args)``, ``("stats", rid)``, ``("cancel",
fid)``, ``("bye",)``; server sends ``("welcome", meta)``, ``("done", fid,
run[, "err"])``, ``("free_rep", rid, n)``, ``("state_rep", rid, status,
payload)``, ``("stats_rep", rid, payload)`` and ``("expired",)`` when the
session outlives ``session_ttl``. Every client call after expiry fails
with a clean :class:`~.errors.ChannelError` — never a hang.

Frames are pickled by the shipping pickler (``transport.send_frame``), so a
tensor in a shipped payload or a result crosses a session as its bytes,
never as a CUDA IPC handle, and is rebuilt on the receiver's device of its
type.

Limitations (documented, not discovered): serving futures evaluate under
the *server's* session seed and nested plan stack, and immediate
conditions are relayed at ``value()`` (from the captured run), not live.
"""

from __future__ import annotations

import itertools
import queue
import socket
import threading
import time

from ..backends.base import Backend, CompletionHandle, EventWaitMixin, \
    TaskSpec, register_backend
from ..backends.transport import (AUTH_TIMEOUT_S, TLSConfig,
                                 client_tls_context, dial_auth, recv_frame,
                                 send_frame, serve_auth, server_tls_context)
from ..errors import ChannelError

__all__ = ["serve", "ServingServer", "ServingClientBackend"]


# --------------------------------------------------------------------------
# Server side
# --------------------------------------------------------------------------

class _SessionSource:
    """Server-side :class:`~.backends.blobstore.PayloadSource` stand-in for
    a blob a client shipped into its session: already encoded, so
    ``encode()`` (pre-puts, ``need`` backfills) just returns the bytes."""

    __slots__ = ("name", "digest", "_blob")
    remote = False

    def __init__(self, digest: bytes, blob: bytes):
        self.name = ""
        self.digest = digest
        self._blob = blob

    def encode(self) -> bytes:
        return self._blob


class _Session:
    """One authenticated client connection: a reader loop (this thread)
    plus a writer thread draining the outbox — completion callbacks from
    the cluster's select loop only enqueue, so relaying a multi-MB result
    never stalls the driver."""

    def __init__(self, server: "ServingServer", sock, tenant: str,
                 sid: int):
        self.server = server
        self.sock = sock
        self.tenant = tenant
        self.sid = sid
        self.send_lock = threading.Lock()
        self.outbox: "queue.SimpleQueue" = queue.SimpleQueue()
        self.expired = False
        self.closed = False
        #: digests this session shipped (sub frames may reference them
        #: again without resending bytes) — bounded by session lifetime
        self.sources: dict = {}
        #: state-reply digests already sent (reply_payload dedup)
        self.known: set = set()
        self.handles: dict = {}                    # fid -> cluster handle
        self._ttl_timer: "threading.Timer | None" = None

    # -- lifecycle -----------------------------------------------------------

    def run(self) -> None:
        inner = self.server.inner
        try:
            send_frame(self.sock, ("welcome", {
                "tenant": self.tenant, "session": self.sid,
                "workers": inner.workers,
                "session_ttl": self.server.session_ttl}), self.send_lock)
        except OSError:
            self._shutdown()
            return
        threading.Thread(target=self._writer, daemon=True,
                         name=f"serving-writer-{self.sid}").start()
        if self.server.session_ttl:
            self._ttl_timer = threading.Timer(self.server.session_ttl,
                                              self.expire)
            self._ttl_timer.daemon = True
            self._ttl_timer.start()
        try:
            while True:
                try:
                    msg = recv_frame(self.sock)
                except (EOFError, ChannelError, OSError):
                    return
                if msg[0] == "bye":
                    return
                self._handle(msg)
        finally:
            self._shutdown()

    def expire(self) -> None:
        """TTL hit: tell the client, then sever. The client maps the
        ``expired`` frame (or the EOF right behind it) to ChannelError on
        every outstanding and future call."""
        self.expired = True
        try:
            send_frame(self.sock, ("expired",), self.send_lock)
        except OSError:
            pass
        try:
            self.sock.shutdown(socket.SHUT_RD)
        except OSError:
            pass

    def _shutdown(self) -> None:
        self.closed = True
        if self._ttl_timer is not None:
            self._ttl_timer.cancel()
        self.outbox.put(None)                       # writer exits
        try:
            self.sock.close()
        except OSError:
            pass
        self.server._forget(self)

    # -- frames --------------------------------------------------------------

    def _handle(self, msg) -> None:
        try:
            self._dispatch_frame(msg)
        except Exception as exc:                     # noqa: BLE001
            # one bad frame must not take the session down; state carries
            # an explicit error status, other RPCs hit the client timeout
            if msg and msg[0] == "state" and len(msg) > 1:
                from .. import state as state_mod
                self.outbox.put(("state_rep", msg[1], "err",
                                 state_mod._safe_exc(exc)))

    def _dispatch_frame(self, msg) -> None:
        op = msg[0]
        if op == "sub":
            self._submit(msg)
        elif op == "free":
            rid = msg[1]
            n = self.server.inner.free_slots_for(self.tenant)
            self.outbox.put(("free_rep", rid, n))
        elif op == "state":
            self._state(msg)
        elif op == "stats":
            self.outbox.put(("stats_rep", msg[1], self._stats()))
        elif op == "cancel":
            handle = self.handles.get(msg[1])
            if handle is not None:
                self.server.inner.cancel(handle)
        # unknown frames are dropped: a newer client talking to an older
        # server degrades feature-by-feature instead of killing the session

    def _submit(self, msg) -> None:
        _op, fid, shipped, refs, blobs, opts = msg
        inner = self.server.inner
        for digest, blob in (blobs or {}).items():
            self.sources[digest] = _SessionSource(digest, bytes(blob))
        try:
            sources = {d: self.sources[d] for d in (refs or ())}
        except KeyError as exc:
            from ..conditions import CapturedRun
            self.outbox.put(("done", fid, CapturedRun(error=ChannelError(
                f"session {self.sid} referenced blob {exc} it never "
                f"shipped")), "err"))
            return
        task = TaskSpec(
            task_id=next(self.server._task_ids), fn=None,
            label=str(opts.get("label", "")),
            capture_stdout=bool(opts.get("capture_stdout", True)),
            capture_conditions=bool(opts.get("capture_conditions", True)),
            seed_declared=bool(opts.get("seed_declared", False)),
            shipped=shipped, payload_sources=sources, tenant=self.tenant)
        try:
            handle = inner.submit_queued(task)
        except Exception as exc:                     # noqa: BLE001
            from ..conditions import CapturedRun
            self.outbox.put(("done", fid, CapturedRun(error=exc), "err"))
            return
        self.handles[fid] = handle
        inner.add_done_callback(
            handle, lambda h, fid=fid: self.outbox.put(("__done__", fid, h)))

    def _state(self, msg) -> None:
        from .. import state as state_mod
        _op, rid, op, args = msg
        svc = state_mod.service()
        args = state_mod.scope_args(op, args, self.tenant)
        if op == "wait":
            key, min_version, timeout = args

            def _run():
                try:
                    value, version = svc.wait(key, int(min_version), timeout)
                except state_mod.StateTimeout:
                    self.outbox.put(("state_rep", rid, "timeout", None))
                    return
                except Exception as exc:             # noqa: BLE001
                    self.outbox.put(("state_rep", rid, "err",
                                     state_mod._safe_exc(exc)))
                    return
                try:
                    payload, digest = svc.reply_payload(
                        key, value, version, self.known)
                except Exception as exc:             # noqa: BLE001
                    self.outbox.put(("state_rep", rid, "err",
                                     state_mod._safe_exc(exc)))
                    return
                if digest is not None:
                    self.known.add(digest)
                self.outbox.put(("state_rep", rid, "ok", (version, payload)))

            threading.Thread(target=_run, daemon=True,
                             name=f"serving-wait-{self.sid}").start()
            return
        status, payload, digest = svc.handle(op, args, self.known,
                                             tenant=self.tenant)
        if digest is not None:
            self.known.add(digest)
        self.outbox.put(("state_rep", rid, status, payload))

    def _stats(self) -> dict:
        from ..backends import transport
        inner = self.server.inner
        mine = inner.tenant_stats().get(self.tenant, {})
        return {"tenant": self.tenant, "session": self.sid,
                "tenant_stats": mine, "wire": transport.wire_stats(),
                "recovery": inner.recovery_stats(by_tenant=True)}

    # -- writer --------------------------------------------------------------

    def _writer(self) -> None:
        while True:
            item = self.outbox.get()
            if item is None:
                return
            if item[0] == "__done__":
                item = self._render_done(item[1], item[2])
                if item is None:
                    continue
            try:
                send_frame(self.sock, item, self.send_lock)
            except (OSError, ChannelError):
                # client gone: keep draining so completion callbacks never
                # block on a full queue; the reader loop tears us down
                continue

    def _render_done(self, fid, handle):
        """Build the ``done`` frame off the completion callback's thread:
        materializing a worker-resident result pulls bytes over sockets
        and must not run on the cluster's select loop."""
        self.handles.pop(fid, None)
        if handle.error is not None:
            from ..conditions import CapturedRun
            return ("done", fid, CapturedRun(error=handle.error), "err")
        run = handle.run
        if getattr(run.value, "is_remote_value", False):
            try:
                run.value = run.value.fetch(writable=True)
            except Exception as exc:                 # noqa: BLE001
                from ..conditions import CapturedRun
                return ("done", fid, CapturedRun(error=exc), "err")
        return ("done", fid, run)


class ServingServer:
    """The long-lived driver: owns the inner cluster backend and the
    authenticated session listener. See the module docstring."""

    def __init__(self, cluster_spec: "dict | None" = None,
                 tokens: "dict[str, str] | None" = None, *,
                 tls: "TLSConfig | bool | None" = None,
                 tenants: "dict | None" = None,
                 session_ttl: "float | None" = None,
                 bind: str = "127.0.0.1", port: int = 0,
                 backend=None):
        if not tokens:
            raise ValueError(
                "serving requires tokens={tenant: token, ...}: an open "
                "serving port would accept arbitrary pickles from anyone "
                "who can reach it")
        self.tokens = dict(tokens)
        self.session_ttl = session_ttl
        if tls is True:
            import tempfile
            from ..backends.transport import generate_self_signed_cert
            tls = generate_self_signed_cert(
                tempfile.mkdtemp(prefix="repro-serving-tls-"))
        self.tls: "TLSConfig | None" = tls or None
        self._tls_ctx = server_tls_context(self.tls) \
            if self.tls is not None else None
        if backend is not None:
            self.inner = backend
            self._own_backend = False
        else:
            from ..backends.cluster import ClusterBackend
            kwargs = dict(cluster_spec or {})
            if tenants is not None:
                kwargs.setdefault("tenants", tenants)
            self.inner = ClusterBackend(**kwargs)
            self._own_backend = True
        if tenants is not None and hasattr(self.inner, "configure_tenants"):
            self.inner.configure_tenants(dict(tenants))
        self._task_ids = itertools.count(1_000_000)
        self._sids = itertools.count(1)
        self._sessions: "set[_Session]" = set()
        self._lock = threading.Lock()
        self._open = True
        self._ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._ls.bind((bind, port))
        self._ls.listen(32)
        self.address = self._ls.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="serving-accept")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, addr = self._ls.accept()
            except OSError:
                return
            threading.Thread(target=self._admit, args=(conn,),
                             daemon=True, name="serving-admit").start()

    def _admit(self, conn) -> None:
        """Security preamble on a dedicated thread: TLS first, then the
        token handshake — a failed/slow handshake costs one thread for at
        most ``AUTH_TIMEOUT_S``, never a session."""
        try:
            conn.settimeout(AUTH_TIMEOUT_S)
            if self._tls_ctx is not None:
                conn = self._tls_ctx.wrap_socket(conn, server_side=True)
            tenant = serve_auth(conn, self.tokens)
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except Exception:                            # noqa: BLE001
            try:
                conn.close()
            except OSError:
                pass
            return
        session = _Session(self, conn, tenant, next(self._sids))
        with self._lock:
            if not self._open:
                session._shutdown()
                return
            self._sessions.add(session)
        session.run()

    def _forget(self, session: _Session) -> None:
        with self._lock:
            self._sessions.discard(session)

    def serve_forever(self) -> None:
        """Block until :meth:`close` (another thread / signal handler)."""
        while self._open:
            time.sleep(0.5)

    def close(self) -> None:
        with self._lock:
            if not self._open:
                return
            self._open = False
            sessions = list(self._sessions)
        try:
            self._ls.close()
        except OSError:
            pass
        for s in sessions:
            try:
                s.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._own_backend:
            self.inner.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def serve(cluster_spec: "dict | None" = None,
          tokens: "dict[str, str] | None" = None, **kwargs) -> ServingServer:
    """Start a serving server: ``serve({"workers": 4}, tokens={"alice":
    "s1"}, tenants={"alice": 3.0}, tls=True, session_ttl=3600)``. Returns
    the :class:`ServingServer` (``.address`` is the dialable endpoint)."""
    return ServingServer(cluster_spec, tokens, **kwargs)


# --------------------------------------------------------------------------
# Client side
# --------------------------------------------------------------------------

class _ServingHandle(CompletionHandle):
    def __init__(self, task: TaskSpec, fid: int):
        super().__init__()
        self.task = task
        self.fid = fid
        self.run = None
        self.error: "BaseException | None" = None


@register_backend("serving")
class ServingClientBackend(EventWaitMixin, Backend):
    """Session-scoped proxy backend: futures resolve on a remote serving
    server under this session's tenant. ``plan("serving",
    addr="host:port", token="...", tls_ca="cert.pem")``."""

    supports_immediate = False
    dispatches_continuations = False

    def __init__(self, addr=None, token: str = "",
                 tls: bool = False, tls_ca: str = "",
                 connect_timeout: float = 10.0):
        if addr is None:
            raise ValueError('plan("serving") requires addr="host:port"')
        if isinstance(addr, str):
            host, _, port = addr.rpartition(":")
            addr = (host or "127.0.0.1", int(port))
        self.addr = tuple(addr)
        self._init_wait()
        self._send_lock = threading.Lock()
        self._fids = itertools.count(1)
        self._rids = itertools.count(1)
        self._pending: "dict[int, _ServingHandle]" = {}
        self._rpc: dict = {}                # rid -> [Event, value]
        self._sent: set = set()             # digests shipped this session
        self._lock = threading.Lock()
        self._down: "BaseException | None" = None
        self._open = True

        sock = socket.create_connection(self.addr, timeout=connect_timeout)
        try:
            sock.settimeout(connect_timeout)
            if tls or tls_ca:
                ctx = client_tls_context(
                    TLSConfig(cafile=tls_ca) if tls_ca else None)
                sock = ctx.wrap_socket(sock, server_hostname=self.addr[0])
            dial_auth(sock, token, timeout=connect_timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            msg = recv_frame(sock)
            if msg[0] != "welcome":
                raise ChannelError(
                    f"expected welcome from serving server, got {msg[0]!r}")
        except (OSError, ChannelError) as exc:
            try:
                sock.close()
            except OSError:
                pass
            if isinstance(exc, ChannelError):
                raise
            raise ChannelError(
                f"serving handshake with {self.addr} failed: "
                f"{exc!r}") from exc
        sock.settimeout(None)
        self.sock = sock
        self.meta = msg[1]
        self.tenant = self.meta.get("tenant", "")
        self._workers = int(self.meta.get("workers", 1))

        from ..backends.blobstore import BlobStore
        from .. import state as state_mod
        self._store = BlobStore(None)
        self._state = state_mod.SockStateClient(sock, self._send_lock,
                                                self._store)
        state_mod.set_default_client(self._state)
        threading.Thread(target=self._reader, daemon=True,
                         name="serving-client-read").start()

    # -- session plumbing ----------------------------------------------------

    def _reader(self) -> None:
        while True:
            try:
                msg = recv_frame(self.sock)
            except BaseException as exc:             # noqa: BLE001
                if self._down is None:
                    self._down = exc
                self._fail_all(self._down)
                return
            kind = msg[0]
            if kind == "done":
                handle = None
                with self._lock:
                    handle = self._pending.pop(msg[1], None)
                if handle is None:
                    continue
                if len(msg) > 3 and msg[3] == "err":
                    handle.error = msg[2].error or ChannelError(
                        f"serving task {msg[1]} failed server-side")
                else:
                    handle.run = msg[2]
                self._complete(handle)
            elif kind == "state_rep":
                self._state.deliver(msg)
            elif kind in ("free_rep", "stats_rep"):
                with self._lock:
                    entry = self._rpc.pop(msg[1], None)
                if entry is not None:
                    entry[1] = msg[2]
                    entry[0].set()
            elif kind == "expired":
                self._down = ChannelError(
                    f"serving session to {self.addr} expired "
                    f"(session_ttl={self.meta.get('session_ttl')}s); "
                    f"re-plan() to open a new session")
                self._fail_all(self._down)
                # keep reading until the server's EOF lands

    def _fail_all(self, exc: BaseException) -> None:
        err = exc if isinstance(exc, ChannelError) else ChannelError(
            f"serving session to {self.addr} lost: {exc!r}")
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
            rpcs = list(self._rpc.values())
            self._rpc.clear()
        for handle in pending:
            handle.error = err
            self._complete(handle)
        for entry in rpcs:
            entry[0].set()
        self._state.fail_all(err)

    def _check_up(self) -> None:
        if self._down is not None:
            raise self._down if isinstance(self._down, ChannelError) \
                else ChannelError(f"serving session lost: {self._down!r}")
        if not self._open:
            raise ChannelError("serving backend is shut down")

    def _call(self, op: str, *args):
        """Blocking session RPC (``free``/``stats``)."""
        self._check_up()
        rid = next(self._rids)
        entry = [threading.Event(), None]
        with self._lock:
            self._rpc[rid] = entry
        try:
            send_frame(self.sock, (op, rid, *args), self._send_lock)
        except OSError as exc:
            with self._lock:
                self._rpc.pop(rid, None)
            raise ChannelError(f"serving {op} failed: {exc!r}") from exc
        if not entry[0].wait(60.0):
            with self._lock:
                self._rpc.pop(rid, None)
            raise ChannelError(f"serving {op} reply never arrived")
        self._check_up()
        return entry[1]

    # -- Backend protocol ----------------------------------------------------

    def submit(self, task: TaskSpec) -> _ServingHandle:
        self._check_up()
        assert task.shipped is not None, \
            "serving backend requires a shipped fn"
        fid = next(self._fids)
        handle = _ServingHandle(task, fid)
        blobs = {}
        refs = list(task.payload_sources)
        for digest, src in task.payload_sources.items():
            if digest not in self._sent:
                blobs[digest] = src.encode()
        opts = {"label": task.label,
                "capture_stdout": task.capture_stdout,
                "capture_conditions": task.capture_conditions,
                "seed_declared": task.seed_declared}
        with self._lock:
            self._pending[fid] = handle
        try:
            send_frame(self.sock,
                       ("sub", fid, task.shipped, refs, blobs, opts),
                       self._send_lock)
        except OSError as exc:
            with self._lock:
                self._pending.pop(fid, None)
            raise ChannelError(
                f"serving submit failed: {exc!r}",
                future_label=task.label) from exc
        self._sent.update(blobs)
        return handle

    def free_slots(self) -> int:
        return int(self._call("free"))

    def try_submit(self, task: TaskSpec):
        if self.free_slots() <= 0:
            return None
        return self.submit(task)

    def poll(self, handle: _ServingHandle) -> bool:
        return handle.done.is_set()

    def collect(self, handle: _ServingHandle):
        handle.done.wait()
        if handle.error is not None:
            raise handle.error
        return handle.run

    def cancel(self, handle: _ServingHandle) -> bool:
        if handle.done.is_set():
            return False
        try:
            send_frame(self.sock, ("cancel", handle.fid), self._send_lock)
        except OSError:
            pass
        return False                     # outcome is the server's call

    def session_stats(self) -> dict:
        """Server-side attribution for this session's tenant: fair-share
        counters, cluster wire stats, per-tenant recovery stats."""
        return self._call("stats")

    def shutdown(self) -> None:
        if not self._open:
            return
        self._open = False
        from .. import state as state_mod
        if state_mod._OVERRIDE_CLIENT is self._state:
            state_mod.set_default_client(None)
        try:
            send_frame(self.sock, ("bye",), self._send_lock)
        except (OSError, ChannelError):
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    @property
    def workers(self) -> int:
        return self._workers


# --------------------------------------------------------------------------
# CLI: python -m repro_torch.core.serving
# --------------------------------------------------------------------------

def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="repro_torch serving server: one warm cluster, many "
                    "authenticated tenant sessions")
    ap.add_argument("--bind", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--workers", type=int, default=2,
                    help="cluster workers to launch")
    ap.add_argument("--tenant", action="append", default=[],
                    metavar="NAME=TOKEN[:WEIGHT]",
                    help="tenant credential (+ optional fair-share "
                         "weight); repeatable")
    ap.add_argument("--tls", action="store_true",
                    help="generate a self-signed cert and serve TLS")
    ap.add_argument("--certfile", default="")
    ap.add_argument("--keyfile", default="")
    ap.add_argument("--session-ttl", type=float, default=None)
    args = ap.parse_args(argv)
    tokens, tenants = {}, {}
    for item in args.tenant:
        name, _, rest = item.partition("=")
        token, _, weight = rest.partition(":")
        if not name or not token:
            ap.error(f"--tenant must be NAME=TOKEN[:WEIGHT], got {item!r}")
        tokens[name] = token
        if weight:
            tenants[name] = {"weight": float(weight)}
    tls: "TLSConfig | bool | None" = None
    if args.certfile:
        tls = TLSConfig(certfile=args.certfile,
                        keyfile=args.keyfile or args.certfile,
                        cafile=args.certfile)
    elif args.tls:
        tls = True
    srv = serve({"workers": args.workers}, tokens,
                tenants=tenants or None, tls=tls,
                session_ttl=args.session_ttl,
                bind=args.bind, port=args.port)
    host, port = srv.address
    print(f"serving on {host}:{port}"
          + (f" (TLS cert: {srv.tls.certfile})" if srv.tls else ""),
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()

