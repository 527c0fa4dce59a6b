"""Worker-process main loop for the processes backend, and the task
execution both the pipe and the socket (``cluster_worker``) workers share.

Protocol (one pickle per message over a multiprocessing Pipe, see
:class:`Channel`):

  parent -> worker : ("put", digest, blob)          content-addressed payload
                     ("task", task_id, blob, refs)  blob = shipped function,
                                                    refs = digests it needs
                     ("nak", digest)                parent cannot serve it
                     ("state_rep", rid, status, p)  shared-state reply
                     ("stop",)
  worker -> parent : ("need", digest)               blob-store backfill
                     ("progress", task_id, payload) immediateConditions, live
                     ("state", rid, op, args)       shared-state op (state.py)
                     ("result", task_id, run)       CapturedRun (sanitized)
                     ("ready",)                     handshake after spawn

Messages are pickled by the shipping pickler (``globals_capture``), not by
``multiprocessing``'s: torch registers CUDA-IPC and shared-memory
reductions for tensors with that one, and the port's tensors cross the pipe
as their bytes instead (a result tensor on the card comes back through a
host copy and is rebuilt on the card).

Large globals arrive as ``put`` payloads at most once (the parent tracks
what this worker holds) and live in a bounded LRU :class:`BlobStore`; a
task whose refs were evicted asks them back with ``need``.

Unexpected worker death is detected by the parent as EOF/broken pipe and
surfaces as WorkerDiedError — the paper's 'terminated R workers' case. A
task that cannot even be decoded here (a missing module, a CUDA payload on
a worker without a card) fails with its error instead of killing the
worker.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
import struct
import threading
from typing import Any

from .blobstore import BlobStore

_LEN = struct.Struct("!Q")


class Channel:
    """One end of a worker pipe, carrying whole messages: an 8-byte length,
    then the message pickled by the shipping pickler (tensors as raw
    bytes). A message is read into one buffer of its length: the
    connection's own ``recv_bytes`` asks the OS for the whole remainder at
    every read, which took 164.7 s for a 608 MB message on an H100 host
    (``scripts/pipe_bench.py``). ``send`` may be called from several
    threads."""

    def __init__(self, conn):
        self.conn = conn                     # owns the descriptor
        self._file = io.FileIO(conn.fileno(), "r+", closefd=False)
        self._send_lock = threading.Lock()

    def send(self, msg) -> None:
        from ..globals_capture import dumps_robust
        data = dumps_robust(msg)
        with self._send_lock:
            for part in (_LEN.pack(len(data)), data):
                view = memoryview(part)
                while view:
                    view = view[self._file.write(view):]

    def recv(self):
        (n,) = _LEN.unpack(self._read(_LEN.size))
        return pickle.loads(self._read(n))

    def _read(self, n: int) -> bytearray:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = self._file.readinto(view[got:])
            if not k:
                raise EOFError("worker pipe closed")
            got += k
        return buf

    def close(self) -> None:
        self.conn.close()


def _sanitize_run(run) -> Any:
    """Make a CapturedRun safely picklable (exception objects may not be)."""
    from ..globals_capture import dumps_robust
    if run.error is not None:
        try:
            dumps_robust(run.error)
        except Exception:                                   # noqa: BLE001
            run = dataclasses.replace(
                run, error=RuntimeError(
                    f"{type(run.error).__name__}: {run.error}"))
    from .blobstore import array_nbytes
    if array_nbytes(run.value) is not None:
        # an array or tensor always ships (as its bytes): no trial pickle,
        # and no second host copy of a result on the card
        return run
    try:
        dumps_robust(run.value)
    except Exception as exc:                                # noqa: BLE001
        run = dataclasses.replace(
            run, value=None,
            error=RuntimeError(
                f"future value of type {type(run.value).__name__} "
                f"is not exportable from the worker: {exc}"),
        )
    return run


def execute_shipped(blob: bytes, emit, resolve_ref=None) -> Any:
    """Resolve one shipped task blob: unship the function (content-addressed
    globals resolved through ``resolve_ref``), evaluate under capture_run,
    sanitize for the trip home."""
    import contextlib

    from ..conditions import capture_run
    from ..globals_capture import payload_resolver, unship_function
    from ..rng import rng_scope

    with payload_resolver(resolve_ref) if resolve_ref is not None \
            else contextlib.nullcontext():
        # nested shipped functions (e.g. future_map's chunk runner carrying
        # the user fn as a default) rebuild during these loads and resolve
        # their PayloadRefs through the ambient resolver
        payload = pickle.loads(blob)
        fn = unship_function(payload["fn"], resolve_ref=resolve_ref)
    with rng_scope(payload["seed_declared"]):
        run = capture_run(
            lambda: fn(*payload["args"], **payload["kwargs"]),
            capture_stdout=payload["capture_stdout"],
            capture_conditions=payload["capture_conditions"],
            immediate_emit=emit,
        )
    return _sanitize_run(run)


def error_run(exc: Exception) -> Any:
    """A CapturedRun carrying a failure produced *outside* the user's
    function (an unservable payload digest, an undecodable task)."""
    from ..conditions import CapturedRun
    return _sanitize_run(CapturedRun(error=exc))


def hold_result(store: BlobStore, run, threshold: "int | None" = None, *,
                put=None):
    """Worker-resident results (the cluster's dataflow): when ``run.value``
    encodes (losslessly — never through the opt-in int8 codec) to
    ``threshold`` bytes or more, park the blob in this worker's own store
    under its content digest and replace the value with a
    :class:`~.blobstore.PayloadRef`. Returns ``(run, held)`` where ``held``
    is the ``((digest, nbytes),)`` manifest for the result frame — empty
    when the value travels inline.

    A tensor on the card is encoded through a host copy; whoever decodes
    the blob (a chained task on this worker, a peer, the driver) rebuilds
    it on its own card. The digest is computed over the *encoded blob*, so
    it names exactly the bytes a fetch/offer exchange will move. ``put``
    (default ``store.put``) parks the blob; the cluster worker's counts
    the copy as reported with it."""
    from . import transport
    from .blobstore import (PayloadRef, RESULT_REF_THRESHOLD, array_nbytes,
                            blob_digest)
    if threshold is None:
        threshold = RESULT_REF_THRESHOLD
    if run.error is not None:
        return run, ()
    value = run.value
    if value is None or isinstance(value, (bool, int, float)):
        return run, ()
    nbytes = array_nbytes(value)
    if nbytes is not None and nbytes < threshold:
        return run, ()
    try:
        blob = transport.encode_payload(value, int8=False)
    except Exception:                                       # noqa: BLE001
        return run, ()                 # unencodable: ship inline
    if len(blob) < threshold:
        return run, ()
    digest = blob_digest(blob)
    (put or store.put)(digest, blob)
    run = dataclasses.replace(run, value=PayloadRef(digest))
    return run, ((digest, len(blob)),)


def ensure_refs(store: BlobStore, refs, send_need, recv_msg,
                peer_fetch=None, on_peer_fetched=None) -> "str | None":
    """Make sure every digest in ``refs`` is present in ``store``, asking
    the driver with ``send_need(digest)`` and pumping ``recv_msg()`` for the
    ``put`` answers. Returns ``"stop"`` if a stop message arrived
    mid-backfill (propagated to the main loop), raises ChannelError if the
    driver naks.

    ``peer_fetch(digest) -> blob | None`` is tried first for each missing
    digest (the cluster worker's worker-to-worker fetch along the driver's
    location hints); digests a peer cannot serve fall through to the
    ``need`` driver-fallback path, so a partitioned or evicted peer costs
    one failed fetch, never a stuck task. ``on_peer_fetched(digest,
    nbytes)`` fires after each successful peer fetch — the cluster worker
    uses it to tell the driver it now holds a copy (replica promotion)."""
    from ..errors import ChannelError
    missing = [d for d in refs if d not in store]
    if not missing:
        return None
    if peer_fetch is not None:
        still = []
        for d in missing:
            blob = peer_fetch(d)
            if blob is not None:
                store.put(d, blob)
                if on_peer_fetched is not None:
                    on_peer_fetched(d, len(blob))
            else:
                still.append(d)
        missing = still
        if not missing:
            return None
    for d in missing:
        send_need(d)
    waiting = set(missing)
    while waiting:
        msg = recv_msg()
        if msg[0] == "put":
            store.put(msg[1], msg[2])
            waiting.discard(msg[1])
        elif msg[0] == "nak":
            raise ChannelError(
                f"driver cannot serve payload {msg[1].hex()[:12]} "
                f"(blob evicted everywhere?)")
        elif msg[0] == "stop":
            return "stop"
        # anything else (e.g. a late message) is ignored during backfill
    return None


def worker_main(conn, nested_stack_blob: bytes, session_seed: int,
                blob_store_bytes: "int | None" = None) -> None:
    """Entry point of a spawned worker process."""
    import torch

    from .. import planning as plan_mod
    from .. import rng as rng_mod
    from ..state import PipeStateClient, state_context

    # Workers must see a *popped* plan stack (nested-parallelism protection)
    # and must never oversubscribe numeric libraries (torch was imported
    # with this module, so its thread pool is set here as well).
    if "OMP_NUM_THREADS" not in os.environ:
        os.environ["OMP_NUM_THREADS"] = "1"
        torch.set_num_threads(1)
    conn = Channel(conn)
    nested = pickle.loads(nested_stack_blob)
    plan_mod._TLS.stack = tuple(nested)         # worker-local plan stack
    rng_mod.set_session_seed(session_seed)

    store = BlobStore(blob_store_bytes)
    # shared-state client: task bodies calling `repro_torch.core.state.*`
    # reach the parent's in-process StateService over this same pipe — the
    # main thread is the pipe's only reader, and only calls while inside a
    # task
    st_client = PipeStateClient(conn, store=store)
    conn.send(("ready",))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg[0] == "stop":
            return
        if msg[0] == "put":
            store.put(msg[1], msg[2])
            continue
        if msg[0] != "task":
            continue
        task_id, blob = msg[1], msg[2]
        refs = msg[3] if len(msg) > 3 else ()

        def emit(cond, _tid=task_id):
            try:
                conn.send(("progress", _tid, cond))
            except (OSError, ValueError):
                pass

        try:
            # pin the task's refs so a backfill put for one missing ref
            # cannot evict a sibling ref of the same task
            with store.pinned(refs):
                stopped = ensure_refs(store, refs,
                                      lambda d: conn.send(("need", d)),
                                      conn.recv)
                if stopped == "stop":
                    return
                with state_context(st_client):
                    run = execute_shipped(
                        blob, emit,
                        resolve_ref=lambda r: store.resolve(r.digest))
        except (EOFError, OSError):
            return                           # channel gone mid-backfill
        except Exception as exc:                             # noqa: BLE001
            # the task could not be decoded (or its payload served): it
            # fails with that error, and the worker stays up
            run = error_run(exc)
        try:
            conn.send(("result", task_id, run))
        except (OSError, ValueError):
            return
