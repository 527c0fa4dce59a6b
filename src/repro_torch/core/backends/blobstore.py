"""Content-addressed payload store for shipped globals.

The automatic-globals design (paper §Globals) ships the snapshot with every
future, which is quadratically wasteful for the dominant workload — repeated
``future_map`` / step dispatch over the same multi-MB arrays or tensors.
This module is the driver/worker halves of the fix:

* :func:`content_digest` — a 16-byte blake2b identity for a snapshot value.
  Arrays and tensors are hashed over ``(kind, dtype, shape, codec[,
  device], raw bytes)`` without ever being pickled (the active array codec
  is part of the identity: a digest names the bytes that ship, so toggling
  ``set_array_codec`` never replays a blob encoded under the other codec);
  everything else is hashed over its robust pickle. Identical content gets
  the same digest no matter how many futures reference it, and a *mutated*
  mutable container (list/dict/set — deep-copied by the snapshot at
  creation) gets a new digest automatically — content addressing subsumes
  invalidation.

  The digest of an array is memoized by object identity, so repeated
  dispatch of the same tensor never re-hashes (or, on the card, re-copies)
  its bytes. A numpy array is treated as immutable (the reference's
  contract). A torch tensor can be written in place — the port keeps
  tensors by reference in snapshots, and a decode step writes its KV caches
  in place — so a tensor's memo entry is also keyed on its version counter
  (``Tensor._version``, bumped by every in-place write and shared by its
  views): a tensor written between two futures is hashed again and ships
  its new bytes.
* :class:`PayloadRef` — the small picklable marker that replaces a large
  value inside a shipped snapshot; the worker resolves it from its store.
* :class:`PayloadSource` — the driver-side handle that can (re-)encode the
  referenced value on demand: for a worker that has never seen the digest,
  or for a ``("need", digest)`` backfill after the worker's LRU evicted it.
* :class:`BlobStore` — bounded LRU of encoded blobs (by total payload
  bytes), shared by workers (their cache) and the driver (its re-send
  cache), plus a decoded-object cache for array payloads so a cache hit
  skips deserialization entirely.

**The decoded-object cache shares tensors.** A numpy array decoded from a
blob is handed out read-only, as in the reference. torch has no read-only
flag: a tensor decoded on a worker (on the CPU, or on the card for a CUDA
global) is one tensor object that every later task on that worker resolving
the same digest receives — not a copy. A task body must not write to a
shipped tensor in place; one that needs to clones it first
(``x = x.clone()``). A driver-side in-place write is a different matter:
it bumps the tensor's version, so the next future ships a new digest.

Tensors ride as raw bytes on the wire, never through CUDA IPC or
shared-memory storage: a CUDA tensor is copied to the host, and rebuilt on
a CUDA device by the worker — or refused, with an error, when the worker
has none (it is never rebuilt on the CPU). bf16 (which numpy lacks) rides
as its 2-byte words and is rebuilt as a ``torch.bfloat16`` view.

Wire protocol built on these (see ``worker.py``, ``transport.py`` and
``cluster.py``): a task message carries the digests it references; the
driver prepends ``("put", digest, blob)`` messages for any digest the worker
is not known to hold; a worker that is missing a digest anyway (eviction,
self-healed replacement with a cold cache) asks with ``("need", digest)``
and the driver re-serves it from the in-flight task's pinned sources.

The cluster's stores also hold *results*: a cluster task whose result
encodes to ``RESULT_REF_THRESHOLD`` bytes or more stays worker-resident —
the worker puts the encoded blob in its own store and sends back
``run.value = PayloadRef(digest)`` plus a ``held`` manifest. A held tensor
on the card is encoded through a host copy and decoded back onto the card
of whichever process needs it: nothing assumes the holder and the driver
share a device or a CUDA context. Driver-side those refs surface as:

* :class:`RemoteValue` — the lazy driver-side face of a worker-resident
  result. ``Future.value()`` calls :meth:`RemoteValue.fetch` to pull the
  blob on demand; continuation chains never do — they ship the ref back
  out (see ``future._remote_chain``) so the bytes stay on the workers. A
  fetch that finds no live copy (its holder died, evicted everywhere)
  raises :class:`~..errors.LineageExhaustedError`: the port keeps no
  lineage to rebuild it from yet.
* :class:`RemoteSource` — a :class:`PayloadSource` stand-in whose
  ``encode()`` *pulls* the blob from a live holder instead of re-encoding a
  local value, so the put/need/nak machinery serves remote args unchanged.
"""

from __future__ import annotations

import hashlib
import sys
import threading
import weakref
from collections import OrderedDict
from typing import Any

#: snapshot values whose payload reaches this size become content-addressed
#: refs instead of travelling inline in every task blob
PAYLOAD_REF_THRESHOLD = 16 * 1024

#: blob cache bound (encoded bytes) of the driver and, by default, of each
#: worker; a plan sets its workers' own with
#: ``plan("processes", blob_store_bytes=...)``. The driver's needs no knob:
#: the processes backend pins an in-flight task's sources in it, so a
#: payload larger than the bound is still encoded once a task.
DEFAULT_STORE_BYTES = 256 * 1024 * 1024

#: cluster task results whose lossless encoding reaches this size stay
#: worker-resident as a PayloadRef/RemoteValue instead of riding the result
#: frame; small results travel inline
RESULT_REF_THRESHOLD = 64 * 1024


def _torch_tensor(value: Any) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(value, torch.Tensor)


#: integer words of an element's width, for dtypes numpy lacks (bf16)
_WORDS = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _tensor_words(t) -> Any:
    """Host ndarray of a tensor's bytes: the tensor itself where numpy has
    its dtype, else its words of the same width (bf16 as 2-byte words). A
    CUDA tensor is copied to the host; a CPU tensor is viewed, not
    copied."""
    import torch
    t = t.detach()
    if not t.is_contiguous():
        t = t.contiguous()
    if t.device.type != "cpu":
        t = t.cpu()                           # the host copy of a CUDA tensor
    try:
        return t.numpy()
    except TypeError:
        return t.view(getattr(torch, _WORDS[t.element_size()])).numpy()


def as_ndarray(value: Any):
    """``(ndarray, kind)`` view of an array-like value, else ``(None, None)``.

    ``kind`` records what to rebuild on the worker: ``"np"`` for numpy,
    ``"torch"`` for a torch tensor (rebuilt with its dtype on its device
    type; the ndarray holds its bytes, see :func:`_tensor_words`).
    """
    import numpy as np
    if isinstance(value, np.ndarray):
        return value, "np"
    if _torch_tensor(value):
        return _tensor_words(value), "torch"
    return None, None


def array_nbytes(value: Any) -> "int | None":
    """Payload bytes of an array-like value without touching its data (a
    CUDA tensor is not copied), else ``None``."""
    import numpy as np
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if _torch_tensor(value):
        return int(value.numel()) * int(value.element_size())
    return None


def array_meta(value: Any, arr, kind: str) -> dict:
    """The codec header of an array payload. A numpy array's is the
    reference's, key for key (its blobs are byte-identical); a tensor's
    names its torch dtype and its device type as well."""
    if kind == "torch":
        return {"dtype": str(value.dtype).removeprefix("torch."),
                "shape": tuple(value.shape), "kind": kind,
                "device": value.device.type}
    return {"dtype": arr.dtype.name, "shape": arr.shape, "kind": kind}


class PayloadRef:
    """Placeholder for a content-addressed payload inside a shipped
    snapshot. Pickles to a few dozen bytes; the worker swaps it for the
    decoded value from its :class:`BlobStore` before evaluation."""

    __slots__ = ("digest",)

    def __init__(self, digest: bytes):
        self.digest = digest

    def __reduce__(self):
        return (_resolve_or_ref, (self.digest,))

    def __repr__(self):
        return f"PayloadRef({self.digest.hex()[:12]})"


def _resolve_or_ref(digest: bytes):
    """Unpickle-time face of :class:`PayloadRef`: under an ambient payload
    resolver (a worker decoding a task, see ``globals_capture.
    payload_resolver``) the ref resolves straight to its store value, so a
    content-addressed ref may ride *anywhere* inside shipped args / kwargs /
    snapshot structures — not only at the top level the explicit
    ``unship_function`` swap covers. Without a resolver it reconstructs as
    an inert ``PayloadRef``."""
    from ..globals_capture import _RESOLVER
    fn = getattr(_RESOLVER, "fn", None)
    ref = PayloadRef(digest)
    return ref if fn is None else fn(ref)


# --------------------------------------------------------------------------
# Content digests (+ an identity memo so repeated dispatch of the same
# array object never re-hashes its gigabytes)
# --------------------------------------------------------------------------

def _version(value: Any):
    """A tensor's in-place write counter; ``None`` for other values."""
    return value._version if _torch_tensor(value) else None


class _DigestMemo:
    """``id(value) -> digest`` memo with weakref validation, and for a
    tensor its version counter too (see the module docstring).

    Snapshot arrays are captured by reference, so repeated futures over the
    same array present the *same object*; hashing it once is enough while
    its contents are unchanged. The weakref guards against id reuse after
    garbage collection; values that do not support weakrefs (lists, dicts —
    deep-copied per future anyway) are simply not memoized.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._memo: dict[int, tuple] = {}   # id -> (weakref, digest, version)

    def get(self, value: Any) -> "bytes | None":
        with self._lock:
            entry = self._memo.get(id(value))
        if entry is not None and entry[0]() is value \
                and entry[2] == _version(value):
            return entry[1]
        return None

    def put(self, value: Any, digest: bytes, version=None) -> None:
        key = id(value)

        def _drop(_wr, key=key, self=self):
            with self._lock:
                self._memo.pop(key, None)

        try:
            wr = weakref.ref(value, _drop)
        except TypeError:
            return
        with self._lock:
            self._memo[key] = (wr, digest, version)

    def clear(self) -> None:
        """Drop every memoized digest (the array codec changed, so cached
        digests no longer identify the bytes that would ship)."""
        with self._lock:
            self._memo.clear()


_MEMO = _DigestMemo()


def _array_digest(value: Any, arr, kind: str) -> bytes:
    import numpy as np
    from . import transport
    arr = np.ascontiguousarray(arr)
    meta = array_meta(value, arr, kind)
    # The digest identifies the *bytes that ship*, not just the content:
    # the codec that would encode this array is folded in so toggling
    # ``set_array_codec`` can never replay a blob encoded under the other
    # codec from any digest-keyed cache (driver store, worker stores,
    # per-worker ``known`` sets).
    codec = "int8" if (transport.ARRAY_CODEC_INT8
                       and meta["dtype"] in ("float32", "bfloat16")) \
        else "raw"
    h = hashlib.blake2b(digest_size=16)
    if kind == "torch":
        # a tensor's identity holds its torch dtype (bf16 and int16 words
        # share their bytes) and the device type it is rebuilt on
        h.update(f"{kind}|{meta['dtype']}|{meta['shape']}|{codec}|"
                 f"{meta['device']}".encode())
    else:
        h.update(f"{kind}|{arr.dtype.str}|{arr.shape}|{codec}".encode())
    h.update(raw_byte_view(arr))
    return h.digest()


def raw_byte_view(arr) -> memoryview:
    """Flat uint8 memoryview of a C-contiguous array's bytes. Dtypes that
    do not export the buffer protocol go through a zero-copy uint8 view."""
    if arr.nbytes == 0:
        return memoryview(b"")
    try:
        return memoryview(arr).cast("B")
    except (ValueError, TypeError):
        import numpy as np
        return memoryview(arr.view(np.uint8)).cast("B")


def blob_digest(blob: bytes) -> bytes:
    return hashlib.blake2b(blob, digest_size=16).digest()


def content_digest(value: Any) -> "bytes | None":
    """Digest for an array-like value (memoized by object identity and, for
    a tensor, its version). Returns ``None`` for non-arrays — those are
    digested over their pickle by the caller, which needs the pickle bytes
    anyway."""
    if array_nbytes(value) is None:
        return None
    version = _version(value)
    digest = _MEMO.get(value)
    if digest is None:
        arr, kind = as_ndarray(value)
        digest = _array_digest(value, arr, kind)
        _MEMO.put(value, digest, version)
    return digest


# --------------------------------------------------------------------------
# Driver-side payload sources
# --------------------------------------------------------------------------

class PayloadSource:
    """One large global pinned for the lifetime of its task: name (for the
    error-feedback codec), digest, the live value, and an optional
    pre-computed pickle (non-array payloads already paid for it)."""

    __slots__ = ("name", "digest", "value", "pickled", "int8", "blob")

    def __init__(self, name: str, digest: bytes, value: Any,
                 pickled: "bytes | None" = None):
        self.name = name
        self.digest = digest
        self.value = value
        self.pickled = pickled
        self.blob = None
        # ``digest`` folded in the codec active *now* (``_array_digest``);
        # capture that codec so a ``set_array_codec`` toggle between future
        # creation and (possibly lazy) dispatch cannot cache a blob encoded
        # under the other codec beneath this digest
        from . import transport
        self.int8 = transport.ARRAY_CODEC_INT8

    def encode(self) -> bytes:
        """Encoded blob for the wire, served from the driver store when the
        digest was encoded before (so every worker sees identical bytes)."""
        from . import transport
        blob = self.blob
        if blob is not None:
            return blob
        blob = DRIVER_STORE.get(self.digest)
        if blob is None:
            blob = transport.encode_payload(self.value, name=self.name,
                                            pickled=self.pickled,
                                            int8=self.int8,
                                            digest=self.digest)
            DRIVER_STORE.put(self.digest, blob)
        if blob[0] == transport.P_INT8:
            # int8+EF bytes depend on mutable residual state (the per-name
            # replay cache is bounded), so pin them on the source for the
            # task's lifetime: a backfill for an in-flight digest must
            # replay these exact bytes no matter what the driver store and
            # EF cache have evicted since. Deterministic codecs (raw array,
            # pickle) re-encode identically and need no pin.
            self.blob = bytes(blob) if not isinstance(blob, bytes) else blob
        return blob


def encode_backfill(src: "PayloadSource | None") -> "bytes | None":
    """Encode one pinned source to answer a worker's ``("need", digest)``;
    ``None`` means the caller must send ``("nak", digest)``. *Any* encode
    failure (pickling/codec error) maps to nak rather than raising: the
    worker is blocked in ``ensure_refs``, so nothing else would ever
    unstick the task."""
    if src is None:
        return None
    try:
        return src.encode()
    except Exception:                        # noqa: BLE001
        return None


# --------------------------------------------------------------------------
# Worker-resident results (remote values)
# --------------------------------------------------------------------------

class RemoteValue:
    """Driver-side face of a result blob that stayed on its producing
    worker. ``Future.value()`` pulls it on demand via :meth:`fetch`; a
    continuation chained onto the future never pulls — the digest ships
    back out as a ~500 B control frame and the holder (or a peer, via the
    fetch/offer protocol) supplies the bytes worker-side.

    Holds only a *weak* reference to the owning backend: a remote value
    must not keep a shut-down cluster pool alive, and a dead referent turns
    into a clean :class:`~..errors.ChannelError` at fetch time.
    """

    is_remote_value = True

    __slots__ = ("digest", "nbytes", "label", "_backend", "__weakref__")

    def __init__(self, digest: bytes, nbytes: int, backend, label: str = ""):
        self.digest = digest
        self.nbytes = int(nbytes)
        self.label = label
        self._backend = weakref.ref(backend)

    def backend(self):
        return self._backend()

    def fetch(self, writable: bool = True):
        """Pull and decode the blob from whoever holds it (driver store,
        holder). A tensor is decoded by the payload codec on this process's
        device of its type, into memory of its own (writable); ``writable``
        copies a read-only numpy array, matching what an inline result
        frame would have delivered."""
        backend = self._backend()
        if backend is None:
            from ..errors import ChannelError
            raise ChannelError(
                f"remote result {self!r} outlived its cluster backend; "
                f"fetch the value (Future.value()) before shutdown()")
        value = backend.pull_value(self.digest, label=self.label)
        if writable:
            import numpy as np
            if isinstance(value, np.ndarray) and not value.flags.writeable:
                value = value.copy()
        return value

    def source(self) -> "RemoteSource":
        return RemoteSource(self.digest, self.nbytes, self._backend,
                            label=self.label, anchor=self)

    def __reduce__(self):
        raise TypeError(
            f"{self!r} is a worker-resident result and cannot be pickled "
            f"directly; pass it to a future (it ships as a content-"
            f"addressed ref) or materialize it with Future.value()")

    def __repr__(self):
        tag = f" {self.label!r}" if self.label else ""
        return (f"RemoteValue({self.digest.hex()[:12]}, "
                f"{self.nbytes}B{tag})")


class RemoteSource:
    """A :class:`PayloadSource` stand-in for a digest whose bytes live on a
    worker, not the driver. ``encode()`` *pulls* the blob from a live
    holder (landing it in ``DRIVER_STORE`` for replay), so the put / need /
    nak machinery serves remote args without knowing they are remote.
    Dispatch paths that *can* avoid the pull check :attr:`remote` and send
    peer-fetch hints instead."""

    remote = True

    __slots__ = ("name", "digest", "nbytes", "_backend", "_anchor")

    def __init__(self, digest: bytes, nbytes: int, backend_ref,
                 label: str = "", anchor=None):
        self.name = label or f"<remote:{digest.hex()[:12]}>"
        self.digest = digest
        self.nbytes = int(nbytes)
        self._backend = backend_ref
        # strong ref to the originating RemoteValue: while a chained task
        # holds this source (pinned on its in-flight handle), the handle's
        # GC-driven release must not evict the blob out from under it
        self._anchor = anchor

    def holder_backend(self):
        return self._backend()

    def encode(self) -> bytes:
        backend = self._backend()
        if backend is None:
            from ..errors import ChannelError
            raise ChannelError(
                f"remote payload {self.digest.hex()[:12]} outlived the "
                f"cluster backend that held it")
        return backend.pull_blob(self.digest, label=self.name)


# --------------------------------------------------------------------------
# The bounded LRU blob store
# --------------------------------------------------------------------------

class BlobStore:
    """Bounded LRU map of ``digest -> encoded blob`` plus a decoded-object
    cache for payloads whose decode may be shared (arrays, handed out
    read-only; tensors, shared by contract — see the module docstring).

    Thread-safe; eviction is by total encoded bytes, oldest-touched first.
    The object cache entry is evicted together with its blob.
    """

    def __init__(self, max_bytes: "int | None" = None):
        self.max_bytes = DEFAULT_STORE_BYTES if max_bytes is None \
            else int(max_bytes)
        self._lock = threading.Lock()
        self._blobs: "OrderedDict[bytes, Any]" = OrderedDict()
        self._objects: dict[bytes, Any] = {}
        self._pins: dict[bytes, int] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __contains__(self, digest: bytes) -> bool:
        with self._lock:
            return digest in self._blobs

    def pinned(self, digests) -> "_PinScope":
        """Context manager pinning ``digests`` against eviction for the
        duration of one task: a backfill ``put`` for one missing ref must
        never evict a sibling ref of the same task (the store may
        transiently exceed ``max_bytes`` by the pinned working set)."""
        return _PinScope(self, tuple(digests))

    def put(self, digest: bytes, blob) -> None:
        if not isinstance(blob, bytes):
            # normalize bytes-like views to immutable bytes so decoded
            # raw-array payloads really are read-only
            blob = bytes(blob)
        with self._lock:
            old = self._blobs.pop(digest, None)
            if old is not None:
                self._bytes -= len(old)
                if old != blob:
                    # byte-different replacement for a digest: drop the
                    # decoded-object cache entry or resolve() would keep
                    # serving the value decoded from the old bytes
                    self._objects.pop(digest, None)
            self._blobs[digest] = blob
            self._bytes += len(blob)
            if self._bytes <= self.max_bytes:    # common case: no O(n) scan
                return
            evictable = [d for d in self._blobs if d not in self._pins]
            for victim in evictable:
                if self._bytes <= self.max_bytes or len(self._blobs) <= 1:
                    break
                self._bytes -= len(self._blobs.pop(victim))
                self._objects.pop(victim, None)
                self.evictions += 1

    def get(self, digest: bytes):
        with self._lock:
            blob = self._blobs.get(digest)
            if blob is None:
                self.misses += 1
                return None
            self._blobs.move_to_end(digest)
            self.hits += 1
            return blob

    def drop(self, digest: bytes) -> bool:
        """Explicitly evict one blob (driver-side GC release: the digest's
        last ``RemoteValue`` handle died). Pinned digests — referenced by a
        task currently executing here — are left alone. True iff the blob
        was removed."""
        with self._lock:
            if digest in self._pins:
                return False
            blob = self._blobs.pop(digest, None)
            if blob is None:
                return False
            self._bytes -= len(blob)
            self._objects.pop(digest, None)
            self.evictions += 1
            return True

    def resolve(self, digest: bytes) -> Any:
        """Decoded value for ``digest`` (decoded-object cache first).
        Raises :class:`~..errors.ChannelError` if the blob is absent —
        the put/need protocol (plus per-task pinning) guarantees presence
        before evaluation starts, so absence is a protocol fault the task
        reports rather than a reason to kill the worker."""
        with self._lock:
            if digest in self._objects:
                self._blobs.move_to_end(digest)
                self.hits += 1
                return self._objects[digest]
        blob = self.get(digest)
        if blob is None:
            from ..errors import ChannelError
            raise ChannelError(
                f"payload {digest.hex()[:12]} missing from the blob store "
                f"at evaluation time")
        from . import transport
        value, cacheable = transport.decode_payload(blob)
        if cacheable:
            with self._lock:
                if digest in self._blobs:        # not evicted meanwhile
                    self._objects[digest] = value
        return value

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._blobs), "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "max_bytes": self.max_bytes}


class _PinScope:
    def __init__(self, store: BlobStore, digests: tuple):
        self._store = store
        self._digests = digests

    def __enter__(self):
        with self._store._lock:
            for d in self._digests:
                self._store._pins[d] = self._store._pins.get(d, 0) + 1
        return self

    def __exit__(self, *exc):
        with self._store._lock:
            for d in self._digests:
                n = self._store._pins.get(d, 0) - 1
                if n <= 0:
                    self._store._pins.pop(d, None)
                else:
                    self._store._pins[d] = n
        return False


#: driver-process re-send cache (digest -> encoded blob)
DRIVER_STORE = BlobStore(DEFAULT_STORE_BYTES)
