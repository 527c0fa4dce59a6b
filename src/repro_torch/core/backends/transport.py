"""The payload codec layer: how a content-addressed payload is encoded
into the blob that rides a ``("put", digest, blob)`` message, and decoded
on the other side.

Payload blobs have their own 1-byte codec:

  ``0`` pickle     — robust pickle of the value
  ``1`` int8+EF    — float32/bfloat16 array or tensor quantized per-tensor
                     to int8 with an fp32 scale (``optim/compression.py``),
                     ~4x smaller than raw. A driver-side
                     :class:`ErrorFeedback` residual per global name
                     re-injects the quantization error the next time that
                     global ships with *new* content (EF-SGD), so
                     repeatedly shipped, slowly-evolving tensors do not
                     accumulate bias.
  ``2`` raw array  — ndarrays and tensors: a dtype/shape header + raw bytes
                     (no pickle round-trip). A tensor's header also names
                     its device type; a CUDA tensor's bytes are copied to
                     the host, and it is rebuilt on a CUDA device.
  ``3`` zlib pickle — a compressible pickle of 64 KiB or more

A numpy array encodes to the same bytes as in the reference package (the
header is the same pickle, key for key), so either side decodes the other's
blobs. bf16 has no numpy dtype without ``ml_dtypes``: a bf16 tensor rides
as its 2-byte words and is rebuilt as a ``torch.bfloat16`` view (the same
bits as the reference's bf16 array body).

The int8+EF codec is **lossy** (one quantization step of error per ship),
which would break backend transparency — the same program must compute the
same numbers under ``plan("processes")`` as under ``plan("sequential")`` —
so it is strictly opt-in: float arrays ship losslessly via codec 2 by
default. Call :func:`set_array_codec` ``("int8")`` to enable it for
workloads that tolerate quantization (gradient/parameter shipping).

The socket frames of the reference (length-prefixed, out-of-band buffers),
its TLS and its token preamble belong to the TCP cluster backend, which the
port does not have yet; the processes backend's messages ride a pipe (see
``worker.py``).
"""

from __future__ import annotations

import pickle
import struct
import threading
import warnings
import zlib
from collections import OrderedDict
from typing import Any

from ..errors import ChannelError
from .blobstore import array_meta

#: pickles at least this large are candidates for zlib compression
COMPRESS_THRESHOLD = 64 * 1024
#: zlib level — 1 keeps the driver loop cheap; float-array pickles gain
#: little from higher levels at several times the CPU cost
COMPRESS_LEVEL = 1

# payload-blob codecs (first byte of a ``put`` body)
P_PICKLE, P_INT8, P_RAWARR, P_ZPICKLE = 0, 1, 2, 3

#: route float32/bf16 payloads through the lossy int8+EF codec. Off by
#: default — backends must be numerically transparent, so quantization is
#: an explicit opt-in via :func:`set_array_codec`.
ARRAY_CODEC_INT8 = False


def set_array_codec(codec: str) -> None:
    """Select the float-array payload codec: ``"raw"`` (lossless, the
    default) or ``"int8"`` (int8+EF, ~4x smaller, up to one quantization
    step of error per shipped value — opt in only when the workload
    tolerates it, e.g. gradient/parameter shipping)."""
    global ARRAY_CODEC_INT8
    if codec not in ("raw", "int8"):
        raise ValueError(f"unknown array codec {codec!r}; "
                         f"expected 'raw' or 'int8'")
    flag = codec == "int8"
    if flag != ARRAY_CODEC_INT8:
        ARRAY_CODEC_INT8 = flag
        # content digests fold the codec in (blobstore._array_digest), so
        # memoized digests computed under the old codec are stale
        from .blobstore import _MEMO
        _MEMO.clear()


# --------------------------------------------------------------------------
# Wire accounting (the cluster's socket frames count here; a pipe does not)
# --------------------------------------------------------------------------

_WIRE_LOCK = threading.Lock()
_WIRE = {"bytes_sent": 0, "frames_sent": 0, "bytes_recv": 0,
         "frames_recv": 0}


def wire_stats() -> dict:
    """Snapshot of this process's frame traffic (bytes include prefixes)."""
    with _WIRE_LOCK:
        return dict(_WIRE)


def reset_wire_stats() -> None:
    with _WIRE_LOCK:
        for k in _WIRE:
            _WIRE[k] = 0


# --------------------------------------------------------------------------
# Payload codecs (the bodies of ``put`` messages)
# --------------------------------------------------------------------------

_EF_LOCK = threading.Lock()
#: per-global-name error feedback state. Encodes for one name serialize on
#: the entry's own lock, and a small digest-keyed replay cache of recent
#: (digest, blob) pairs is retained so a re-encode of a previously-encoded
#: digest (driver-store eviction, a need from a second worker, a racing
#: submit) returns byte-identical output instead of re-quantizing against
#: a moved residual — every worker decodes the same value for one digest,
#: and the residual advances exactly once per new content. Note the
#: residual is keyed by global *name*: two distinct same-named globals
#: alternating through the codec share one residual, which keeps each
#: decode within ~2 quantization steps rather than the single-step bound.
_EF: dict = {}

#: replay blobs kept per name
_EF_REPLAY_KEEP = 4

#: digests remembered per name after their replay blob ages out: a
#: re-encode of a *seen* digest quantizes without error feedback, so the
#: residual never advances twice for content that already shipped (and the
#: re-encode is deterministic). 16 B each; FIFO-trimmed.
_EF_SEEN_KEEP = 4096


class _EFEntry:
    __slots__ = ("lock", "ef", "blobs", "seen")

    def __init__(self):
        self.lock = threading.Lock()
        self.ef = None                       # ErrorFeedback, built lazily
        self.blobs: "OrderedDict[bytes, bytes]" = OrderedDict()
        self.seen: "OrderedDict[bytes, None]" = OrderedDict()


def reset_array_codec_state() -> None:
    """Drop accumulated error-feedback residuals (tests/benches)."""
    with _EF_LOCK:
        _EF.clear()


def _pack_meta(codec: int, meta: dict, body) -> bytes:
    mblob = pickle.dumps(meta, protocol=pickle.HIGHEST_PROTOCOL)
    return (bytes((codec,)) + struct.pack("!I", len(mblob)) + mblob
            + bytes(body))


def _unpack_meta(blob):
    view = memoryview(blob)
    (mlen,) = struct.unpack_from("!I", blob, 1)
    meta = pickle.loads(view[5:5 + mlen])
    return meta, view[5 + mlen:]


def _float_tensor(value, arr, kind: str):
    """The fp32 host tensor the int8 codec quantizes."""
    import torch
    if kind == "torch":
        return value.detach().cpu().float()
    return torch.from_numpy(arr).float()


def _quantize_blob(value, arr, kind: str, ef) -> bytes:
    import numpy as np
    x = _float_tensor(value, arr, kind)
    if ef is not None:
        (q, scale), _deq = ef.compress(x)
    else:
        from ...optim.compression import quantize_int8
        q, scale = quantize_int8(x)
    meta = dict(array_meta(value, arr, kind), scale=float(scale))
    return _pack_meta(P_INT8, meta, np.ascontiguousarray(q.numpy()))


def _encode_int8(value, arr, kind: str, name: "str | None",
                 digest: bytes) -> bytes:
    """int8+EF encoding of a float32/bf16 array via optim/compression."""
    if name is None:
        return _quantize_blob(value, arr, kind, None)
    from ...optim.compression import ErrorFeedback
    with _EF_LOCK:
        entry = _EF.get(name)
        if entry is None:
            entry = _EF[name] = _EFEntry()
    with entry.lock:                         # one encode per name at a time
        blob = entry.blobs.get(digest)
        if blob is not None:
            # previously-encoded content: byte-identical replay; the
            # residual does NOT advance for replayed content
            entry.blobs.move_to_end(digest)
            return blob
        if digest in entry.seen:
            # the replay blob aged out of every cache: re-encode WITHOUT
            # error feedback — deterministic, within the codec's one-step
            # accuracy contract, and the residual never advances twice
            # for already-shipped content
            blob = _quantize_blob(value, arr, kind, None)
        else:
            if entry.ef is None:
                entry.ef = ErrorFeedback()
            if entry.ef.residual is not None and \
                    tuple(entry.ef.residual.shape) != tuple(arr.shape):
                entry.ef.residual = None     # global re-bound to a new shape
            blob = _quantize_blob(value, arr, kind, entry.ef)
            entry.seen[digest] = None
            while len(entry.seen) > _EF_SEEN_KEEP:
                entry.seen.popitem(last=False)
        entry.blobs[digest] = blob
        while len(entry.blobs) > _EF_REPLAY_KEEP:
            entry.blobs.popitem(last=False)
        return blob


def _encode_rawarr(value, arr, kind: str) -> bytes:
    import numpy as np
    from .blobstore import raw_byte_view
    arr = np.ascontiguousarray(arr)
    return _pack_meta(P_RAWARR, array_meta(value, arr, kind),
                      raw_byte_view(arr))


def _np_dtype(name: str):
    import numpy as np
    return np.dtype(name)


def _tensor(body, meta: dict, dtype: "str | None" = None):
    """Rebuild a tensor from raw bytes: ``meta``'s dtype (or ``dtype``, the
    codec's own), shape and device type. A CUDA payload on a process with
    no CUDA device raises — it is never rebuilt on the CPU."""
    import torch
    device = meta.get("device", "cpu")
    if device == "cuda" and not torch.cuda.is_available():
        raise ChannelError(
            "a CUDA tensor payload reached a process with no CUDA device; "
            "it is not rebuilt on the CPU")
    tdtype = getattr(torch, dtype or meta["dtype"])
    if len(body) == 0:
        return torch.empty(meta["shape"], dtype=tdtype, device=device)
    if device == "cpu":
        # a private, writable buffer: the blob's bytes are immutable
        buf = body if isinstance(body, bytearray) else bytearray(body)
        flat = torch.frombuffer(buf, dtype=torch.uint8)
    else:
        with warnings.catch_warnings():      # read-only source, copied next
            warnings.simplefilter("ignore")
            flat = torch.frombuffer(body, dtype=torch.uint8).to(device)
    return flat.view(tdtype).reshape(meta["shape"])


def encode_payload(value: Any, *, name: "str | None" = None,
                   pickled: "bytes | None" = None,
                   int8: "bool | None" = None,
                   digest: "bytes | None" = None) -> bytes:
    """Encode one content-addressed payload. Arrays and tensors ship as raw
    bytes (lossless) — float32/bf16 ones go through the lossy int8+EF codec
    only when opted in — and everything else as its (given or computed)
    pickle.

    ``int8``/``digest`` let a :class:`~.blobstore.PayloadSource` pin the
    codec and digest it captured at future creation, so a
    :func:`set_array_codec` toggle before a lazy dispatch cannot encode a
    blob that disagrees with the digest it will be stored under; callers
    without that context inherit the current :data:`ARRAY_CODEC_INT8`."""
    from .blobstore import as_ndarray, content_digest
    arr, kind = as_ndarray(value)
    if arr is not None:
        use_int8 = ARRAY_CODEC_INT8 if int8 is None else int8
        dtype = array_meta(value, arr, kind)["dtype"]
        if use_int8 and dtype in ("float32", "bfloat16"):
            if digest is None:
                digest = content_digest(value)
            return _encode_int8(value, arr, kind, name, digest)
        return _encode_rawarr(value, arr, kind)
    if pickled is None:
        from ..globals_capture import dumps_robust
        pickled = dumps_robust(value)
    if len(pickled) >= COMPRESS_THRESHOLD:
        # compressible pickles are compressed here: the payload rides the
        # wire as it is
        packed = zlib.compress(pickled, COMPRESS_LEVEL)
        if len(packed) < len(pickled):
            return bytes((P_ZPICKLE,)) + packed
    return bytes((P_PICKLE,)) + pickled


def decode_payload(blob) -> "tuple[Any, bool]":
    """Decode a payload blob; returns ``(value, cacheable)``.

    ``cacheable`` marks values safe to share across tasks from the worker's
    decoded-object cache: numpy arrays (handed out **read-only** — a task
    that wants to scribble on a shipped global must copy it first), tensors
    (shared by contract, see ``blobstore.py``: a task clones before it
    writes) and bytes/str. Mutable pickles are decoded fresh per task.
    """
    import numpy as np
    view = memoryview(blob)
    codec = view[0]
    if codec == P_PICKLE:
        value = pickle.loads(view[1:])
        return value, isinstance(value, (bytes, str))
    if codec == P_ZPICKLE:
        value = pickle.loads(zlib.decompress(view[1:]))
        return value, isinstance(value, (bytes, str))
    if codec == P_INT8:
        meta, body = _unpack_meta(blob)
        if meta["kind"] == "torch" or meta["dtype"] == "bfloat16":
            import torch
            q = _tensor(body, meta, "int8")
            scale = torch.tensor(meta["scale"], dtype=torch.float32,
                                 device=q.device)
            return (q.float() * scale).to(getattr(torch, meta["dtype"])), \
                True
        q = np.frombuffer(body, np.int8).reshape(meta["shape"])
        x = q.astype(np.float32) * np.float32(meta["scale"])
        dtype = _np_dtype(meta["dtype"])
        if x.dtype != dtype:
            x = x.astype(dtype)
        x.flags.writeable = False
        return x, True
    if codec == P_RAWARR:
        meta, body = _unpack_meta(blob)
        if meta["kind"] == "torch" or meta["dtype"] == "bfloat16":
            return _tensor(body, meta), True
        arr = np.frombuffer(body, _np_dtype(meta["dtype"])) \
            .reshape(meta["shape"])
        return arr, True                     # frombuffer views are read-only
    raise ChannelError(f"unknown payload codec {codec}")
