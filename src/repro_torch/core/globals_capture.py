"""Automatic identification and snapshotting of globals (paper §Globals).

The R implementation walks the expression's AST (via ``globals`` /
``codetools``) to find free variables, records their *values at
future-creation time*, and ships them with the future. The defining
semantics (paper's example):

    x <- 1
    f <- future({ slow_fcn(x) })
    x <- 2
    value(f)        # uses x == 1

We reproduce this in Python by analysing the callable's code object:

* ``co_freevars``  -> closure cells (lexically captured variables);
* ``LOAD_GLOBAL``-referenced ``co_names`` -> the function's ``__globals__``;
* nested code objects (lambdas/comprehensions inside the body) are scanned
  recursively — the paper's "walking the AST in order".

Like the paper we use an *optimistic* strategy: names that resolve to
modules or builtins are recorded as *packages* (re-imported on the worker,
never serialized); unresolvable names are tolerated at creation (they may be
created at run time, e.g. ``get("k")``-style dynamic lookup) and produce the
ordinary NameError at evaluation — and, as in the paper, can be supplied
explicitly with ``globals={"k": 42}``.

Snapshot rules: immutable scalars/strings/tuples and torch/numpy arrays are
captured **by reference** (tensors are not copied: a future that needs a
frozen tensor clones it itself); mutable
containers (list/dict/set/bytearray) are **copied** at creation so later
mutation does not leak into the future, mirroring R's copy-on-assign.

On the in-process backends nothing is shipped: the snapshot is bound into
the rebuilt function by ``future.py``.

Shipping (the processes and cluster backends) is **content-addressed**: any snapshot
value whose payload reaches ``blobstore.PAYLOAD_REF_THRESHOLD`` (~16 KiB)
is split out of the task blob by :func:`extract_payload_refs` and replaced
with a :class:`~.backends.blobstore.PayloadRef` digest. The bytes travel in
a ``("put", digest, blob)`` message at most once per worker; repeated
futures over the same multi-MB tensor ship a few-hundred-byte task blob
that merely *references* it. Workers resolve refs from a bounded LRU
:class:`~.backends.blobstore.BlobStore` (with a ``("need", digest)``
backfill path for evictions and cold replacement workers) before the
function is rebuilt — see ``backends/worker.py`` for the protocol and
``backends/transport.py`` for the payload codecs.

A tensor is pickled by :class:`_ShippingPickler` as its raw bytes, its
dtype name, shape and device type (a CUDA tensor through a host copy) and
rebuilt by the worker on that device type — never through CUDA IPC or
shared-memory storage, and never on the CPU in place of a missing card.
The bytes are deterministic, so a container of tensors digested over its
pickle keeps its digest while its tensors keep their contents.
"""

from __future__ import annotations

import builtins
import copy
import dis
import pickle
import threading
import types
from typing import Any, Callable, Iterable

import torch

from .errors import GlobalsError, NonExportableObjectError

_GLOBAL_OPS = {"LOAD_GLOBAL", "LOAD_NAME", "STORE_GLOBAL", "DELETE_GLOBAL"}


def _code_global_names(code: types.CodeType) -> set[str]:
    """Names referenced via global scope in ``code`` and nested code objects."""
    names: set[str] = set()
    stack = [code]
    while stack:
        co = stack.pop()
        for instr in dis.get_instructions(co):
            if instr.opname in _GLOBAL_OPS and isinstance(instr.argval, str):
                names.add(instr.argval)
        for const in co.co_consts:
            if isinstance(const, types.CodeType):
                stack.append(const)
    return names


def _tensor_memo(value: Any) -> dict:
    """``copy.deepcopy`` memo mapping every tensor inside the containers of
    ``value`` to itself, so the copy keeps them by reference."""
    memo: dict = {}
    seen: set = set()                     # containers may hold themselves
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            memo[id(v)] = v
        elif isinstance(v, (dict, list, tuple, set, frozenset)) \
                and id(v) not in seen:
            seen.add(id(v))
            stack.extend(v.values() if isinstance(v, dict) else v)
    return memo


def _snapshot_value(value: Any) -> Any:
    """Creation-time snapshot. Mutable python containers are copied; arrays,
    scalars, functions and modules are captured by reference (immutables).
    Tensors stay references inside a copied container too: a dict of CUDA
    parameters is a new dict of the same tensors, not a clone on the card."""
    if isinstance(value, (list, dict, set, bytearray)):
        return copy.deepcopy(value, _tensor_memo(value))
    return value


def identify_globals(fn: Callable, *,
                     explicit: dict[str, Any] | None = None,
                     ) -> tuple[dict[str, Any], set[str]]:
    """Return ``(globals_snapshot, packages)`` for a callable.

    ``globals_snapshot`` maps name -> snapshotted value for every free
    variable the future body needs; ``packages`` is the set of module names
    recorded (to be re-imported on the worker rather than serialized —
    the paper's package-namespace recording).
    """
    if not callable(fn):
        raise GlobalsError(f"future body must be callable, got {type(fn)!r}")
    snapshot: dict[str, Any] = {}
    packages: set[str] = set()

    code = getattr(fn, "__code__", None)
    if code is None:                      # builtins / partials: nothing to scan
        if explicit:
            snapshot.update({k: _snapshot_value(v) for k, v in explicit.items()})
        return snapshot, packages

    # Closure cells (lexical captures).
    if code.co_freevars and fn.__closure__:
        for name, cell in zip(code.co_freevars, fn.__closure__):
            try:
                snapshot[name] = _snapshot_value(cell.cell_contents)
            except ValueError:            # empty cell (recursive def)
                pass

    # Module-level globals referenced by the body.
    fn_globals = getattr(fn, "__globals__", {})
    for name in sorted(_code_global_names(code)):
        if explicit and name in explicit:
            continue                      # explicit overrides win
        if name in fn_globals:
            val = fn_globals[name]
            if isinstance(val, types.ModuleType):
                packages.add((name, val.__name__))   # (alias, module)
            else:
                snapshot[name] = _snapshot_value(val)
        elif hasattr(builtins, name):
            continue                      # builtins need no shipping
        # else: optimistic — may be defined at run time (paper's get("k")).

    if explicit:
        for k, v in explicit.items():
            snapshot[k] = _snapshot_value(v)
    return snapshot, packages


def assert_exportable(snapshot: dict[str, Any], *, backend: str) -> None:
    """For external-process backends, verify the snapshot can be serialized —
    the analogue of the paper's non-exportable-object scan (connections,
    external pointers)."""
    for name, val in snapshot.items():
        if isinstance(val, types.ModuleType):
            continue
        try:
            dumps_robust(val)
        except Exception as exc:          # noqa: BLE001
            raise NonExportableObjectError(
                f"global {name!r} ({type(val).__name__}) cannot be exported "
                f"to backend {backend!r}: {exc}") from exc


# --------------------------------------------------------------------------
# Content-addressed payload refs (large globals ship at most once per worker)
# --------------------------------------------------------------------------

def extract_payload_refs(snapshot: dict[str, Any], *, backend: str,
                         threshold: "int | None" = None,
                         ) -> "tuple[dict[str, Any], dict]":
    """Split ``snapshot`` into ``(refd_snapshot, sources)``.

    Values whose payload reaches ``threshold`` (default
    ``blobstore.PAYLOAD_REF_THRESHOLD``) are replaced by
    :class:`~.backends.blobstore.PayloadRef` markers; ``sources`` maps each
    digest to the :class:`~.backends.blobstore.PayloadSource` that can
    encode it for any worker that does not hold it yet. Arrays and tensors
    are digested over their raw bytes (memoized by object identity and a
    tensor's version — repeated dispatch of the same tensor never re-hashes
    it); other values are digested over their robust pickle, which doubles
    as the exportability check: an unpicklable global raises
    :class:`NonExportableObjectError` *at creation*.
    """
    from .backends import blobstore
    if threshold is None:
        threshold = blobstore.PAYLOAD_REF_THRESHOLD
    out: dict[str, Any] = {}
    sources: dict[bytes, Any] = {}
    for name, val in snapshot.items():
        if isinstance(val, types.ModuleType):
            out[name] = val
            continue
        if getattr(val, "is_remote_value", False):
            # a worker-resident result captured as a global: ship the ref,
            # let the holder (or a peer / the driver fallback) move the bytes
            sources[val.digest] = val.source()
            out[name] = blobstore.PayloadRef(val.digest)
            continue
        nbytes = blobstore.array_nbytes(val)
        if nbytes is not None:
            if nbytes >= threshold:
                digest = blobstore.content_digest(val)
                sources[digest] = blobstore.PayloadSource(name, digest, val)
                out[name] = blobstore.PayloadRef(digest)
            else:
                out[name] = val
            continue
        try:
            blob = dumps_robust(val)
        except Exception as exc:          # noqa: BLE001
            raise NonExportableObjectError(
                f"global {name!r} ({type(val).__name__}) cannot be exported "
                f"to backend {backend!r}: {exc}") from exc
        if len(blob) >= threshold:
            digest = blobstore.blob_digest(blob)
            sources[digest] = blobstore.PayloadSource(name, digest, val,
                                                      pickled=blob)
            out[name] = blobstore.PayloadRef(digest)
        else:
            out[name] = val
    return out, sources


def extract_call_refs(args: tuple, kwargs: dict, *, backend: str,
                      threshold: "int | None" = None,
                      ) -> "tuple[tuple, dict, dict]":
    """Content-address large *call arguments* the same way globals are:
    returns ``(args, kwargs, sources)`` with big top-level values replaced
    by :class:`~.backends.blobstore.PayloadRef` markers (resolved worker-
    side through the ambient payload resolver at task decode).

    Covered: arrays and tensors (``content_digest`` over raw bytes,
    memoized), ``bytes``/``str`` at or over ``threshold`` (cheap ``len``
    probe), and worker-resident :class:`~.backends.blobstore.RemoteValue`
    results — the fuel of continuation chains, which ship as a ~500 B ref
    plus peer-fetch hints instead of the multi-MB value. The items of a
    top-level list or tuple are addressed one by one the same way (a flat
    parameter list ships each large leaf once per worker, raw, and never
    inside the task blob). Other values travel inline (no speculative
    pickling on the small-arg fast path); a ``RemoteValue`` *nested*
    deeper is converted during the shipping pickle by
    ``_ShippingPickler.reducer_override``.
    """
    from .backends import blobstore
    if threshold is None:
        threshold = blobstore.PAYLOAD_REF_THRESHOLD
    sources: dict[bytes, Any] = {}

    def convert(val, name):
        if getattr(val, "is_remote_value", False):
            sources[val.digest] = val.source()
            return blobstore.PayloadRef(val.digest)
        nbytes = blobstore.array_nbytes(val)
        if nbytes is not None and nbytes >= threshold:
            digest = blobstore.content_digest(val)
            sources[digest] = blobstore.PayloadSource(name, digest, val)
            return blobstore.PayloadRef(digest)
        if isinstance(val, (bytes, str)) and len(val) >= threshold:
            blob = dumps_robust(val)
            digest = blobstore.blob_digest(blob)
            sources[digest] = blobstore.PayloadSource(name, digest, val,
                                                      pickled=blob)
            return blobstore.PayloadRef(digest)
        return val

    def convert_top(val, name):
        if type(val) in (list, tuple):
            items = [convert(v, f"{name}[{i}]") for i, v in enumerate(val)]
            if any(a is not b for a, b in zip(items, val)):
                return type(val)(items)
            return val
        return convert(val, name)

    args = tuple(convert_top(v, f"<arg{i}>") for i, v in enumerate(args))
    kwargs = {k: convert_top(v, f"<kwarg:{k}>") for k, v in kwargs.items()}
    return args, kwargs, sources


# --------------------------------------------------------------------------
# Function shipping without cloudpickle
# --------------------------------------------------------------------------

class _ResolverState(threading.local):
    def __init__(self):
        self.fn: Callable | None = None


_RESOLVER = _ResolverState()


class payload_resolver:
    """Install the worker's PayloadRef resolver for the duration of a task
    unpickle/unship: nested shipped functions (rebuilt *during* the outer
    ``pickle.loads``) pick it up ambiently."""

    def __init__(self, resolve: Callable):
        self.resolve = resolve

    def __enter__(self):
        self._prev = _RESOLVER.fn
        _RESOLVER.fn = self.resolve
        return self

    def __exit__(self, *exc):
        _RESOLVER.fn = self._prev
        return False


def _fn_importable(fn: types.FunctionType) -> bool:
    """Can this function be pickled by reference (module.qualname lookup)?"""
    if fn.__name__ == "<lambda>" or "<locals>" in fn.__qualname__:
        return False
    import sys
    mod = sys.modules.get(fn.__module__)
    if mod is None:
        return False
    obj = mod
    for part in fn.__qualname__.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return False
    return obj is fn


def _rebuild_shipped(blob: bytes) -> Callable:
    return unship_function(blob)


def _reduce_tensor(t: torch.Tensor) -> tuple:
    """A tensor as ``(raw bytes, dtype name, shape, device type,
    requires_grad)``: deterministic bytes, no CUDA IPC, no shared
    storage."""
    from .backends.blobstore import _tensor_words, raw_byte_view
    words = raw_byte_view(_tensor_words(t))
    return (_rebuild_tensor,
            (pickle.PickleBuffer(words), str(t.dtype).removeprefix("torch."),
             tuple(t.shape), t.device.type, bool(t.requires_grad)))


def _rebuild_tensor(data, dtype: str, shape: tuple, device: str,
                    requires_grad: bool) -> torch.Tensor:
    """The tensor :func:`_reduce_tensor` took apart, on ``device``'s type;
    raises on a process without that device (no CPU fallback)."""
    from .backends.transport import _tensor
    t = _tensor(data, {"dtype": dtype, "shape": shape, "device": device})
    return t.requires_grad_() if requires_grad else t


class _ShippingPickler(pickle.Pickler):
    """Pickler that ships lambdas / local functions by marshalled code +
    their own recursively-identified globals (no cloudpickle dependency),
    and tensors as their raw bytes (:func:`_reduce_tensor`).

    With a ``ref_sink`` dict, large values in nested function snapshots are
    content-addressed exactly like top-level globals: the snapshot keeps a
    :class:`PayloadRef` and the sink collects ``digest -> PayloadSource``
    for the transport layer. This matters for wrappers like ``future_map``'s
    chunk runner, where the user's function (closing over the big tensors)
    rides along as a default argument rather than a top-level global.
    """

    def __init__(self, *args, ref_sink: "dict | None" = None, **kwargs):
        super().__init__(*args, **kwargs)
        self._ref_sink = ref_sink

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _reduce_tensor(obj)
        if isinstance(obj, types.FunctionType) and not _fn_importable(obj):
            snapshot, packages = identify_globals(obj)
            if self._ref_sink is not None:
                snapshot, nested = extract_payload_refs(
                    snapshot, backend="shipped")
                self._ref_sink.update(nested)
            return (_rebuild_shipped,
                    (ship_function(obj, snapshot, packages,
                                   ref_sink=self._ref_sink),))
        if isinstance(obj, types.ModuleType):
            import importlib
            return (importlib.import_module, (obj.__name__,))
        if getattr(obj, "is_remote_value", False) \
                and self._ref_sink is not None:
            # a worker-resident result nested anywhere in the shipped
            # structure: pickle the digest marker (resolved worker-side by
            # the ambient resolver) and sink a RemoteSource so the dispatch
            # layer can move (or hint at) the bytes
            from .backends.blobstore import _resolve_or_ref
            self._ref_sink[obj.digest] = obj.source()
            return (_resolve_or_ref, (obj.digest,))
        return NotImplemented


def dumps_robust(obj: Any, *, ref_sink: "dict | None" = None) -> bytes:
    import io
    buf = io.BytesIO()
    _ShippingPickler(buf, protocol=pickle.HIGHEST_PROTOCOL,
                     ref_sink=ref_sink).dump(obj)
    return buf.getvalue()


def ship_function(fn: Callable, snapshot: dict[str, Any],
                  packages: Iterable[str],
                  ref_sink: "dict | None" = None) -> bytes:
    """Serialize a callable (including lambdas/closures) for a worker process.

    Plain ``pickle`` cannot serialize lambdas; we marshal the code object and
    rebuild the function on the worker with its snapshot as globals — the
    moral equivalent of the paper shipping the expression + its globals.
    Function-valued globals/defaults are shipped recursively (their large
    snapshot values content-addressed into ``ref_sink`` when given).
    """
    import marshal
    code = fn.__code__
    payload = {
        "code": marshal.dumps(code),
        "name": fn.__name__,
        "defaults": fn.__defaults__,
        "kwdefaults": fn.__kwdefaults__,
        "closure_names": code.co_freevars,
        "snapshot": snapshot,
        "packages": sorted(set(packages)),
        "doc": fn.__doc__,
    }
    return dumps_robust(payload, ref_sink=ref_sink)


def unship_function(blob: bytes, resolve_ref: "Callable | None" = None
                    ) -> Callable:
    """Rebuild a shipped function inside a worker process.

    ``resolve_ref(PayloadRef) -> value`` swaps content-addressed payload
    markers in the snapshot for their decoded values (from the worker's
    blob store) before the function's globals/closure are assembled.
    """
    import importlib
    import marshal
    payload = pickle.loads(blob)
    code = marshal.loads(payload["code"])
    g: dict[str, Any] = {"__builtins__": builtins}
    for entry in payload["packages"]:
        alias, mod = entry if isinstance(entry, tuple) else (
            entry.split(".")[0], entry)
        try:
            g[alias] = importlib.import_module(mod)
        except ImportError:
            pass
    closure_names = payload["closure_names"]
    snapshot = dict(payload["snapshot"])
    if resolve_ref is None:
        resolve_ref = _RESOLVER.fn           # ambient (nested unship)
    if resolve_ref is not None:
        from .backends.blobstore import PayloadRef
        for k, v in snapshot.items():
            if isinstance(v, PayloadRef):
                snapshot[k] = resolve_ref(v)
    cells = tuple(types.CellType(snapshot.pop(n, None)) for n in closure_names)
    g.update(snapshot)
    fn = types.FunctionType(code, g, payload["name"],
                            payload["defaults"], cells or None)
    if payload["kwdefaults"]:
        fn.__kwdefaults__ = payload["kwdefaults"]
    return fn
