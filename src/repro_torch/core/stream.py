"""Lazy streaming pipelines over the Future API (the frontend redesign).

The paper argues the three Future constructs are sufficient to build every
higher-level map-reduce frontend; the follow-up frontend work (arXiv
2601.17578) argues the frontend itself should be one composable layer, and
the optimised-flow work (arXiv 2107.07298) shows that *when work is
admitted* dominates throughput. This module is that layer::

    from repro_torch.core import stream

    total = (stream(samples())                 # any iterable — never
             .filter(lambda s: s.ok)           # materialized, unbounded
             .batch(32)                        # generators welcome
             .map(score, seed=True, chunk=4)   # futures on the active plan
             .reduce(operator.add))            # folds as results complete

Contrast with the eager ``future_map``: ``stream()`` never calls
``list(xs)``, never blocks inside ``Backend.submit``, and holds at most
``max_in_flight`` futures outstanding (default ``2 * backend.workers``) —
so memory is O(in-flight), not O(len(xs)), and dispatch happens *exactly
when capacity exists* via the backend admission protocol
(``Backend.free_slots`` / ``Backend.try_submit``).

Mechanics of the pump (one per ``.map`` stage):

* elements are pulled from upstream lazily, grouped into chunks
  (``chunk=`` elements per future; ``future_map`` passes its exact
  chunk-size plan through), and each chunk becomes one lazy future;
* a chunk is dispatched through ``try_submit`` the moment the backend
  reports a free slot; when nothing is in flight the pump falls back to
  one blocking ``submit`` (progress guarantee — the paper's "future()
  blocks until a worker is available" semantics, but only at the edge);
* completions are push-delivered through one :class:`~.future.Waiter`;
  the pump harvests, re-dispatches ``retries=`` failed chunks
  (``FutureError`` only — evaluation errors propagate, like
  ``future_map``), and refills from upstream;
* ``seed=`` gives every *element* ``rng.stream_key(base + i)`` with
  ``i`` the element's position in the stage's input stream — invariant to
  chunking, backend, worker count *and* ``max_in_flight`` (the same CMRG
  guarantee ``future_map`` makes);
* intermediate ``.map`` stages always emit in input order (determinism
  for downstream ``filter``/RNG); only the final stage emits in
  completion order, and only for ``.as_completed()`` / ``.reduce()`` /
  ``.collect(ordered=False)``.

``Stream`` objects are immutable — each combinator returns a new stream
sharing the source. A stream over a one-shot iterator is single-use.
After a terminal runs, ``.stats`` on the terminal stream records
``dispatched`` / ``retried`` chunk counts and ``peak_in_flight`` (always
``<= max_in_flight`` — asserted by the conformance suite).
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import itertools
from typing import Any, AsyncIterator, Callable, Iterable, Iterator

from . import planning as plan_mod
from . import rng as rng_mod
from .errors import FutureError
from .future import AsyncWaiter, Future, Waiter, _accepts_kwarg, future

_MISSING = object()

#: waiter timeout used only while admission is refused with work queued:
#: our own completions push-wake the waiter, but capacity can also free
#: through *foreign* futures completing, which nothing pushes to us.
_CONTENTION_WAIT_S = 0.05


@dataclasses.dataclass(frozen=True)
class _MapOp:
    fn: Callable
    seed: "bool | int | None"
    seed_declared: bool
    base_index: int
    pass_key: bool
    retries: int
    chunk: int
    chunk_sizes: "tuple | None"        # exact plan (future_map sugar)
    label: str
    #: fused downstream stages: (fn, pass_key, base_index) per stage.
    #: Adjacent ``.map``s collapse into one pump at terminal time (see
    #: Stream._run) — the intermediate value never leaves the worker, the
    #: dataflow analogue of locality-scheduled ``then`` chains. Per-element
    #: stream keys stay per *stage* (stream_key(base_s + i)), so
    #: fused and unfused pipelines draw identical randomness.
    extra: tuple = ()


def _filtered(it: Iterator, pred: Callable) -> Iterator:
    for x in it:
        if pred(x):
            yield x


def _batched(it: Iterator, n: int) -> Iterator:
    while True:
        group = list(itertools.islice(it, n))
        if not group:
            return
        yield group


def _chunked(it: Iterator, op: _MapOp) -> Iterator:
    """Group upstream elements into ``(index_list, items)`` chunks, pulled
    lazily. Indices number the stage's input stream consecutively — the
    per-element RNG coordinate."""
    if op.chunk_sizes:
        sizes: Iterator[int] = itertools.chain(
            op.chunk_sizes, itertools.repeat(op.chunk_sizes[-1]))
    else:
        sizes = itertools.repeat(op.chunk)
    idx = 0
    for size in sizes:
        items = list(itertools.islice(it, max(int(size), 1)))
        if not items:
            return
        yield (list(range(idx, idx + len(items))), items)
        idx += len(items)


def _chunk_runner(op: _MapOp) -> Callable:
    """The shipped chunk body — identical to ``future_map``'s: applies
    each (possibly fused) stage's ``fn`` per element, passing the
    element's per-stage stream key when that stage declared one.

    ``async def`` map fns are supported on backends that drive awaitable
    bodies (``plan("asyncio")``): when any element produced an awaitable,
    the chunk returns one coroutine resolving them all. Elements are
    awaited by *delegation* (no task spawn), so the backend's segmented
    capture covers the user coroutine's prints/conditions; chunks run
    concurrently, elements within a chunk sequentially — keep ``chunk=1``
    (the default) for I/O-bound async maps."""
    specs = ((op.fn, op.pass_key, op.base_index),) + op.extra

    def run_chunk(idx: "list[int]", items: "list", _specs=specs):
        import inspect as _inspect
        out = []
        for i, x in zip(idx, items):
            for _fn, _pass_key, _base in _specs:
                if _pass_key:
                    x = _fn(x, key=rng_mod.stream_key(_base + i))
                else:
                    x = _fn(x)
            out.append(x)
        if any(_inspect.isawaitable(v) for v in out):
            async def _resolve(_out=out):
                return [await v if _inspect.isawaitable(v) else v
                        for v in _out]
            return _resolve()
        return out
    return run_chunk


def _est_nbytes(x) -> int:
    """Cheap payload-size estimate for one stream element: array
    ``.nbytes`` (numpy arrays and torch tensors alike — a CUDA tensor
    counts its device bytes), buffer/str lengths, recursive container
    sums, else the interpreter's shallow ``getsizeof``. An *admission*
    heuristic — it bounds memory for the size-skewed workloads that
    matter (arrays, blobs), not a serializer-exact accounting."""
    import sys
    n = getattr(x, "nbytes", None)
    if isinstance(n, int):
        return n
    if isinstance(x, (bytes, bytearray, memoryview, str)):
        return len(x)
    if isinstance(x, (list, tuple, set, frozenset)):
        return sum(_est_nbytes(v) for v in x) + sys.getsizeof(x)
    if isinstance(x, dict):
        return sum(_est_nbytes(k) + _est_nbytes(v)
                   for k, v in x.items()) + sys.getsizeof(x)
    return sys.getsizeof(x)


def _pump(op: _MapOp, upstream: Iterator, *, max_in_flight: "int | None",
          max_in_flight_bytes: "int | None" = None,
          ordered: bool, stats: dict) -> Iterator:
    """The streaming dispatch loop for one ``.map`` stage."""
    backend = plan_mod.active_backend()
    mif = max_in_flight if max_in_flight is not None \
        else 2 * max(backend.workers, 1)
    mif = max(int(mif), 1)
    mbytes = int(max_in_flight_bytes) if max_in_flight_bytes else None
    stats["max_in_flight"] = mif
    stats["max_in_flight_bytes"] = mbytes
    run_chunk = _chunk_runner(op)

    def make(cid: int, idx: list, items: list, tries: int) -> Future:
        return future(run_chunk, idx, items,
                      seed=op.seed if op.seed_declared else None,
                      lazy=True,
                      label=f"{op.label}[{cid}]" if tries == 0
                      else f"{op.label}-retry")

    chunk_iter = _chunked(upstream, op)
    # rec = (f, cid, idx, items, tries, nbytes)
    queue: "collections.deque" = collections.deque()
    pending: "dict[Future, tuple]" = {}
    in_bytes = 0                       # admitted-but-unharvested estimate
    done_buf: "dict[int, list]" = {}   # cid -> values (ordered mode)
    emit: "collections.deque" = collections.deque()   # values (unordered)
    waiter = Waiter()
    src_done = False
    cid_seq = 0
    emit_id = 0
    try:
        while True:
            # 1. emit everything ready
            if ordered:
                while emit_id in done_buf:
                    for v in done_buf.pop(emit_id):
                        yield v
                    emit_id += 1
            else:
                while emit:
                    yield emit.popleft()
            # 2. refill from upstream — queued + in-flight + buffered
            #    results together never exceed mif, so memory stays
            #    O(in-flight) no matter how long the source is. With
            #    max_in_flight_bytes set, the *byte estimate* of admitted
            #    chunks bounds refill too (size-skewed streams: one wave
            #    of 100 MiB elements must not occupy mif slots of them) —
            #    but at least one chunk is always admitted, so a single
            #    over-budget element still makes progress.
            while (not src_done
                   and len(queue) + len(pending) + len(done_buf) < mif
                   and (mbytes is None or in_bytes <= 0
                        or in_bytes < mbytes)):
                batch = next(chunk_iter, None)
                if batch is None:
                    src_done = True
                    break
                idx, items = batch
                nbytes = sum(_est_nbytes(x) for x in items) \
                    if mbytes is not None else 0
                in_bytes += nbytes
                queue.append((make(cid_seq, idx, items, 0),
                              cid_seq, idx, items, 0, nbytes))
                cid_seq += 1
            # 3. admission-controlled dispatch: exactly when capacity
            #    exists; one blocking submit only when nothing is in
            #    flight (progress guarantee — nothing else would wake us)
            contended = False
            while queue:
                rec = queue[0]
                if pending:
                    if not rec[0]._submit_nowait():
                        contended = True
                        break
                else:
                    rec[0]._submit()
                queue.popleft()
                pending[rec[0]] = rec
                waiter.add(rec[0])
                stats["dispatched"] = stats.get("dispatched", 0) + 1
                stats["peak_in_flight"] = max(
                    stats.get("peak_in_flight", 0), len(pending))
                stats["peak_in_flight_bytes"] = max(
                    stats.get("peak_in_flight_bytes", 0), in_bytes)
            if not pending:
                if src_done and not queue and not done_buf and not emit:
                    return
                continue
            # 4. sleep until a completion pushes (briefly, when foreign
            #    futures hold the slots we were refused)
            got = waiter.wait(_CONTENTION_WAIT_S
                              if contended and queue else None)
            # 5. harvest in completion order (relays stdout/conditions,
            #    like future_map); FutureError -> bounded re-dispatch
            for f in got:
                _, cid, idx, items, tries, nbytes = pending.pop(f)
                try:
                    vals = f.value()
                except FutureError:
                    if tries >= op.retries:
                        raise
                    # a retried chunk stays admitted: its bytes are still
                    # resident until it finally harvests
                    queue.appendleft((make(cid, idx, items, tries + 1),
                                      cid, idx, items, tries + 1, nbytes))
                    stats["retried"] = stats.get("retried", 0) + 1
                    continue
                in_bytes -= nbytes
                if ordered:
                    done_buf[cid] = vals
                else:
                    emit.extend(vals)
    finally:
        # consumer abandoned the stream mid-flight (GeneratorExit from
        # breaking out of as_completed()), or a chunk failure is
        # propagating out of the harvest: don't leave up to mif-1 chunks
        # occupying backend workers. Best-effort — a no-op on normal
        # completion (pending and queue are empty by then).
        for rec in itertools.chain(pending.values(), queue):
            try:
                rec[0].cancel()
            except Exception:                        # noqa: BLE001
                pass


# --------------------------------------------------------------------------
# The cooperative (asyncio) terminal: the same pipeline, driven from inside
# a running event loop. Mirrors the sync stages one-for-one; the pump waits
# on an AsyncWaiter and sleeps cooperatively where the sync pump would park
# the thread, so `async for v in s.as_completed_async()` never blocks the
# loop while futures are in flight.
# --------------------------------------------------------------------------

async def _to_async(source) -> AsyncIterator:
    """Adapt any (a)iterable into an async iterator (sync sources are
    pulled inline, like the sync pipeline pulls them)."""
    if hasattr(source, "__aiter__"):
        async for x in source:
            yield x
    else:
        for x in source:
            yield x


async def _afiltered(ait: AsyncIterator, pred: Callable) -> AsyncIterator:
    async for x in ait:
        if pred(x):
            yield x


async def _abatched(ait: AsyncIterator, n: int) -> AsyncIterator:
    group: list = []
    async for x in ait:
        group.append(x)
        if len(group) >= n:
            yield group
            group = []
    if group:
        yield group


async def _achunked(ait: AsyncIterator, op: _MapOp) -> AsyncIterator:
    """Async mirror of :func:`_chunked`: same chunk plan, same consecutive
    element indices (the per-element RNG coordinate)."""
    if op.chunk_sizes:
        sizes: Iterator[int] = itertools.chain(
            op.chunk_sizes, itertools.repeat(op.chunk_sizes[-1]))
    else:
        sizes = itertools.repeat(op.chunk)
    idx = 0
    items: list = []
    size = max(int(next(sizes)), 1)
    async for x in ait:
        items.append(x)
        if len(items) >= size:
            yield (list(range(idx, idx + len(items))), items)
            idx += len(items)
            items = []
            size = max(int(next(sizes)), 1)
    if items:
        yield (list(range(idx, idx + len(items))), items)


async def _pump_async(op: _MapOp, upstream: AsyncIterator, *,
                      max_in_flight: "int | None",
                      max_in_flight_bytes: "int | None" = None,
                      ordered: bool, stats: dict) -> AsyncIterator:
    """The streaming dispatch loop for one ``.map`` stage, loop-native:
    identical admission/harvest/retry/cancellation structure to
    :func:`_pump`, with the thread-blocking points made cooperative
    (AsyncWaiter instead of Waiter; a cooperative re-offer loop instead of
    the one blocking ``submit``)."""
    backend = plan_mod.active_backend()
    mif = max_in_flight if max_in_flight is not None \
        else 2 * max(backend.workers, 1)
    mif = max(int(mif), 1)
    mbytes = int(max_in_flight_bytes) if max_in_flight_bytes else None
    stats["max_in_flight"] = mif
    stats["max_in_flight_bytes"] = mbytes
    run_chunk = _chunk_runner(op)

    def make(cid: int, idx: list, items: list, tries: int) -> Future:
        return future(run_chunk, idx, items,
                      seed=op.seed if op.seed_declared else None,
                      lazy=True,
                      label=f"{op.label}[{cid}]" if tries == 0
                      else f"{op.label}-retry")

    chunk_ait = _achunked(upstream, op)
    queue: "collections.deque" = collections.deque()
    pending: "dict[Future, tuple]" = {}
    in_bytes = 0
    done_buf: "dict[int, list]" = {}
    emit: "collections.deque" = collections.deque()
    waiter = AsyncWaiter()
    src_done = False
    cid_seq = 0
    emit_id = 0
    try:
        while True:
            # 1. emit everything ready
            if ordered:
                while emit_id in done_buf:
                    for v in done_buf.pop(emit_id):
                        yield v
                    emit_id += 1
            else:
                while emit:
                    yield emit.popleft()
            # 2. refill from upstream (same O(in-flight) bound as _pump)
            while (not src_done
                   and len(queue) + len(pending) + len(done_buf) < mif
                   and (mbytes is None or in_bytes <= 0
                        or in_bytes < mbytes)):
                try:
                    batch = await chunk_ait.__anext__()
                except StopAsyncIteration:
                    src_done = True
                    break
                idx, items = batch
                nbytes = sum(_est_nbytes(x) for x in items) \
                    if mbytes is not None else 0
                in_bytes += nbytes
                queue.append((make(cid_seq, idx, items, 0),
                              cid_seq, idx, items, 0, nbytes))
                cid_seq += 1
            # 3. admission-controlled dispatch; the progress-guarantee
            #    submit (nothing in flight) becomes a cooperative
            #    re-offer loop — never park the event loop in submit()
            contended = False
            while queue:
                rec = queue[0]
                if pending:
                    if not rec[0]._submit_nowait():
                        contended = True
                        break
                else:
                    while not rec[0]._submit_nowait():
                        await asyncio.sleep(_CONTENTION_WAIT_S)
                queue.popleft()
                pending[rec[0]] = rec
                waiter.add(rec[0])
                stats["dispatched"] = stats.get("dispatched", 0) + 1
                stats["peak_in_flight"] = max(
                    stats.get("peak_in_flight", 0), len(pending))
                stats["peak_in_flight_bytes"] = max(
                    stats.get("peak_in_flight_bytes", 0), in_bytes)
            if not pending:
                if src_done and not queue and not done_buf and not emit:
                    return
                continue
            # 4. suspend until a completion is marshalled into this loop
            got = await waiter.wait(_CONTENTION_WAIT_S
                                    if contended and queue else None)
            # 5. harvest in completion order; FutureError -> re-dispatch
            for f in got:
                _, cid, idx, items, tries, nbytes = pending.pop(f)
                try:
                    vals = f.value()
                except FutureError:
                    if tries >= op.retries:
                        raise
                    queue.appendleft((make(cid, idx, items, tries + 1),
                                      cid, idx, items, tries + 1, nbytes))
                    stats["retried"] = stats.get("retried", 0) + 1
                    continue
                in_bytes -= nbytes
                if ordered:
                    done_buf[cid] = vals
                else:
                    emit.extend(vals)
    finally:
        # consumer abandoned the stream (aclose()/GeneratorExit from
        # breaking out of `async for`) or a chunk failure is propagating:
        # cancel the in-flight tail, exactly like the sync pump
        for rec in itertools.chain(pending.values(), queue):
            try:
                rec[0].cancel()
            except Exception:                            # noqa: BLE001
                pass


class Stream:
    """A lazy, chainable pipeline. Build with :func:`stream`; add stages
    with :meth:`map` / :meth:`filter` / :meth:`batch`; run with a terminal
    (:meth:`collect`, :meth:`reduce`, :meth:`as_completed` — or, inside a
    running event loop, :meth:`as_completed_async` / :meth:`collect_async`)."""

    def __init__(self, source: Iterable, *,
                 max_in_flight: "int | None" = None,
                 max_in_flight_bytes: "int | None" = None,
                 label: "str | None" = None):
        self._source = source
        self._ops: tuple = ()
        self._max_in_flight = max_in_flight
        self._max_in_flight_bytes = max_in_flight_bytes
        self._label = label or "stream"
        self._map_count = 0
        #: populated by the last terminal run on *this* object
        self.stats: dict = {}

    def _with(self, op, is_map: bool = False) -> "Stream":
        s = Stream.__new__(Stream)
        s._source = self._source
        s._ops = self._ops + (op,)
        s._max_in_flight = self._max_in_flight
        s._max_in_flight_bytes = self._max_in_flight_bytes
        s._label = self._label
        s._map_count = self._map_count + (1 if is_map else 0)
        s.stats = self.stats             # shared along the chain: the stats
        return s                         # of the last terminal run anywhere

    # -- stages --------------------------------------------------------------

    def map(self, fn: Callable, *, seed: "bool | int | None" = None,
            retries: int = 0, chunk: int = 1,
            label: "str | None" = None,
            _chunk_sizes: "Iterable[int] | None" = None) -> "Stream":
        """Parallel transform: every element becomes ``fn(x)`` resolved via
        futures on the active plan, ``chunk`` elements per future.

        ``seed=`` gives each element its backend/chunking-invariant stream
        key (passed as ``key=`` when ``fn`` accepts it; an int seed offsets
        the element index like ``future_map``). ``retries=`` re-dispatches
        a chunk whose future failed with an *infrastructure*
        :class:`FutureError` (infrastructure); evaluation errors propagate
        immediately.
        """
        seed_declared = seed is not None and seed is not False
        base = int(seed) if isinstance(seed, int) \
            and not isinstance(seed, bool) else 0
        op = _MapOp(
            fn=fn, seed=seed, seed_declared=seed_declared, base_index=base,
            pass_key=seed_declared and _accepts_kwarg(fn, "key"),
            retries=int(retries), chunk=max(int(chunk), 1),
            chunk_sizes=tuple(_chunk_sizes) if _chunk_sizes else None,
            label=label or f"{self._label}.map{self._map_count}")
        return self._with(op, is_map=True)

    def filter(self, pred: Callable) -> "Stream":
        """Keep elements where ``pred(x)`` is truthy (runs driver-side,
        lazily — element indices downstream number the *kept* stream)."""
        return self._with(("filter", pred))

    def batch(self, n: int) -> "Stream":
        """Group consecutive elements into lists of ``n`` (last one may be
        short). Before a ``.map``, each batch is one element of the map's
        input; after one, it groups results."""
        if int(n) < 1:
            raise ValueError("batch size must be >= 1")
        return self._with(("batch", int(n)))

    # -- terminals -----------------------------------------------------------

    @staticmethod
    def _fuse(ops: tuple) -> tuple:
        """Collapse *adjacent* ``.map`` stages into single pumps: the
        intermediate values never come back to the driver (one future runs
        the whole fn chain per element — worker-resident dataflow). Never
        fuses across ``filter``/``batch`` (they run driver-side and
        renumber the element stream). Chunking follows the first stage;
        ``retries`` is the chain's max; per-element RNG keys stay
        per-stage, so results are bit-identical to the unfused pipeline."""
        fused: list = []
        for op in ops:
            if (isinstance(op, _MapOp) and fused
                    and isinstance(fused[-1], _MapOp)):
                head = fused[-1]
                fused[-1] = dataclasses.replace(
                    head,
                    seed=head.seed if head.seed_declared else op.seed,
                    seed_declared=head.seed_declared or op.seed_declared,
                    retries=max(head.retries, op.retries),
                    label=f"{head.label}+{op.label.rsplit('.', 1)[-1]}",
                    extra=head.extra
                    + ((op.fn, op.pass_key, op.base_index),))
            else:
                fused.append(op)
        return tuple(fused)

    def _run(self, ordered: bool) -> Iterator:
        self.stats.clear()
        self.stats.update({"dispatched": 0, "retried": 0,
                           "peak_in_flight": 0, "max_in_flight": None,
                           "peak_in_flight_bytes": 0,
                           "max_in_flight_bytes": None})
        it: Iterator = iter(self._source)
        ops = self._fuse(self._ops)
        maps = [i for i, o in enumerate(ops) if isinstance(o, _MapOp)]
        last_map = maps[-1] if maps else None
        for i, op in enumerate(ops):
            if isinstance(op, _MapOp):
                # intermediate stages stay ordered so downstream element
                # numbering (RNG) and filters are deterministic
                it = _pump(op, it, max_in_flight=self._max_in_flight,
                           max_in_flight_bytes=self._max_in_flight_bytes,
                           ordered=ordered or i != last_map,
                           stats=self.stats)
            elif op[0] == "filter":
                it = _filtered(it, op[1])
            elif op[0] == "batch":
                it = _batched(it, op[1])
        return it

    def _run_async(self, ordered: bool) -> AsyncIterator:
        """Async mirror of :meth:`_run`: the same fused op chain compiled
        onto the cooperative stages — run it from inside an event loop."""
        self.stats.clear()
        self.stats.update({"dispatched": 0, "retried": 0,
                           "peak_in_flight": 0, "max_in_flight": None,
                           "peak_in_flight_bytes": 0,
                           "max_in_flight_bytes": None})
        ait: AsyncIterator = _to_async(self._source)
        ops = self._fuse(self._ops)
        maps = [i for i, o in enumerate(ops) if isinstance(o, _MapOp)]
        last_map = maps[-1] if maps else None
        for i, op in enumerate(ops):
            if isinstance(op, _MapOp):
                ait = _pump_async(op, ait, max_in_flight=self._max_in_flight,
                                  max_in_flight_bytes=self._max_in_flight_bytes,
                                  ordered=ordered or i != last_map,
                                  stats=self.stats)
            elif op[0] == "filter":
                ait = _afiltered(ait, op[1])
            elif op[0] == "batch":
                ait = _abatched(ait, op[1])
        return ait

    def collect(self, ordered: bool = True) -> list:
        """Run the pipeline to a list — input order by default,
        completion order with ``ordered=False``."""
        return list(self._run(ordered=ordered))

    async def collect_async(self, ordered: bool = True) -> list:
        """``collect()`` for coroutines: awaitable, never blocks the
        calling event loop while futures are in flight."""
        return [v async for v in self._run_async(ordered=ordered)]

    def as_completed(self) -> Iterator:
        """Iterate results in completion order, streaming: O(in-flight)
        memory, safe over unbounded sources (breaking out cancels the
        in-flight tail)."""
        return self._run(ordered=False)

    def as_completed_async(self) -> AsyncIterator:
        """``async for v in s.as_completed_async()``: completion-order
        results inside a running event loop — same O(in-flight) memory and
        backpressure as :meth:`as_completed`, with every wait cooperative
        (the loop stays responsive while chunks are in flight; breaking
        out / ``aclose()`` cancels the in-flight tail)."""
        return self._run_async(ordered=False)

    def reduce(self, op: Callable, init: Any = _MISSING) -> Any:
        """Fold results *as they complete* (lowest memory, lowest latency;
        use an associative+commutative ``op`` for deterministic results).
        Without ``init``, the first completed result seeds the fold."""
        acc = init
        for v in self._run(ordered=False):
            acc = v if acc is _MISSING else op(acc, v)
        if acc is _MISSING:
            raise ValueError("reduce() of an empty stream with no init")
        return acc

    def __iter__(self) -> Iterator:
        return self._run(ordered=True)

    def __repr__(self):
        return (f"<Stream {self._label} stages={len(self._ops)} "
                f"max_in_flight={self._max_in_flight}>")


def stream(xs: Iterable, *, max_in_flight: "int | None" = None,
           max_in_flight_bytes: "int | None" = None,
           label: "str | None" = None) -> Stream:
    """Open a streaming pipeline over any iterable (lists, generators —
    including unbounded ones; the source is never materialized).

    ``max_in_flight`` bounds outstanding futures per ``.map`` stage
    (default ``2 * backend.workers``: one wave computing, one wave of
    results/refills in the pipe). ``max_in_flight_bytes`` additionally
    bounds the *estimated payload bytes* of admitted-but-unharvested
    chunks — the right knob for size-skewed streams, where an element
    count bounds nothing (ten 100 MiB arrays vs ten floats). At least one
    chunk is always in flight, so a single over-budget element still
    makes progress.
    """
    return Stream(xs, max_in_flight=max_in_flight,
                  max_in_flight_bytes=max_in_flight_bytes, label=label)


__all__ = ["Stream", "stream"]
