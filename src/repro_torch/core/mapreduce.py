"""Map-reduce frontends built on the three Future constructs.

The paper argues the Future API is *sufficient* to build every higher-level
parallel pattern (future.apply / furrr / doFuture are thin layers). This
module is our ``future.mapreduce``: the shared chunking ("load balancing"),
per-element RNG, ordered collection, retry, and speculative-execution
helpers that the paper's §Future-work proposes centralizing.

* :func:`future_map` — parallel map with one-chunk-per-worker load
  balancing, per-element RNG streams that are invariant to
  chunking/backend, and as-completed collection. Since the streaming
  redesign it is sugar over ``stream(xs).map(fn).collect(ordered=True)``
  (`core/stream.py`) — same public signature, ordering, RNG streams,
  retry and error-relay semantics, but dispatch is admission-controlled
  instead of blocking inside ``Backend.submit``.
* :func:`future_either` — the Hewitt&Baker (EITHER ...) construct: first
  resolved wins, the losers are cancelled: speculative straggler
  mitigation.
* :func:`retry` / :func:`retry_future` — re-dispatch on FutureError
  (restart(f) analogue), with completion-callback-scheduled backoff (no
  sleeps on the caller's thread).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Sequence

from . import planning as plan_mod
from .errors import FutureError
from .future import (Future, _CHAIN, _merge_runs, _outcome,
                     _spawn_continuation, first, future, merge, value)
from .stream import stream


def _chunk_slices(n: int, chunks: int) -> list[range]:
    chunks = max(1, min(chunks, n))
    base, extra = divmod(n, chunks)
    out, start = [], 0
    for i in range(chunks):
        size = base + (1 if i < extra else 0)
        out.append(range(start, start + size))
        start += size
    return out


def future_map(fn: Callable, xs: Sequence, *,
               seed: bool | int | None = None,
               chunks: int | None = None,
               label: str | None = None,
               retries: int = 0,
               ) -> list:
    """Parallel map: ``[fn(x) for x in xs]`` resolved via futures.

    Load balancing (paper §Future work): elements are partitioned into
    ``chunks`` chunks (default: one per worker) and each chunk becomes one
    future — one merge()d task per worker instead of one future per element.

    Per-element RNG: with ``seed=``, each *element* gets the key
    ``rng.stream_key(i)`` (a ``SeedSequence`` of the session seed and the
    element's index) passed as ``key=`` — identical results for any
    chunking, backend, or worker count (the paper's CMRG guarantee).

    Sugar over the streaming frontend: the exact chunk-size plan computed
    here is handed to ``stream(xs).map(...)``, whose pump dispatches
    through the backend admission protocol and collects as-completed.
    """
    xs = list(xs)
    if not xs:
        return []
    backend = plan_mod.active_backend()
    n_chunks = chunks or backend.workers
    sizes = [len(r) for r in _chunk_slices(len(xs), n_chunks)]
    # max_in_flight = every chunk: the input is already materialized and
    # the output is a full list, so the stream's O(in-flight) buffer cap
    # buys no memory here and would only add a head-of-line stall (a slow
    # early chunk blocking dispatch of later ones — the eager frontend
    # never had one). Admission still bounds *actual* concurrency at the
    # backend's free slots.
    return (stream(xs, max_in_flight=len(sizes), label=label or "map")
            .map(fn, seed=seed, retries=retries, label=label or "map",
                 _chunk_sizes=sizes)
            .collect(ordered=True))


def future_lapply(xs: Sequence, fn: Callable, **kw) -> list:
    """R argument order, for familiarity."""
    return future_map(fn, xs, **kw)


def future_either(*thunks: Callable, label: str | None = None) -> Any:
    """Evaluate thunks concurrently; return the value of the first one that
    finishes; cancel the rest (paper §Other uses / Hewitt & Baker 1977).

    This is the speculative-execution primitive: dispatch the same work
    twice and take whichever worker is not the straggler. It is now sugar
    over the continuation combinator :func:`repro_torch.core.first` — the winner
    is pushed by its backend's completion callback and the losers are
    cancelled inside the combinator.
    """
    if not thunks:
        raise ValueError("future_either() needs at least one expression")
    fs = [future(t, label=f"{label or 'either'}[{i}]")
          for i, t in enumerate(thunks)]
    return first(fs, label=f"{label or 'either'}-first").value()


def retry_future(fn: Callable, *, times: int = 3, backoff_s: float = 0.0,
                 on: type = FutureError, label: str | None = None) -> Future:
    """Asynchronous retry: a future that re-dispatches ``fn`` on failures
    matching ``on`` (default: infrastructure :class:`FutureError` only),
    up to ``times`` attempts, with exponential ``backoff_s`` between them.

    Fully event-driven: each attempt's completion callback decides
    (succeed / re-dispatch / give up), and backoff is scheduled by a timer
    — no thread sleeps between attempts, so callers can hold many retrying
    futures concurrently and compose them (``gather(retry_future(...) for
    ...)``) without parking a thread per retry. The captured output of
    every failed attempt is relayed, in attempt order, at ``value()``.
    """
    if times < 1:
        raise ValueError("retry needs times >= 1")
    out = Future._derived(label or "retry")
    prefixes: list = []                  # captures of failed attempts
    # Attempts must run under the *caller's* plan context. The old retry
    # looped on the caller's thread, so a retry inside a worker dispatched
    # every attempt to the worker's nested (sequential) plan; re-attempts
    # now fire from continuation/timer threads, which would otherwise see
    # the global plan — and a worker blocked in value(retry_future(...))
    # holding the last global slot would deadlock against its own retry.
    caller_stack = plan_mod.thread_stack_override()

    def attempt(k: int) -> None:
        # guarded: a timer-scheduled attempt runs on the timer thread, so
        # a failure creating the future (backend shut down between
        # attempts, globals no longer shippable) must resolve `out` with
        # the error, not die as an unhandled thread exception leaving
        # value() hung forever
        try:
            if caller_stack is None:
                f = future(fn, label=f"{label or 'retry'}#{k}")
            else:
                # nested-context attempt: with the default sequential
                # nested plan the future resolves eagerly inside this
                # scope, before its teardown
                with plan_mod.use_nested_stack(caller_stack):
                    f = future(fn, label=f"{label or 'retry'}#{k}")
            f._register(lambda _h: _spawn_continuation(
                out, lambda: settle(f, k), backend=f._backend))
        except BaseException as exc:                 # noqa: BLE001
            _CHAIN.complete(out._handle, error=exc)

    def settle(f: Future, k: int) -> None:
        run, infra = _outcome(f)
        failure = infra if infra is not None \
            else (run.error if run is not None else None)
        if failure is not None and isinstance(failure, on) \
                and k + 1 < times:
            if run is not None:          # keep the failed attempt's output
                prefixes.append(dataclasses.replace(
                    run, error=None, error_tb=None))
            delay = backoff_s * (2 ** k) if backoff_s else 0.0
            if delay > 0:
                # completion-callback-scheduled backoff: the caller's
                # thread sleeps in value()'s event wait, never here
                t = threading.Timer(delay, attempt, args=(k + 1,))
                t.daemon = True
                t.start()
            else:
                attempt(k + 1)
            return
        if infra is not None:
            _CHAIN.complete(out._handle, error=infra)
            return
        merged = run
        for prefix in reversed(prefixes):
            merged = _merge_runs(prefix, merged)
        _CHAIN.complete(out._handle, run=merged)

    attempt(0)
    return out


def retry(fn: Callable, *, times: int = 3, backoff_s: float = 0.0,
          on: type = FutureError, label: str | None = None) -> Any:
    """retry({...}, times=3, on="FutureError") from the paper's roadmap:
    re-dispatch a future when it fails with an *infrastructure* error
    (a :class:`FutureError`, e.g. a cancellation). Evaluation errors
    propagate immediately —
    they would fail deterministically anywhere. Blocking sugar over
    :func:`retry_future` (the backoff clock never runs on this thread)."""
    return retry_future(fn, times=times, backoff_s=backoff_s, on=on,
                        label=label).value()


def future_map_chunked_lazy(fn: Callable, xs: Sequence, *,
                            chunks: int) -> list:
    """Didactic variant following the paper's §Future-work construction
    literally: per-element *lazy* futures merged into chunk futures."""
    lazy = [future(fn, x, lazy=True) for x in xs]
    merged = [merge([lazy[i] for i in rng])
              for rng in _chunk_slices(len(lazy), chunks)]
    return value(merged)
