"""The port's streaming frontend (``repro_torch.core.stream``): a mirror of
tests/test_stream.py's in-process rows — bounded in-flight backpressure,
admission-controlled dispatch, unbounded sources, RNG invariance across
``max_in_flight``, ``retries=`` — and a pipeline held against the JAX
package's on the same generator (values and stats).

The rows of the reference on worker processes or the cluster (dead-worker
retries, the cluster's idle set) wait for the port's out-of-process
backends; the retry contract is held here on threads with a body that
raises ``FutureError`` on its first try.
"""

import itertools
import threading
import time

import numpy as np
import pytest
from _torch_parity import BACKENDS, _reset_port, backend  # noqa: F401

import repro_torch.core as rc
from repro_torch.core import FutureError, future_map, stream
from repro_torch.core import rng as rng_mod


# --------------------------------------------------------------------------
# the stream conformance row, across the port's backend matrix
# --------------------------------------------------------------------------

def test_stream_pipeline_stages_full_matrix(backend):
    """filter -> batch -> map -> collect, generator input, on every
    backend."""
    s = stream(i for i in itertools.islice(itertools.count(), 24))
    got = (s.filter(lambda v: v % 3 != 0)
           .batch(4)
           .map(sum, chunk=2)
           .collect(ordered=True))
    kept = [v for v in range(24) if v % 3 != 0]
    want = [sum(kept[i:i + 4]) for i in range(0, len(kept), 4)]
    assert got == want
    assert s.stats["peak_in_flight"] <= s.stats["max_in_flight"]


def test_stream_unordered_collect_is_same_multiset(backend):
    xs = list(range(20))
    got = stream(xs).map(lambda v: v * v, chunk=3).collect(ordered=False)
    assert sorted(got) == [v * v for v in xs]


# --------------------------------------------------------------------------
# backpressure: peak in-flight <= max_in_flight, by a counting harness
# --------------------------------------------------------------------------

def test_backpressure_bounds_concurrency_threads():
    """With ``max_in_flight`` below the worker count, the number of
    *simultaneously executing* bodies stays within the bound."""
    rc.plan("threads", workers=4)
    lock = threading.Lock()
    counts = _Counts()

    def body(x, _c=counts):
        with lock:
            _c.cur += 1
            _c.peak = max(_c.peak, _c.cur)
        time.sleep(0.005)
        with lock:
            _c.cur -= 1
        return x

    s = stream(range(40), max_in_flight=2)
    assert s.map(body).collect() == list(range(40))
    assert counts.peak <= 2
    assert 0 < s.stats["peak_in_flight"] <= 2


class _Counts:
    """Shared counters by reference (a dict would be snapshotted)."""

    def __init__(self):
        self.cur = self.peak = 0
        self.tries = 0


# --------------------------------------------------------------------------
# unbounded / huge sources: O(in-flight) memory, never materialized
# --------------------------------------------------------------------------

def test_unbounded_generator_as_completed_breaks_cleanly():
    rc.plan("threads", workers=2)
    seen = []
    for v in stream(itertools.count()).map(lambda v: v, chunk=4) \
            .as_completed():
        seen.append(v)
        if len(seen) >= 50:
            break                        # GeneratorExit cancels the tail
    assert sorted(seen)[:4] == [0, 1, 2, 3]
    assert rc.value(rc.future(lambda: "alive")) == "alive"


def test_million_element_generator_is_streamed_not_materialized():
    """A 1M-element generator reduces with peak in-flight <= max_in_flight
    and the pump never pulls more than the in-flight window ahead of
    consumption."""
    rc.plan("threads", workers=2)
    n, chunk, mif = 1_000_000, 5_000, 4
    counts = {"pulled": 0, "consumed": 0, "max_lead": 0}

    def source():
        for _ in range(n):
            counts["pulled"] += 1
            yield 1

    def note(a, b):
        counts["consumed"] += chunk
        counts["max_lead"] = max(counts["max_lead"],
                                 counts["pulled"] - counts["consumed"])
        return a + b

    s = stream(source(), max_in_flight=mif)
    got = s.batch(chunk).map(sum, chunk=1).reduce(note)
    assert got == n
    assert counts["pulled"] == n
    assert 0 < s.stats["peak_in_flight"] <= mif
    assert counts["max_lead"] <= (mif + 3) * chunk


# --------------------------------------------------------------------------
# RNG invariance across max_in_flight (the CMRG guarantee, streamed)
# --------------------------------------------------------------------------

def _draw(x, key):
    return float(rng_mod.normal(key, ()))


def test_rng_invariant_to_max_in_flight_and_chunk():
    rc.set_session_seed(11)
    ref = future_map(_draw, [0] * 8, seed=True, chunks=1)

    for _id, name, kw in BACKENDS:
        rc.plan(name, **kw)
        for mif in (1, 3, 16):
            for chunk in (1, 3):
                rc.set_session_seed(11)
                got = (stream([0] * 8, max_in_flight=mif)
                       .map(_draw, seed=True, chunk=chunk)
                       .collect(ordered=True))
                assert got == ref, (name, mif, chunk)
        rc.shutdown()


def test_int_seed_offsets_element_indices_like_future_map():
    rc.set_session_seed(3)
    ref = future_map(_draw, [0] * 4, seed=7, chunks=2)
    rc.set_session_seed(3)
    got = stream([0] * 4).map(_draw, seed=7, chunk=3).collect()
    assert got == ref


# --------------------------------------------------------------------------
# retries: FutureError-driven re-dispatch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("retries", [0, 1])
def test_stream_retries_future_error_on_threads(retries):
    """A chunk whose body raises FutureError (an infrastructure failure)
    on its first try is re-dispatched ``retries`` times; with none left
    the error propagates as-is. Evaluation errors are never retried."""
    rc.plan("threads", workers=2)
    counts = _Counts()
    lock = threading.Lock()

    def elem(x, _c=counts):
        if x == 3:
            with lock:
                _c.tries += 1
                first = _c.tries == 1
            if first:
                raise FutureError("lost on its first try")
        return x * 2

    s = stream(range(6), max_in_flight=2)
    if retries:
        assert s.map(elem, retries=retries).collect() == [0, 2, 4, 6, 8, 10]
        assert s.stats["retried"] == 1 and counts.tries == 2
    else:
        with pytest.raises(FutureError, match="first try"):
            s.map(elem, retries=retries).collect()
        assert counts.tries == 1
    with pytest.raises(ValueError):
        stream(range(3)).map(lambda v: int("x"), retries=3).collect()


# --------------------------------------------------------------------------
# semantics edges
# --------------------------------------------------------------------------

def test_reduce_empty_and_init():
    assert stream([]).map(lambda v: v).reduce(lambda a, b: a + b,
                                              init=42) == 42
    with pytest.raises(ValueError):
        stream([]).map(lambda v: v).reduce(lambda a, b: a + b)
    assert stream([5]).map(lambda v: v).reduce(lambda a, b: a + b) == 5


def test_streams_are_immutable_and_chainable():
    base = stream(range(6))
    doubled = base.map(lambda v: v * 2)
    assert len(base._ops) == 0 and len(doubled._ops) == 1
    assert doubled.collect() == [0, 2, 4, 6, 8, 10]


def test_batch_validates():
    with pytest.raises(ValueError):
        stream([1]).batch(0)


def test_future_map_is_stream_sugar_same_results():
    rc.plan("threads", workers=3)
    xs = list(range(17))
    assert future_map(lambda v: v - 1, xs, chunks=5) \
        == [v - 1 for v in xs]
    assert future_map(lambda v: v - 1, xs) == [v - 1 for v in xs]
    assert future_map(lambda v: v, []) == []


# --------------------------------------------------------------------------
# Byte-denominated backpressure: stream(..., max_in_flight_bytes=)
# --------------------------------------------------------------------------

def test_max_in_flight_bytes_bounds_admission():
    rc.plan("threads", workers=4)
    arrs = [np.zeros(1 << 18) for _ in range(12)]        # 2 MiB each
    budget = 5 * (1 << 21)                               # 10 MiB
    s = stream(arrs, max_in_flight_bytes=budget)
    assert s.map(lambda a: float(a.sum())).collect(ordered=True) \
        == [0.0] * 12
    assert 0 < s.stats["peak_in_flight_bytes"] <= budget
    assert s.stats["max_in_flight_bytes"] == budget


def test_max_in_flight_bytes_counts_tensor_bytes():
    """torch tensors count their ``.nbytes`` like numpy arrays."""
    import torch
    rc.plan("threads", workers=4)
    ts = [torch.zeros(1 << 18, dtype=torch.float64) for _ in range(6)]
    budget = 3 * (1 << 21)
    s = stream(ts, max_in_flight_bytes=budget)
    assert s.map(lambda t: float(t.sum())).collect() == [0.0] * 6
    assert 0 < s.stats["peak_in_flight_bytes"] <= budget


def test_max_in_flight_bytes_progress_guarantee():
    rc.plan("threads", workers=2)
    arrs = [np.zeros(1 << 18) for _ in range(3)]
    s = stream(arrs, max_in_flight_bytes=1024)           # tiny budget
    assert s.map(lambda a: a.shape[0]).collect(ordered=True) \
        == [1 << 18] * 3
    assert s.stats["peak_in_flight"] == 1


def test_max_in_flight_bytes_composes_with_count_bound():
    rc.plan("threads", workers=4)
    s = stream(iter(range(40)), max_in_flight=3,
               max_in_flight_bytes=1 << 20)
    assert sorted(s.map(lambda v: v + 1, chunk=4).collect()) \
        == [v + 1 for v in range(40)]
    assert s.stats["peak_in_flight"] <= 3
    assert s.stats["peak_in_flight_bytes"] <= 1 << 20


# --------------------------------------------------------------------------
# parity with the JAX package's stream
# --------------------------------------------------------------------------

def _pipeline(core):
    src = (np.full(i % 7 + 1, float(i)) for i in range(30))
    s = core.stream(src, max_in_flight=3, max_in_flight_bytes=96)
    out = (s.filter(lambda a: int(a[0]) % 4 != 1)
           .map(lambda a: float(a.sum()), chunk=2)
           .map(lambda v: v + 0.5)
           .collect(ordered=True))
    return out, dict(s.stats)


def test_stream_values_and_stats_match_the_jax_package():
    """The same pipeline over the same generator of numpy arrays under
    ``sequential`` gives the reference's values and stats: chunks
    dispatched, ``peak_in_flight`` and ``peak_in_flight_bytes``."""
    import repro.core as ref_core
    ref_core.plan("sequential")
    got, stats = _pipeline(rc)
    want, ref_stats = _pipeline(ref_core)
    assert got == want
    assert stats == ref_stats
    assert stats["dispatched"] > 1 and stats["peak_in_flight_bytes"] > 0
