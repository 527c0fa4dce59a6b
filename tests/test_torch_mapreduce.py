"""The port's map-reduce layer (``repro_torch.core.mapreduce``): a mirror of
tests/test_mapreduce.py — chunking and load balancing, ordering, RNG
invariance over the port's backends — and the chunk plan held against the
JAX package's."""

import threading
import time

import pytest
import torch
from _hypothesis_shim import given, settings, st
from _torch_parity import BACKENDS, BACKEND_IDS, _reset_port  # noqa: F401

import repro_torch.core as rc
from repro_torch.core import (future_lapply, future_map,
                              future_map_chunked_lazy)
from repro_torch.core import rng as rng_mod
from repro_torch.core.mapreduce import _chunk_slices


def test_chunk_slices_partition_exactly():
    for n in (0, 1, 7, 10, 64):
        for c in (1, 2, 3, 10, 100):
            sl = _chunk_slices(n, c) if n else []
            flat = [i for r in sl for i in r]
            assert flat == list(range(n))


def test_chunk_slices_match_the_jax_package():
    """The load-balancing plan is the reference's, range for range."""
    from repro.core.mapreduce import _chunk_slices as ref_chunk_slices
    for n in range(65):
        for c in range(1, 18):
            assert _chunk_slices(n, c) == ref_chunk_slices(n, c), (n, c)


@given(n=st.integers(0, 40), chunks=st.integers(1, 8))
@settings(max_examples=25, deadline=None)
def test_map_equals_list_comprehension(n, chunks):
    xs = list(range(n))
    assert future_map(lambda v: v * 3 + 1, xs, chunks=chunks) \
        == [v * 3 + 1 for v in xs]


def test_results_ordered_despite_uneven_runtimes():
    rc.plan("threads", workers=3)

    def slow_for_small(x):
        time.sleep(0.05 if x < 2 else 0.0)
        return x

    assert future_map(slow_for_small, list(range(6)), chunks=6) \
        == list(range(6))


def test_rng_invariant_to_chunking_and_backend():
    def draw(x, key):
        return float(rng_mod.normal(key, ()))

    rc.set_session_seed(7)
    ref = future_map(draw, [0] * 6, seed=True, chunks=1)

    for _id, name, kw in BACKENDS:
        rc.plan(name, **kw)
        rc.set_session_seed(7)
        for chunks in (1, 2, 6):
            got = future_map(draw, [0] * 6, seed=True, chunks=chunks)
            assert got == ref, (name, chunks)
        rc.shutdown()


def test_lazy_merge_construction_matches():
    xs = list(range(9))
    assert future_map_chunked_lazy(lambda v: v - 1, xs, chunks=2) \
        == [v - 1 for v in xs]


def test_lapply_argument_order():
    assert future_lapply([1, 2], lambda v: v * 10) == [10, 20]


def test_empty_input():
    assert future_map(lambda v: v, []) == []


def test_future_map_straggler_does_not_stall_dispatch():
    """A slow early chunk must not stall dispatch of later chunks behind
    the ordered-result buffer."""
    rc.plan("threads", workers=2)
    release = threading.Event()
    lock = threading.Lock()
    started = []

    def elem(x):
        with lock:
            started.append(x)
        if x == 0:
            release.wait(10)             # chunk 0 is the straggler
        return x

    result = []
    t = threading.Thread(
        target=lambda: result.append(future_map(elem, list(range(6)),
                                                chunks=6)))
    t.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        with lock:
            if len(started) == 6:
                break
        time.sleep(0.01)
    with lock:
        n_before_release = len(started)
    release.set()
    t.join(10)
    rc.shutdown()
    assert n_before_release == 6         # all chunks ran past the straggler
    assert result and result[0] == list(range(6))


@pytest.mark.parametrize("name,kw", [(b[1], b[2]) for b in BACKENDS],
                         ids=BACKEND_IDS)
def test_rng_misuse_warning(name, kw):
    """Undeclared RNG use inside a future warns (paper §parallel RNG), on
    every backend, and inside a map too."""
    rc.plan(name, **kw)
    key = rng_mod.stream_key(0)

    def draws_without_seed(_x=None):
        return float(rng_mod.normal(key, ()))

    with pytest.warns(rc.RNGMisuseWarning):
        rc.value(rc.future(draws_without_seed))
    with pytest.warns(rc.RNGMisuseWarning):
        future_map(draws_without_seed, [0, 1])


def test_future_map_of_tensors_keeps_values():
    """Tensors cross the frontend as they are: the same objects' values,
    in input order."""
    rc.plan("threads", workers=2)
    xs = [torch.full((3,), float(i)) for i in range(5)]
    got = future_map(lambda t: t * 2, xs)
    for i, g in enumerate(got):
        torch.testing.assert_close(g, torch.full((3,), 2.0 * i))
