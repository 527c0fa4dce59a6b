"""Future API conformance over the port's backends (a mirror of
tests/test_conformance.py): every backend — sequential, threads, asyncio
and cuda_async (in its synchronous ``device="cpu"`` form here; on the card
it resolves through CUDA events) — gives the same values, the same relayed
output and conditions, the same exceptions and the same RNG streams. Also
the rows of tests/test_continuations.py that tests/test_torch_core.py does
not mirror, with the in-process backends in place of the cluster.

The ``processes`` rows, with the blob path of large state values and the
worker-isolation and worker-death rows, are in tests/test_torch_processes.py
(``BACKENDS`` stays in process, so that worker startup is not paid in every
mirror).
"""

import asyncio
import threading
import time
import warnings

import pytest
import torch
from _torch_parity import _reset_port, backend  # noqa: F401

import repro_torch.core as rc
from repro_torch.core import (first, first_successful, future, future_map,
                              gather, value, wait_any)
from repro_torch.core import rng as rng_mod
from repro_torch.core.backends.base import BACKEND_REGISTRY


def test_same_value(backend):
    x = 11
    assert value(future(lambda: x * 3)) == 33


def test_value_timeout(backend):
    f = future(lambda: time.sleep(0.5) or 7)
    if not rc.resolved(f):                # eager backends resolve at create
        with pytest.raises(TimeoutError):
            f.value(timeout=0.05)
    assert f.value(timeout=30.0) == 7
    assert value(f, timeout=30.0) == 7


def test_snapshot_semantics(backend):
    x = 1
    f = future(lambda: x + 100)
    x = 2  # noqa: F841
    assert value(f) == 101


def test_exception_relayed_as_is(backend):
    f = future(lambda: int("not-a-number"))
    with pytest.raises(ValueError):
        value(f)


def test_stdout_relay(backend, capsys):
    f = future(lambda: print("from-the-future") or 1)
    assert value(f) == 1
    assert "from-the-future" in capsys.readouterr().out


def test_warning_relay(backend):
    def body():
        warnings.warn("relayed-warning")
        return 2

    f = future(body)
    with warnings.catch_warnings(record=True) as wlist:
        warnings.simplefilter("always")
        assert value(f) == 2
    assert any("relayed-warning" in str(w.message) for w in wlist)


def test_rng_stream_invariance(backend):
    """seed=: the same stream on every backend — the future's key is the
    session's stream 0."""
    rc.set_session_seed(1234)
    f = future(lambda key: float(rng_mod.normal(key, ())), seed=True)
    got = value(f)
    expected = float(rng_mod.normal(rng_mod.stream_key(0), ()))
    assert got == expected


def test_map_matches_sequential(backend):
    xs = list(range(7))
    assert future_map(lambda v: v * v, xs) == [v * v for v in xs]


def test_nested_parallelism_protection(backend):
    """A future created inside a future defaults to the sequential
    (popped) stack (paper §Nested parallelism)."""
    def outer():
        from repro_torch.core import active_backend
        inner = future(lambda: 1)
        return (type(active_backend()).__name__, value(inner))

    name, v = value(future(outer))
    assert v == 1
    assert name == "SequentialBackend"


# --------------------------------------------------------------------------
# continuation combinators: same values / relay / exceptions on every backend
# --------------------------------------------------------------------------

def test_then_map_chain_value(backend):
    f = future(lambda: 10).then(lambda v: v + 1).map(lambda v: v * 2)
    assert value(f) == 22


def test_then_flattens_returned_future(backend):
    f = future(lambda: 3).then(lambda v: future(lambda: v * 7))
    assert value(f) == 21


def test_chain_propagates_parent_error(backend):
    trace = []
    f = future(lambda: int("nope")).then(lambda v: trace.append(v))
    with pytest.raises(ValueError):
        value(f)
    with pytest.raises(ValueError):
        value(f)
    assert trace == []


def test_chain_raises_continuation_error(backend):
    f = future(lambda: 1).map(lambda v: [0][3])
    with pytest.raises(IndexError):
        value(f)


def test_chain_relays_whole_chain_stdout(backend, capsys):
    f = future(lambda: print("from-parent") or 2)
    g = f.map(lambda v: print("from-map") or v * 2)
    assert value(g) == 4
    out = capsys.readouterr().out
    assert out.index("from-parent") < out.index("from-map")


def test_recover_handles_error_and_passes_value(backend):
    bad = future(lambda: 1 / 0).recover(lambda exc: type(exc).__name__)
    assert value(bad) == "ZeroDivisionError"
    ok = future(lambda: 5).recover(lambda exc: -1)
    assert value(ok) == 5


def test_gather_values_and_error_propagation(backend):
    fs = [future(lambda i=i: i * i) for i in range(5)]
    assert value(gather(fs)) == [0, 1, 4, 9, 16]
    mixed = gather([future(lambda: 1), future(lambda: int("x"))])
    with pytest.raises(ValueError):
        value(mixed)


def test_first_returns_earliest_completion(backend):
    fast = future(lambda: "fast")
    slow = future(lambda: time.sleep(0.2) or "slow")
    assert value(first([fast, slow])) == "fast"


def test_first_successful_skips_failures(backend):
    f = first_successful([future(lambda: 1 / 0), future(lambda: "ok")])
    assert value(f) == "ok"


def test_first_successful_all_failures_propagates_first(backend):
    f = first_successful([future(lambda: 1 / 0),
                          future(lambda: [0][3])])
    with pytest.raises(ZeroDivisionError):
        value(f)


# --------------------------------------------------------------------------
# streaming frontend: the conformance-matrix `stream` rows
# --------------------------------------------------------------------------

def test_stream_matches_map(backend):
    xs = list(range(10))
    s = rc.stream(iter(xs))
    assert s.map(lambda v: v * 3, chunk=4).collect(ordered=True) \
        == [v * 3 for v in xs]
    assert 0 < s.stats["peak_in_flight"] <= s.stats["max_in_flight"]


def test_stream_reduce_over_generator(backend):
    got = (rc.stream(i for i in range(30))
           .filter(lambda v: v % 2 == 0)
           .map(lambda v: v + 1, chunk=5)
           .reduce(lambda a, b: a + b))
    assert got == sum(v + 1 for v in range(30) if v % 2 == 0)


def test_stream_error_relayed_as_is(backend):
    with pytest.raises(ValueError):
        rc.stream([1, 2, 3]).map(lambda v: int("nope")).collect()


_CHAIN_N = 1 << 14


def test_result_chain_values(backend):
    f = future(lambda: torch.arange(_CHAIN_N, dtype=torch.float64))
    g = f.then(lambda a: torch.sqrt(a + 1.0)).map(lambda a: float(a.sum()))
    expected = float(torch.sqrt(
        torch.arange(_CHAIN_N, dtype=torch.float64) + 1.0).sum())
    assert value(g) == expected          # bit-identical, not approx


def test_result_chain_exception_and_recover(backend):
    f = future(lambda: torch.arange(_CHAIN_N, dtype=torch.float64))
    with pytest.raises(ValueError):
        value(f.then(lambda a: int("nope")))
    h = f.then(lambda a: int("nope")).recover(lambda e: type(e).__name__)
    assert value(h) == "ValueError"


def test_result_chain_rng_stream_invariance(backend):
    """A continuation hop does not consume a stream index: a seeded future
    created after the chain draws the same stream on every backend."""
    rc.set_session_seed(77)
    f = future(lambda: torch.arange(_CHAIN_N, dtype=torch.float64))
    assert value(f.then(lambda a: float(a[0]))) == 0.0
    tail = future(lambda key: float(rng_mod.normal(key, ())), seed=True)
    assert value(tail) == float(rng_mod.normal(rng_mod.stream_key(1), ()))


def test_stream_two_maps_fused_parity(backend):
    xs = list(range(12))
    s = (rc.stream(iter(xs))
         .map(lambda v: v * 2, chunk=3)
         .map(lambda v: float(v) + 0.5))
    assert s.collect(ordered=True) == [v * 2 + 0.5 for v in xs]
    assert s.stats["dispatched"] == 4    # adjacent maps fused into one hop


def test_stream_fused_seeded_maps_rng_parity(backend):
    def run():
        rc.set_session_seed(9)
        return (rc.stream(i for i in range(6))
                .map(lambda v, key: v + float(rng_mod.uniform(key, ())),
                     seed=True, chunk=2)
                .map(lambda v, key: v * float(rng_mod.uniform(key, ())),
                     seed=True)
                .collect(ordered=True))

    got = run()
    rc.plan("sequential")
    assert got == run()                  # bit-identical floats


# --------------------------------------------------------------------------
# shared-state service: the same task-body code on every backend
# --------------------------------------------------------------------------

@pytest.mark.state
def test_state_semantics_tuple(backend):
    def body():
        from repro_torch.core import state
        out = []
        out.append(state.put("sem.k", "a"))
        out.append(state.put("sem.k", "b"))
        out.append(state.get("sem.k"))
        out.append(state.version("sem.k"))
        ok, ver, _ = state.cas("sem.k", 2, "c")
        out.append((ok, ver))
        ok2, ver2, cur2 = state.cas("sem.k", 2, "zz")
        out.append((ok2, ver2, cur2))
        out.append(state.delete("sem.k"))
        out.append(state.get("sem.k", None))
        out.append(state.version("sem.k"))
        ok3, ver3, _ = state.cas("sem.k", 3, "d")
        out.append((ok3, ver3))
        return out

    assert value(future(body)) == [
        1, 2, "b", 2, (True, 3), (False, 3, "c"), True, None, 3, (True, 4)]
    assert rc.state.read("sem.k") == ("d", 4)


@pytest.mark.state
def test_state_concurrent_update_is_exact_fold(backend):
    n_tasks, per_task = 8, 4

    def body():
        from repro_torch.core import state
        for _ in range(per_task):
            state.update("fold.acc", lambda v: (v or 0) + 1)
        return True

    fs = [future(body) for _ in range(n_tasks)]
    assert value(gather(fs)) == [True] * n_tasks
    assert rc.state.get("fold.acc") == n_tasks * per_task
    assert rc.state.version("fold.acc") == n_tasks * per_task


@pytest.mark.state
def test_state_cas_exactly_one_winner(backend):
    def body(i):
        from repro_torch.core import state
        ok, ver, cur = state.cas("race.k", 0, i)
        return (ok, ver)

    fs = [future(lambda i=i: body(i)) for i in range(6)]
    got = value(gather(fs))
    assert sum(1 for ok, _ in got if ok) == 1
    assert all(ver == 1 for _, ver in got)
    assert rc.state.version("race.k") == 1


@pytest.mark.state
def test_state_wait_blocks_until_put(backend):
    def putter():
        import time
        from repro_torch.core import state
        time.sleep(0.05)
        state.put("sig.k", "go")
        return True

    def waiter():
        from repro_torch.core import state
        val, ver = state.wait("sig.k", 1, timeout=30)
        return (val, ver >= 1)

    p = future(putter)
    w = future(waiter)
    assert value(w) == ("go", True)
    assert value(p) is True


@pytest.mark.state
def test_state_wait_timeout_relayed(backend):
    from repro_torch.core.state import StateTimeout

    def body():
        from repro_torch.core import state
        try:
            state.wait("never.k", 1, timeout=0.1)
        except Exception as exc:                        # noqa: BLE001
            return type(exc).__name__
        return "no-error"

    assert value(future(body)) == StateTimeout.__name__


# --------------------------------------------------------------------------
# rows of tests/test_continuations.py beyond tests/test_torch_core.py
# --------------------------------------------------------------------------

def test_wait_any_two_backends_single_event_wait():
    """wait_any over threads + asyncio futures wakes on the first
    completion's push, not after a polling slice. (The bound leaves room
    for a loaded host; a round-robin over the two backends would park for
    the slow body's 3 s.)"""
    tb = BACKEND_REGISTRY["threads"](workers=1)
    ab = BACKEND_REGISTRY["asyncio"]()
    try:
        async def slow_body():
            await asyncio.sleep(3.0)
            return "slow"

        slow = future(slow_body, backend=ab)
        fast = future(lambda: time.sleep(0.3) or "fast", backend=tb)
        t0 = time.monotonic()
        ready = wait_any([slow, fast])
        wake_latency = time.monotonic() - t0 - 0.3
        assert fast in ready and slow not in ready
        assert wake_latency < 0.5, f"woke {wake_latency * 1e3:.1f}ms late"
        slow.cancel()
    finally:
        ab.shutdown()
        tb.shutdown()


def test_gather_spans_four_backends():
    bs = [BACKEND_REGISTRY["sequential"](),
          BACKEND_REGISTRY["threads"](workers=1),
          BACKEND_REGISTRY["asyncio"](),
          BACKEND_REGISTRY["cuda_async"](device="cpu")]
    try:
        g = gather([future(lambda i=i: i, backend=b)
                    for i, b in enumerate(bs)])
        assert value(g) == [0, 1, 2, 3]
    finally:
        for b in bs:
            b.shutdown()


def test_first_cancels_losers_asyncio():
    """On the asyncio backend a cancelled loser is really stopped: its
    future fails fast instead of running out its 60 s body."""
    rc.plan("asyncio")

    async def loser():
        await asyncio.sleep(60)
        return "loser"

    fast = future(lambda: "winner")
    slow = future(loser)
    assert value(first([fast, slow])) == "winner"
    t0 = time.monotonic()
    with pytest.raises(rc.FutureError):
        value(slow)
    assert time.monotonic() - t0 < 30


def test_recover_catches_infrastructure_errors():
    """recover() sees FutureErrors (a cancellation here), not just
    evaluation errors — the retry/fallback building block."""
    rc.plan("asyncio")

    async def forever():
        await asyncio.sleep(60)

    f = future(forever)
    g = f.recover(lambda exc: type(exc).__name__)
    time.sleep(0.05)
    f.cancel()
    assert value(g) == "FutureCancelledError"


def test_retry_continuation_single_slot(tmp_path):
    """retry's re-attempt runs as a continuation and creates an eager
    future inline: it completes at workers=1."""
    rc.plan("threads", workers=1)
    marker = str(tmp_path / "attempted")

    def flaky():
        import os as _os
        if not _os.path.exists(marker):
            open(marker, "w").close()
            raise ValueError("first attempt fails")
        return "ok"

    assert rc.retry(flaky, times=3, on=Exception) == "ok"


def test_retry_inside_worker_single_slot_completes(tmp_path):
    """retry() inside a worker that holds the only global slot runs its
    re-attempts under the caller's nested plan."""
    rc.plan("threads", workers=1)
    marker = str(tmp_path / "first-attempt")

    def body(_marker=marker):
        def flaky():
            import os as _os
            if not _os.path.exists(_marker):
                open(_marker, "w").close()
                raise ValueError("first attempt fails")
            return "ok"
        return rc.retry(flaky, times=3, on=ValueError)

    assert value(future(body)) == "ok"


def test_retry_future_backoff_and_give_up(tmp_path):
    """Evaluation errors outside ``on`` propagate at once; matching ones
    are retried ``times`` times, then the last error propagates."""
    rc.plan("threads", workers=2)
    calls = _Calls()

    def always_fails(_c=calls):
        _c.n += 1
        raise rc.FutureError("down")

    with pytest.raises(rc.FutureError, match="down"):
        rc.retry(always_fails, times=3, backoff_s=0.01)
    assert calls.n == 3
    with pytest.raises(ZeroDivisionError):
        rc.retry(lambda: 1 / 0, times=3)
    with pytest.raises(ValueError):
        rc.retry(lambda: 1, times=0)


class _Calls:
    def __init__(self):
        self.n = 0


def test_future_either_first_wins():
    """future_either returns the first thunk to finish (no wall-clock
    bound: the slow thunk is only slower)."""
    rc.plan("threads", workers=2)
    release = threading.Event()
    got = rc.future_either(lambda: release.wait(10) and "slow",
                           lambda: "fast")
    release.set()
    assert got == "fast"
    with pytest.raises(ValueError):
        rc.future_either()


def test_continuation_pool_grace_expiry_race():
    """A continuation enqueued exactly as the pool's only idle worker
    times out must still run."""
    from repro_torch.core.future import _ContinuationPool
    pool = _ContinuationPool()
    pool._IDLE_GRACE_S = 0.01
    done = []
    lock = threading.Lock()
    n = 200
    for i in range(n):
        pool.submit(lambda i=i: (lock.acquire(), done.append(i),
                                 lock.release()))
        time.sleep(0.01)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with lock:
            if len(done) == n:
                break
        time.sleep(0.01)
    assert len(done) == n, f"{n - len(done)} continuations stranded"
