"""The port's cooperative (asyncio) frontend and its ``cuda_async`` backend:
a mirror of tests/test_async.py — ``await f``, ``async for`` over
completions, the event-loop backend, the completion-kernel fixes (thread
reuse, waiter tombstones, resolve timeout, abandonment cleanup) — with the
reference's S4 race (``jax_async``'s callbacks under racing registrations)
run on ``cuda_async``.

Here there is no card, so ``cuda_async``'s CUDA event is replaced through
its one seam, ``cuda_async._new_event``, by a stand-in whose ``query()``
stays False until a ``threading.Event`` is set: the watcher thread, the
"fired" sentinel and the races run as they do on the card. A device-side
error (a failed device assert) poisons the CUDA context of the whole
process, so no test provokes one, here or on the card.

pytest-asyncio is deliberately not a dependency: every test is a sync
function driving its coroutine with ``asyncio.run``.
"""

import asyncio
import gc
import random
import threading
import time
import weakref

import pytest
import torch
from _torch_parity import _reset_port  # noqa: F401

import repro_torch.core as rc
from repro_torch.core import (FutureCancelledError, Waiter, as_completed,
                              as_completed_async, future, resolve, stream,
                              value)
from repro_torch.core.backends import cuda_async
from repro_torch.core.planning import active_backend

pytestmark = pytest.mark.asyncio


@pytest.fixture
def aio_backend():
    rc.plan("asyncio")
    yield active_backend()
    rc.shutdown()


@pytest.fixture
def threads_backend():
    rc.plan("threads", workers=4)
    yield active_backend()
    rc.shutdown()


class _StandInEvent:
    """A CUDA event's two calls, done when ``done`` is set."""

    def __init__(self):
        self.done = threading.Event()

    def query(self) -> bool:
        return self.done.is_set()

    def synchronize(self) -> None:
        self.done.wait()


@pytest.fixture
def standin_events(monkeypatch):
    """``plan("cuda_async", device="cpu")`` with every submit recording a
    stand-in event; yields the list of events made, in submit order."""
    made = []

    def new_event(device):
        made.append(_StandInEvent())
        return made[-1]

    monkeypatch.setattr(cuda_async, "_new_event", new_event)
    rc.plan("cuda_async", device="cpu")
    yield made
    for ev in made:
        ev.done.set()
    rc.shutdown()


# --------------------------------------------------------------------------
# await f — works on every backend, not just plan("asyncio")
# --------------------------------------------------------------------------

def test_await_returns_value_on_thread_backend(threads_backend):
    async def main():
        f = future(lambda: time.sleep(0.05) or 21)
        return await f
    assert asyncio.run(main()) == 21


def test_await_reraises_error_every_await(threads_backend):
    async def main():
        f = future(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            await f
        with pytest.raises(ZeroDivisionError):
            await f                      # errors re-raise on every await
    asyncio.run(main())


def test_await_relays_stdout_and_value(aio_backend, capsys):
    async def body():
        print("before-sleep")
        await asyncio.sleep(0.01)
        print("after-sleep")
        return 7

    async def main():
        return await future(body)

    assert asyncio.run(main()) == 7
    out = capsys.readouterr().out
    assert out.index("before-sleep") < out.index("after-sleep")


def test_await_already_resolved_future(threads_backend):
    f = future(lambda: 5)
    assert value(f) == 5

    async def main():
        return await f
    assert asyncio.run(main()) == 5


def test_await_on_cuda_async_resolves_when_the_event_does(standin_events):
    async def main():
        f = future(lambda: 6 * 7)
        threading.Timer(0.05, standin_events[0].done.set).start()
        return await f
    assert asyncio.run(main()) == 42


# --------------------------------------------------------------------------
# plan("asyncio"): async bodies share one loop, no thread parked per future
# --------------------------------------------------------------------------

def test_async_bodies_run_concurrently(aio_backend):
    async def body(i):
        await asyncio.sleep(0.2)
        return i

    async def main():
        fs = [future(body, i) for i in range(20)]
        return [await f for f in fs]

    t0 = time.monotonic()
    assert asyncio.run(main()) == list(range(20))
    # 20 x 0.2 s of sleep overlapped on one loop: far below the 4 s serial
    # wall (the bound leaves room for a loaded host)
    assert time.monotonic() - t0 < 3.0


def test_no_thread_per_inflight_future(aio_backend):
    async def body():
        await asyncio.sleep(0.3)
        return 1

    async def main():
        fs = [future(body) for _ in range(500)]
        peak = threading.active_count()
        vals = [await f for f in fs]
        return peak, vals

    # counted from this test's start: earlier tests in the same worker
    # process may leave idle daemon threads behind
    before = threading.active_count()
    peak, vals = asyncio.run(main())
    assert vals == [1] * 500
    assert peak - before < 20            # nothing like a thread per future


def test_sync_bodies_work_on_asyncio_backend(aio_backend):
    fs = [future(lambda i=i: i * i) for i in range(8)]
    assert value(fs) == [i * i for i in range(8)]


def test_cancel_runs_async_finally_and_raises(aio_backend):
    cleaned = threading.Event()

    async def body():
        try:
            await asyncio.sleep(30)
        finally:
            cleaned.set()

    f = future(body)
    time.sleep(0.1)                      # let the body reach its await
    f.cancel()
    with pytest.raises(FutureCancelledError):
        value(f)
    assert cleaned.is_set()


def test_blocking_value_on_loop_thread_raises(aio_backend):
    async def slow():
        await asyncio.sleep(30)

    f_slow = future(slow)

    def bad_body():
        return f_slow.value()            # blocking wait on the loop thread

    f = future(bad_body)
    with pytest.raises(RuntimeError, match="deadlock"):
        value(f)
    f_slow.cancel()


def test_plan_swap_shuts_the_loop_thread_down():
    """plan() away from asyncio stops its loop thread (the port keeps no
    warm pool)."""
    rc.plan("asyncio")
    be = active_backend()
    assert value(future(lambda: 1)) == 1
    assert be._thread.is_alive()
    rc.plan("threads", workers=1)
    assert not be._thread.is_alive()


# --------------------------------------------------------------------------
# as_completed_async / AsyncWaiter
# --------------------------------------------------------------------------

def test_as_completed_async_yields_in_completion_order(threads_backend):
    async def main():
        slow = future(lambda: time.sleep(0.3) or "slow")
        fast = future(lambda: "fast")
        order = []
        async for f in as_completed_async([slow, fast]):
            order.append(await f)
        return order
    assert asyncio.run(main()) == ["fast", "slow"]


def test_as_completed_async_timeout(threads_backend):
    async def main():
        f = future(lambda: time.sleep(5))
        with pytest.raises(TimeoutError):
            async for _ in as_completed_async([f], timeout=0.1):
                pass
        f.cancel()
    asyncio.run(main())


def test_as_completed_async_on_asyncio_backend(aio_backend):
    async def body(i):
        await asyncio.sleep(0.01 * (5 - i))
        return i

    async def main():
        fs = [future(body, i) for i in range(5)]
        return [await f async for f in as_completed_async(fs)]

    assert asyncio.run(main()) == [4, 3, 2, 1, 0]


# --------------------------------------------------------------------------
# stream async terminals
# --------------------------------------------------------------------------

def test_stream_collect_async(aio_backend):
    async def main():
        return await (stream(iter(range(10)))
                      .filter(lambda v: v % 2 == 0)
                      .map(lambda v: v * 10)
                      .collect_async())
    assert asyncio.run(main()) == [0, 20, 40, 60, 80]


def test_stream_async_map_fn(aio_backend):
    async def double(v):
        await asyncio.sleep(0.01)
        return v * 2

    async def main():
        return await stream(iter(range(6))).map(double, chunk=2).collect_async()
    assert asyncio.run(main()) == [0, 2, 4, 6, 8, 10]


def test_stream_as_completed_async_unordered(aio_backend):
    async def jitter(v):
        await asyncio.sleep(0.005 * (v % 3))
        return v

    async def main():
        got = []
        async for v in stream(iter(range(12))).map(jitter).as_completed_async():
            got.append(v)
        return got

    assert sorted(asyncio.run(main())) == list(range(12))


def test_stream_async_terminal_on_thread_backend(threads_backend):
    async def main():
        return await stream(iter(range(8))).map(lambda v: v + 100).collect_async()
    assert asyncio.run(main()) == list(range(100, 108))


def test_stream_async_abandonment_releases_slots(aio_backend):
    cap = active_backend().workers

    async def slow(v):
        await asyncio.sleep(0.5)
        return v

    async def main():
        agen = stream(iter(range(40))).map(slow).as_completed_async()
        async for _ in agen:
            break                        # abandon with ~39 futures in flight
        await agen.aclose()
        deadline = time.monotonic() + 5
        be = active_backend()
        while be.free_slots() != cap and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        return be.free_slots()

    assert asyncio.run(main()) == cap


# --------------------------------------------------------------------------
# S5: generator abandonment must not leak callbacks or pin futures
# --------------------------------------------------------------------------

def test_abandoned_as_completed_does_not_pin_futures(threads_backend):
    fs = [future(lambda i=i: time.sleep(0.02) or i) for i in range(6)]
    refs = [weakref.ref(f) for f in fs]
    gen = as_completed(fs)
    next(gen)
    gen.close()
    resolve(fs)
    del gen, fs
    gc.collect()
    assert all(r() is None for r in refs)


def test_abandoned_as_completed_async_does_not_pin_futures(threads_backend):
    refs = []

    async def main():
        fs = [future(lambda i=i: time.sleep(0.02) or i) for i in range(6)]
        refs.extend(weakref.ref(f) for f in fs)
        agen = as_completed_async(fs)
        await agen.__anext__()
        await agen.aclose()
        resolve(fs)

    asyncio.run(main())
    gc.collect()
    assert all(r() is None for r in refs)


# --------------------------------------------------------------------------
# S1: thread backend reuses idle workers
# --------------------------------------------------------------------------

def test_thread_backend_reuses_idle_worker(threads_backend):
    be = threads_backend
    idents = []
    for _ in range(5):
        idents.append(value(future(threading.get_ident)))
        deadline = time.monotonic() + 2
        while be._idle < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert be._idle >= 1
    assert len(set(idents)) == 1


def test_thread_backend_concurrency_unchanged(threads_backend):
    t0 = time.monotonic()
    fs = [future(lambda: time.sleep(0.2) or 1) for _ in range(4)]
    assert value(fs) == [1] * 4
    assert time.monotonic() - t0 < 0.8   # 4 bodies overlapped on 4 workers


# --------------------------------------------------------------------------
# S2: Waiter.add() after delivery is a no-op (tombstones)
# --------------------------------------------------------------------------

def test_waiter_readd_after_delivery_is_noop(threads_backend):
    f = future(lambda: 3)
    w = Waiter([f])
    got = w.wait(timeout=5)
    assert got == [f]
    w.add(f)
    assert w.wait(timeout=0.2) == []


def test_waiter_tombstones_do_not_pin(threads_backend):
    f = future(lambda: 3)
    ref = weakref.ref(f)
    w = Waiter([f])
    assert w.wait(timeout=5) == [f]
    del f
    gc.collect()
    assert ref() is None
    assert len(w) == 0


# --------------------------------------------------------------------------
# S3: resolve(timeout=) raises instead of returning indistinguishably
# --------------------------------------------------------------------------

def test_resolve_timeout_raises_and_future_stays_valid(threads_backend):
    f = future(lambda: time.sleep(0.3) or 9)
    with pytest.raises(TimeoutError):
        resolve([f], timeout=0.05)
    assert value(f) == 9


# --------------------------------------------------------------------------
# S4: cuda_async add_done_callback under registration/completion races
# --------------------------------------------------------------------------

def test_cuda_async_callback_exactly_once_under_races(standin_events):
    """Four threads register callbacks while a fifth completes the event:
    each callback fires exactly once, whichever path (fast path, watcher)
    it takes, in all 30 rounds."""
    be = active_backend()
    rnd = random.Random(0)
    for r in range(30):
        f = future(lambda: torch.arange(16).sum())
        ev = standin_events[-1]
        fired = []
        lock = threading.Lock()

        def register(k, _f=f, _fired=fired, _lock=lock):
            def cb(_h, _k=k):
                with _lock:
                    _fired.append(_k)
            be.add_done_callback(_f._handle, cb)

        delay = rnd.choice([0.0, 0.0005, 0.002])
        ts = [threading.Thread(target=register, args=(k,))
              for k in range(4)]
        ts.append(threading.Timer(delay, ev.done.set))
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with lock:
                if len(fired) >= 4:
                    break
            time.sleep(0.001)
        time.sleep(0.002)                # a second delivery would land now
        with lock:
            assert sorted(fired) == [0, 1, 2, 3], r   # each exactly once
        assert int(value(f)) == 120


def test_cuda_async_resolves_when_its_event_does(standin_events):
    """The body runs at submit (Python errors captured then); the future
    is resolved when its event is: ``poll`` is ``query()``, ``collect``
    is ``synchronize()``, a timed wait is bounded."""
    ran = threading.Event()
    f = future(lambda: ran.set() or "done")
    assert ran.is_set()                  # dispatched on the caller's thread
    assert rc.resolved(f) is False
    be = active_backend()
    t0 = time.monotonic()
    assert be.wait([f._handle], timeout=0.05) == []
    assert time.monotonic() - t0 < 1.0
    with pytest.raises(TimeoutError):
        f.value(timeout=0.05)
    threading.Timer(0.05, standin_events[0].done.set).start()
    assert value(f) == "done"
    assert rc.resolved(f) is True
    # an evaluation error records no event: resolved at once, relayed as-is
    bad = future(lambda: 1 / 0)
    assert len(standin_events) == 1 and rc.resolved(bad)
    with pytest.raises(ZeroDivisionError):
        value(bad)


def test_cuda_async_gather_and_map_fire_through_the_watcher(standin_events):
    fs = [future(lambda i=i: i * 3) for i in range(4)]
    g = rc.gather(fs).map(sum)
    assert not rc.resolved(g)
    for ev in standin_events:
        ev.done.set()
    assert value(g) == 18


def test_cuda_async_synchronous_on_cpu():
    rc.plan("cuda_async", device="cpu")
    be = active_backend()
    assert be.device == torch.device("cpu") and be.free_slots() == 1
    f = future(lambda: torch.ones(3) * 2)
    assert rc.resolved(f) and f._handle.event is None
    hits = []
    be.add_done_callback(f._handle, lambda h: hits.append(1))
    assert hits == [1]                   # already resolved: fires inline
    torch.testing.assert_close(value(f), torch.full((3,), 2.0))


def test_cuda_async_plan_raises_without_a_card(monkeypatch):
    """No quiet fall back to the CPU: only ``device="cpu"`` plans it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rc.plan("cuda_async")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rc.plan("cuda_async", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_async.CudaAsyncBackend()
    rc.plan("cuda_async", device="cpu")
    assert value(future(lambda: 5)) == 5
