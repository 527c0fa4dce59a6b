"""The port's in-process Future core (``repro_torch.core``): a mirror of
tests/test_future_core.py, the threads rows of tests/test_continuations.py,
and the RNG contract with counter-based keys."""

import pickle
import threading
import time
import warnings

import numpy as np
import pytest
import torch
from _torch_parity import _reset_port  # noqa: F401

import repro_torch.core as rc
from repro_torch.core import (Future, Waiter, first, future, gather, merge,
                              resolved, value)
from repro_torch.core import rng as rng_mod
from repro_torch.core.backends.base import (BACKEND_REGISTRY, Backend,
                                            CompletionHandle)


# --------------------------------------------------------------------------
# the three constructs (mirror of tests/test_future_core.py)
# --------------------------------------------------------------------------

def test_value_of_simple_future():
    f = future(lambda: 21 * 2)
    assert value(f) == 42
    assert resolved(f) is True


def test_snapshot_at_creation_globals():
    global _snap_x
    _snap_x = 1
    f = future(lambda: _snap_x * 10)
    _snap_x = 2
    assert value(f) == 10


def test_snapshot_at_creation_closure():
    x = 1
    f = future(lambda: x * 10)
    x = 2  # noqa: F841 — rebinding must not affect the future
    assert value(f) == 10


def test_snapshot_copies_mutable_containers():
    xs = [1, 2, 3]
    f = future(lambda: sum(xs))
    xs.append(100)
    assert value(f) == 6


def test_error_relayed_as_is_and_on_every_value():
    f = future(lambda: [0][3])
    with pytest.raises(IndexError):
        value(f)
    with pytest.raises(IndexError):
        value(f)


def test_stdout_router_outlives_its_release():
    """CPython 3.12's print() holds sys.stdout by a borrowed reference
    across its writes, so a router that a worker thread releases while the
    main thread prints must not be freed under the print: routers are kept
    and reused, and the real stream is restored."""
    import gc
    import sys
    import weakref

    from repro_torch.core import conditions
    real = sys.stdout
    router = conditions._acquire_router()
    assert sys.stdout is router and router.real is real
    ref = weakref.ref(router)
    conditions._release_router(router)
    del router
    gc.collect()
    assert sys.stdout is real and ref() is not None
    again = conditions._acquire_router()
    assert again is ref()
    conditions._release_router(again)
    assert sys.stdout is real


def test_stdout_and_warning_relay_order(capsys):
    def body():
        print("line-1")
        warnings.warn("warn-1")
        print("line-2")
        return 5

    f = future(body)
    with warnings.catch_warnings(record=True) as wlist:
        warnings.simplefilter("always")
        assert value(f) == 5
    out = capsys.readouterr().out
    assert out.index("line-1") < out.index("line-2")
    assert [str(w.message) for w in wlist] == ["warn-1"]
    value(f)
    assert "line-1" not in capsys.readouterr().out


def test_resolved_is_nonblocking():
    rc.plan("threads", workers=1)
    f = future(lambda: (time.sleep(0.3), "done")[1])
    t0 = time.time()
    r = resolved(f)
    assert time.time() - t0 < 0.2
    assert r is False
    assert value(f) == "done"


def test_creation_blocks_when_no_worker_free():
    rc.plan("threads", workers=1)
    future(lambda: time.sleep(0.25))
    t0 = time.time()
    f2 = future(lambda: "second")
    assert time.time() - t0 >= 0.2
    assert value(f2) == "second"


def test_lazy_future_defers_until_touched():
    trace = []
    f = future(lambda: trace.append("ran") or 1, lazy=True)
    time.sleep(0.05)
    assert trace == []
    assert value(f) == 1


def test_merge_of_lazy_futures():
    fs = [future(lambda i=i: i * i, lazy=True) for i in range(5)]
    m1 = merge(fs[:3])
    m2 = merge(fs[3:])
    assert value(m1) == [0, 1, 4]
    assert value([m1, m2]) == [0, 1, 4, 9, 16]


def test_merge_rejects_launched_futures():
    f = future(lambda: 1)
    with pytest.raises(rc.GlobalsError):
        merge([f])


def test_value_generic_containers():
    fs = {"a": future(lambda: 1), "b": [future(lambda: 2), 3]}
    assert value(fs) == {"a": 1, "b": [2, 3]}


def test_explicit_globals_argument():
    def body():
        return globals()["k"]
    f = future(body, globals={"k": 42})
    assert value(f) == 42


def test_listenv_promise_container():
    env = rc.ListEnv()
    for i in range(4):
        env[i] = future(lambda i=i: i + 100)
    assert env.as_list() == [100, 101, 102, 103]


def test_cancel_unlaunched():
    rc.plan("threads", workers=1)
    blocker = future(lambda: time.sleep(0.3))
    f = future(lambda: "x", lazy=True)
    assert f.cancel() is False
    value(blocker)


def test_only_in_process_backends_are_registered():
    assert sorted(BACKEND_REGISTRY) == ["asyncio", "cuda_async",
                                        "sequential", "threads"]
    with pytest.raises(ValueError, match="unknown backend"):
        rc.plan("cluster")


def test_public_names_are_the_references_but_the_out_of_process_ones():
    """``__all__`` is the JAX package's, less the launchers and the errors
    of the out-of-process backends (a later slice of the port)."""
    import repro.core as ref_core
    later = {"Launcher", "LocalLauncher", "SSHLauncher", "CommandLauncher",
             "WorkerProc", "WorkerDiedError", "ChannelError",
             "LineageExhaustedError", "NonExportableObjectError"}
    assert sorted(rc.__all__) == sorted(set(ref_core.__all__) - later)
    assert all(hasattr(rc, name) for name in rc.__all__)


def test_snapshot_keeps_tensors_in_containers_by_reference():
    """A captured dict is copied, its tensors are not: a dict of CUDA
    parameters must not be cloned on the card at every future."""
    params = {"w": torch.ones(3), "layers": [torch.zeros(2), 5]}
    f = future(lambda: (params["w"], params["layers"][0], params))
    params["layers"].append("later")
    w, z, snap = value(f)
    assert w is params["w"] and z is params["layers"][0]
    assert snap is not params and snap["layers"] == [z, 5]
    loop = [torch.ones(1)]
    loop.append(loop)                    # a container that holds itself
    got = value(future(lambda: loop))
    assert got is not loop and got[1] is got and got[0] is loop[0]


# --------------------------------------------------------------------------
# continuation kernel, threads rows (mirror of tests/test_continuations.py)
# --------------------------------------------------------------------------

def test_callback_fires_exactly_once_per_registration():
    rc.plan("threads", workers=2)
    f = future(lambda: time.sleep(0.05) or 1)
    hits = []
    ev = threading.Event()
    b = rc.active_backend()
    b.add_done_callback(f._handle, lambda h: hits.append("a"))
    b.add_done_callback(f._handle, lambda h: (hits.append("b"), ev.set()))
    assert ev.wait(5)
    time.sleep(0.05)
    assert sorted(hits) == ["a", "b"]


def test_callback_on_resolved_handle_fires_inline():
    rc.plan("threads", workers=2)
    f = future(lambda: 1)
    assert value(f) == 1
    hits = []
    rc.active_backend().add_done_callback(f._handle, lambda h: hits.append(1))
    assert hits == [1]


def test_callback_fires_on_error():
    rc.plan("threads", workers=2)
    boom = future(lambda: 1 / 0)
    ev = threading.Event()
    rc.active_backend().add_done_callback(boom._handle, lambda h: ev.set())
    assert ev.wait(5)


def test_waiter_delivers_each_future_once_and_accepts_adds():
    rc.plan("threads", workers=2)
    fs = [future(lambda i=i: time.sleep(0.02 * i) or i) for i in range(3)]
    waiter = Waiter(fs)
    seen = []
    while len(seen) < 3:
        got = waiter.wait(timeout=5)
        assert got
        seen.extend(got)
    waiter.add(future(lambda: 99))
    seen.extend(waiter.wait(timeout=5))
    assert sorted(value(f) for f in seen) == [0, 1, 2, 99]
    assert len(set(id(f) for f in seen)) == 4


def test_waiter_timeout_returns_empty():
    rc.plan("threads", workers=2)
    f = future(lambda: time.sleep(1.0))
    waiter = Waiter([f])
    t0 = time.monotonic()
    assert waiter.wait(timeout=0.1) == []
    assert time.monotonic() - t0 < 1.0
    f.cancel()


def test_gather_spans_backends():
    tb = BACKEND_REGISTRY["threads"](workers=1)
    sb = BACKEND_REGISTRY["sequential"]()
    try:
        g = gather([future(lambda: "t", backend=tb),
                    future(lambda: "s", backend=sb)])
        assert value(g) == ["t", "s"]
    finally:
        tb.shutdown()


def test_first_cancel_attempted_on_threads_losers():
    rc.plan("threads", workers=2)
    started = threading.Event()
    slow = future(lambda: started.set() or time.sleep(0.3) or "loser")
    assert started.wait(5)
    fast = future(lambda: "winner")
    assert value(first([fast, slow])) == "winner"
    assert value(slow) == "loser"


def test_fallback_future_and_thunk():
    rc.plan("threads", workers=2)
    alt = future(lambda: "alt")
    assert value(future(lambda: 1 / 0).fallback(alt)) == "alt"
    assert value(future(lambda: 1 / 0).fallback(lambda: "thunk")) == "thunk"
    assert value(future(lambda: "ok").fallback(lambda: "unused")) == "ok"


def test_fallback_relays_failed_parent_capture(capsys):
    f = future(lambda: print("pre-crash") or 1 / 0)
    assert value(f.fallback(lambda: print("from-alt") or 2)) == 2
    out = capsys.readouterr().out
    assert out.index("pre-crash") < out.index("from-alt")


def test_recover_sees_evaluation_errors():
    rc.plan("threads", workers=2)
    f = future(lambda: 1 / 0).recover(lambda exc: type(exc).__name__)
    assert value(f) == "ZeroDivisionError"


def test_cancel_derived_future():
    rc.plan("threads", workers=2)
    f = future(lambda: time.sleep(1.0)).map(lambda v: "never")
    assert f.cancel() is True
    with pytest.raises(rc.FutureCancelledError):
        value(f)


def test_then_on_lazy_future_launches_it():
    f = future(lambda: 5, lazy=True)
    g = f.then(lambda v: v * 2)
    assert f.resolved() is True
    assert value(g) == 10


def test_gather_empty():
    assert value(gather([])) == []


def test_deep_chain():
    rc.plan("threads", workers=2)
    f = future(lambda: 0)
    for _ in range(30):
        f = f.map(lambda v: v + 1)
    assert value(f) == 30


def test_continuation_sees_global_plan():
    rc.plan("threads", workers=4)

    def cont(_v):
        from repro_torch.core import active_backend
        inner = future(lambda: 1)
        return (type(active_backend()).__name__, value(inner))

    name, v = value(future(lambda: 0).then(cont))
    assert v == 1
    assert name == "ThreadBackend"


def test_continuation_nested_future_no_deadlock_single_slot():
    rc.plan("threads", workers=1)
    f = future(lambda: 0).then(lambda v: value(future(lambda: 41)) + 1)
    assert value(f) == 42


def test_fire_and_forget_chain_from_inside_worker_completes():
    rc.plan("threads", workers=1)

    def body():
        g = future(lambda: 1)
        return g.then(lambda v: value(future(lambda: v + 1)))

    h = value(future(body))
    assert value(h) == 2


def test_await_future_on_threads():
    import asyncio
    rc.plan("threads", workers=2)

    async def main():
        return await future(lambda: time.sleep(0.05) or 7)

    assert asyncio.run(main()) == 7


class _SlowThirdPartyBackend(Backend):
    """An asynchronous backend that overrides neither wait() nor
    add_done_callback(): it inherits the bounded defaults."""

    name = "slow3p"

    def submit(self, task):
        h = CompletionHandle()

        def _work():
            time.sleep(0.5)
            from repro_torch.core.conditions import capture_run
            h.run = capture_run(lambda: task.fn(*task.args, **task.kwargs))
            h.done.set()

        threading.Thread(target=_work, daemon=True).start()
        return h

    def poll(self, h):
        return h.done.is_set()

    def collect(self, h):
        h.done.wait()
        return h.run


def test_default_wait_honours_timeout_and_callback():
    b = _SlowThirdPartyBackend()
    f = future(lambda: 7, backend=b)
    t0 = time.monotonic()
    assert b.wait([f._handle], timeout=0.1) == []
    assert time.monotonic() - t0 < 0.4
    ev = threading.Event()
    b.add_done_callback(f._handle, lambda h: ev.set())
    assert ev.wait(5)
    assert value(f) == 7


# --------------------------------------------------------------------------
# RNG contract: counter-based SeedSequence keys seeding torch.Generators
# --------------------------------------------------------------------------

def _draws(plan: str) -> list:
    rc.plan(plan, workers=2) if plan == "threads" else rc.plan(plan)
    rc.set_session_seed(123)
    fs = [future(lambda key: rng_mod.normal(key, (4,)), seed=True)
          for _ in range(5)]
    out = [value(f) for f in fs]
    rc.shutdown()
    return out


def test_draws_do_not_depend_on_backend():
    seq, thr = _draws("sequential"), _draws("threads")
    for a, b in zip(seq, thr):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(seq[0], seq[1])       # distinct streams


def test_element_keys_do_not_depend_on_chunking():
    rc.set_session_seed(5)
    whole = [rng_mod.normal(k, (3,)) for k in rng_mod.element_keys(6)]
    parts = [rng_mod.normal(k, (3,)) for k in rng_mod.element_keys(
        2, base_index=0)] + [rng_mod.normal(k, (3,)) for k in
                             rng_mod.element_keys(4, base_index=2)]
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_keys_are_picklable_and_seed_generators():
    rc.set_session_seed(9)
    key = rng_mod.stream_key(3)
    again = pickle.loads(pickle.dumps(key))
    torch.testing.assert_close(rng_mod.normal(key, (5,)),
                               rng_mod.normal(again, (5,)))
    g = rng_mod.generator(key)
    assert isinstance(g, torch.Generator)
    u = rng_mod.uniform(key, (100,), minval=2.0, maxval=3.0)
    assert float(u.min()) >= 2.0 and float(u.max()) < 3.0
    r = rng_mod.randint(key, (50,), 0, 7)
    assert r.dtype == torch.int32 and int(r.max()) < 7


def test_session_seed_changes_draws():
    rc.set_session_seed(1)
    a = value(future(lambda key: rng_mod.normal(key, (4,)), seed=True))
    rc.set_session_seed(2)
    b = value(future(lambda key: rng_mod.normal(key, (4,)), seed=True))
    assert not torch.equal(a, b)


@pytest.mark.parametrize("plan", ["sequential", "threads", "cuda_async",
                                  "asyncio"])
def test_rng_misuse_warning(plan):
    kw = {"threads": {"workers": 2}, "cuda_async": {"device": "cpu"}}
    rc.plan(plan, **kw.get(plan, {}))
    key = rng_mod.stream_key(0)
    with pytest.warns(rc.RNGMisuseWarning):
        value(future(lambda: rng_mod.normal(key, (2,))))
    with warnings.catch_warnings():
        warnings.simplefilter("error", rc.RNGMisuseWarning)
        value(future(lambda key: rng_mod.normal(key, (2,)), seed=True))


def test_future_type_is_the_ports():
    f = future(lambda: np.float32(1.5))
    assert isinstance(f, Future) and value(f) == 1.5
