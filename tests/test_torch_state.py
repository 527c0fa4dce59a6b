"""The port's shared-state service (``repro_torch.core.state``): a mirror of
tests/test_state.py with ``plan("threads", workers=N)`` in place of the
cluster — exact folds under contention, CAS races, watch fan-out — an op
script held against the JAX package's ``StateService``, and the in-process
contract that a reader gets the live object.

The reference's SIGKILL-mid-update row needs worker processes and waits
for the port's out-of-process backends. In process, ``wait`` parks on the
service's condition variable (the watch list serves ``wait_async``), so
the tests synchronise on the service's ``waits`` counter.
"""

import asyncio
import threading
import time

import pytest
import torch
from _torch_parity import _reset_port, backend  # noqa: F401

import repro_torch.core as rc
from repro_torch.core import future, gather, state, value

pytestmark = pytest.mark.state


def _poll(pred, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise TimeoutError(f"{what} not reached within {timeout}s")


# --------------------------------------------------------------------------
# exact folds from concurrent workers
# --------------------------------------------------------------------------

def test_eight_workers_exact_fold():
    """state.update from 8 concurrent workers yields the exact sequential
    fold: final value == total updates == final version."""
    rc.plan("threads", workers=8)
    per_task = 4

    def body():
        for _ in range(per_task):
            state.update("acc8", lambda v: (v or 0) + 1)
        return True

    fs = [future(body) for _ in range(8)]
    assert value(gather(fs)) == [True] * 8
    assert state.get("acc8") == 8 * per_task
    assert state.version("acc8") == 8 * per_task


def test_cas_loses_exactly_the_races_it_should():
    """Raw version-read + cas loops from 4 workers: every commit bumps the
    version exactly once, and every refused cas was a genuine race."""
    rc.plan("threads", workers=4)

    def body(i):
        wins, attempts = 0, 0
        for _ in range(6):
            while True:
                ver = state.version("cas.k")
                attempts += 1
                ok, newver, _cur = state.cas("cas.k", ver, i)
                if ok:
                    assert newver == ver + 1       # never a torn version
                    wins += 1
                    break
        return wins, attempts

    got = value(gather([future(lambda i=i: body(i)) for i in range(4)]))
    total_wins = sum(w for w, _ in got)
    total_attempts = sum(a for _, a in got)
    assert total_wins == 4 * 6
    assert state.version("cas.k") == total_wins
    assert total_attempts >= total_wins


def test_update_history_is_one_fold_per_update():
    """In process ``update`` folds under the service lock, so ``fn`` runs
    once per update and the client counts no CAS retry."""
    rc.plan("threads", workers=4)

    def body():
        for _ in range(8):
            state.update("rerun.acc", lambda v: (v or 0) + 1)
        return state.stats()["cas_retries"]

    retries = value(gather([future(body) for _ in range(4)]))
    assert state.get("rerun.acc") == 32
    assert state.version("rerun.acc") == 32
    assert retries == [0] * 4


# --------------------------------------------------------------------------
# Watch fan-out
# --------------------------------------------------------------------------

def test_wait_fanout_one_put_releases_all_waiters():
    rc.plan("threads", workers=4)

    def waiter():
        val, ver = state.wait("fan.k", 1, timeout=30)
        return (val, ver)

    ws = [future(waiter) for _ in range(3)]
    svc = state.service()
    _poll(lambda: svc.stats()["waits"] >= 3, what="3 parked waiters")
    state.put("fan.k", "fire")
    assert value(gather(ws)) == [("fire", 1)] * 3


def test_wait_min_version_skips_stale_values():
    rc.plan("threads", workers=2)
    state.put("mv.k", "old")                   # version 1

    def waiter():
        return state.wait("mv.k", 2, timeout=30)

    w = future(waiter)
    svc = state.service()
    _poll(lambda: svc.stats()["waits"] >= 1, what="parked waiter")
    state.put("mv.k", "new")                   # version 2
    assert value(w) == ("new", 2)


# --------------------------------------------------------------------------
# Server-side fold ops
# --------------------------------------------------------------------------

def test_add_exact_under_eight_way_contention():
    rc.plan("threads", workers=8)
    per_task = 25

    def body():
        for _ in range(per_task):
            state.add("fold.add", 1)
        return True

    fs = [future(body) for _ in range(8)]
    assert value(gather(fs)) == [True] * 8
    assert state.get("fold.add") == 8 * per_task
    assert state.version("fold.add") == 8 * per_task


def test_extend_exact_under_eight_way_contention():
    rc.plan("threads", workers=8)
    per_task = 10

    def body(wid):
        for i in range(per_task):
            state.extend("fold.list", [(wid, i)])
        return True

    fs = [future(lambda w=w: body(w)) for w in range(8)]
    assert value(gather(fs)) == [True] * 8
    got = state.get("fold.list")
    assert sorted(got) == sorted(
        (w, i) for w in range(8) for i in range(per_task))
    assert state.version("fold.list") == 8 * per_task


def test_add_default_and_return_value():
    assert state.add("acc.f", 2.5, default=10.0) == (12.5, 1)
    assert state.add("acc.f", -0.5) == (12.0, 2)
    n, ver = state.extend("acc.l", ["a", "b"])
    assert (n, ver) == (2, 1)
    n, ver = state.extend("acc.l", ["c"])
    assert (n, ver) == (3, 2)
    assert state.get("acc.l") == ["a", "b", "c"]


def test_wait_async_wakes_without_thread_per_waiter():
    async def main():
        fut = asyncio.ensure_future(
            state.wait_async("aw.k", 1, timeout=30))
        await asyncio.sleep(0.05)          # parked, not polling
        threading.Timer(0.05, lambda: state.put("aw.k", "go")).start()
        val, ver = await fut
        assert (val, ver) == ("go", 1)
        with pytest.raises(state.StateTimeout):
            await state.wait_async("aw.k", 99, timeout=0.1)

    asyncio.run(main())


# --------------------------------------------------------------------------
# the in-process contract: readers get the live object
# --------------------------------------------------------------------------

def test_get_returns_the_live_object_on_every_backend(backend):
    """A dict of tensors put by the driver is the same object in a task
    body: nothing is copied (on the card, no device bytes move)."""
    params = {"w": torch.randn(4, 4), "b": [torch.zeros(4)]}
    state.put("params", params)

    def body():
        got = state.get("params")
        return got is params_ref() and got["w"] is params_ref()["w"]

    params_ref = _Ref(params)
    assert value(future(body)) is True
    assert state.get("params") is params


class _Ref:
    """Calls back to an object by reference (a dict closure would be
    snapshotted at future creation)."""

    def __init__(self, obj):
        self._obj = obj

    def __call__(self):
        return self._obj


# --------------------------------------------------------------------------
# parity with the JAX package's StateService
# --------------------------------------------------------------------------

def _op_script(svc, timeout_error) -> list:
    """One op script over a service; each step records ``(value,
    version)`` as the service reports them."""
    hist = []
    hist.append(("put", svc.put("k", 1), svc.read("k")))
    hist.append(("put", svc.put("k", 2), svc.read("k")))
    hist.append(("cas-win", svc.cas("k", 2, 3), svc.read("k")))
    hist.append(("cas-lose", svc.cas("k", 2, 99), svc.read("k")))
    hist.append(("cas-create", svc.cas("new", 0, "n"), svc.read("new")))
    hist.append(("update", svc.update("k", lambda v: v * 10), svc.read("k")))
    hist.append(("update-default",
                 svc.update("u", lambda v: (v or 0) + 5), svc.read("u")))
    hist.append(("add", svc.add("c", 4, default=1), svc.read("c")))
    hist.append(("add", svc.add("c", -2), svc.read("c")))
    hist.append(("extend", svc.extend("l", [1, 2]), svc.read("l")))
    hist.append(("extend", svc.extend("l", [3]), svc.read("l")))
    hist.append(("delete", svc.delete("k"), svc.read("k", None),
                 svc.version("k")))
    hist.append(("delete-absent", svc.delete("nope")))
    hist.append(("re-put", svc.put("k", "back"), svc.read("k")))
    hist.append(("wait-ready", svc.wait("k", 5, timeout=0.1)))
    try:
        svc.wait("k", 7, timeout=0.05)
        hist.append(("wait-timeout", "no-error"))
    except timeout_error:
        hist.append(("wait-timeout", "StateTimeout", svc.version("k")))
    hist.append(("keys", svc.keys(), svc.keys("l")))
    hist.append(("stats", svc.stats()))
    return hist


def test_state_op_script_matches_the_jax_package():
    from repro.core import state as ref_state
    got = _op_script(state.StateService(), state.StateTimeout)
    want = _op_script(ref_state.StateService(), ref_state.StateTimeout)
    assert got == want
    assert ("wait-timeout", "StateTimeout", 5) in got
