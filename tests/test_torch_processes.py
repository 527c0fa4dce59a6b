"""The port's ``processes`` backend (the paper's multisession): futures
resolved in spawned worker processes, held to the same contract as the
in-process backends and to the JAX package.

* the conformance rows of tests/test_torch_conformance.py on
  ``plan("processes", workers=2)``, with the blob path of a large state
  value (tests/test_conformance.py:312-437);
* the fault rows of tests/test_faults.py:36-160 (a dying worker,
  self-healing, retry, speculation, resize, cancel), the processes rows of
  tests/test_stream.py and tests/test_mapreduce.py, and the SIGKILL-mid-
  update row of tests/test_state.py on processes;
* worker isolation: another pid, and neither ``jax`` nor ``repro`` in the
  worker's ``sys.modules``;
* the state op script of tests/test_torch_state.py run from a worker over
  the pipe, against the JAX package's ``StateService``;
* the slice: xLSTM prefill futures in workers (smoke size) against the
  port's direct call bit for bit and the JAX package's logits.

Workers start once a pool: each test re-plans ``processes`` and finds the
pool parked warm by the previous one (``planning.py``); the module's end
shuts the pools down. Every wait on a worker has a timeout, so that a hang
fails its test instead of the suite.
"""

import os
import signal
import time
import warnings

import numpy as np
import pytest
import torch

import repro_torch.core as rc
from repro_torch.core import (first, first_successful, future, future_either,
                              future_map, gather, retry, stream)
from repro_torch.core import rng as rng_mod

#: seconds any one wait on a worker may take
WAIT = 60.0
WORKERS = 2


def value(f, timeout: float = WAIT):
    return rc.value(f, timeout=timeout)


@pytest.fixture(autouse=True)
def _reset_port():
    """Plan, seed and state per test, as ``_torch_parity._reset_port``,
    but a worker pool is parked warm between tests, not shut down."""
    rc.plan("sequential")
    rc.set_session_seed(0)
    rc.state.reset()
    yield
    rc.plan("sequential")
    rc.state.reset()


@pytest.fixture(scope="module", autouse=True)
def _release_pools():
    yield
    rc.shutdown()


@pytest.fixture
def backend():
    rc.plan("processes", workers=WORKERS)
    yield "processes"
    rc.plan("sequential")


pool = backend


def _poll(pred, timeout=WAIT, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise TimeoutError(f"{what} not reached within {timeout}s")


# --------------------------------------------------------------------------
# conformance rows
# --------------------------------------------------------------------------

def test_same_value(backend):
    x = 11
    assert value(future(lambda: x * 3)) == 33


def test_value_timeout(backend):
    f = future(lambda: time.sleep(0.5) or 7)
    with pytest.raises(TimeoutError):
        f.value(timeout=0.05)
    assert f.value(timeout=WAIT) == 7
    assert value(f) == 7


def test_snapshot_semantics(backend):
    x = 1
    f = future(lambda: x + 100)
    x = 2  # noqa: F841
    assert value(f) == 101


def test_exception_relayed_as_is(backend):
    with pytest.raises(ValueError):
        value(future(lambda: int("not-a-number")))


def test_stdout_relay(backend, capsys):
    assert value(future(lambda: print("from-the-future") or 1)) == 1
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
    rc.set_session_seed(1234)
    f = future(lambda key: float(rng_mod.normal(key, ())), seed=True)
    assert value(f) == float(rng_mod.normal(rng_mod.stream_key(0), ()))


def test_map_matches_sequential(backend):
    xs = list(range(7))
    assert future_map(lambda v: v * v, xs) == [v * v for v in xs]


def test_nested_parallelism_protection(backend):
    def outer():
        from repro_torch.core import active_backend, future, value
        inner = future(lambda: 1)
        return (type(active_backend()).__name__, value(inner))

    assert value(future(outer)) == ("SequentialBackend", 1)


def test_then_map_chain_value(backend):
    f = future(lambda: 10).then(lambda v: v + 1).map(lambda v: v * 2)
    assert value(f) == 22


def test_then_flattens_returned_future(backend):
    f = future(lambda: 3).then(lambda v: future(lambda: v * 7))
    assert value(f) == 21


def test_chain_propagates_parent_error(backend):
    trace = []
    f = future(lambda: int("nope")).then(lambda v: trace.append(v))
    for _ in range(2):                   # errors re-raised at every value()
        with pytest.raises(ValueError):
            value(f)
    assert trace == []


def test_chain_raises_continuation_error(backend):
    with pytest.raises(IndexError):
        value(future(lambda: 1).map(lambda v: [0][3]))


def test_chain_relays_whole_chain_stdout(backend, capsys):
    f = future(lambda: print("from-parent") or 2)
    g = f.map(lambda v: print("from-map") or v * 2)
    assert value(g) == 4
    out = capsys.readouterr().out
    assert out.index("from-parent") < out.index("from-map")


def test_recover_handles_error_and_passes_value(backend):
    bad = future(lambda: 1 / 0).recover(lambda exc: type(exc).__name__)
    assert value(bad) == "ZeroDivisionError"
    assert value(future(lambda: 5).recover(lambda exc: -1)) == 5


def test_gather_values_and_error_propagation(backend):
    fs = [future(lambda i=i: i * i) for i in range(5)]
    assert value(gather(fs)) == [0, 1, 4, 9, 16]
    with pytest.raises(ValueError):
        value(gather([future(lambda: 1), future(lambda: int("x"))]))


def test_first_returns_earliest_completion(backend):
    fast = future(lambda: "fast")
    slow = future(lambda: time.sleep(0.5) or "slow")
    assert value(first([fast, slow])) == "fast"


def test_first_successful_skips_failures(backend):
    f = first_successful([future(lambda: 1 / 0), future(lambda: "ok")])
    assert value(f) == "ok"


def test_first_successful_all_failures_propagates_first(backend):
    f = first_successful([future(lambda: 1 / 0), future(lambda: [0][3])])
    with pytest.raises(ZeroDivisionError):
        value(f)


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
    rc.set_session_seed(77)
    f = future(lambda: torch.arange(_CHAIN_N, dtype=torch.float64))
    assert value(f.then(lambda a: float(a[0]))) == 0.0
    tail = future(lambda key: float(rng_mod.normal(key, ())), seed=True)
    assert value(tail) == float(rng_mod.normal(rng_mod.stream_key(1), ()))


def test_stream_two_maps_fused_parity(backend):
    s = (rc.stream(iter(range(12)))
         .map(lambda v: v * 2, chunk=3)
         .map(lambda v: float(v) + 0.5))
    assert s.collect(ordered=True) == [v * 2 + 0.5 for v in range(12)]
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


# -- shared state over the pipe ---------------------------------------------

@pytest.mark.state
def test_state_semantics_tuple(backend):
    def body():
        from repro_torch.core import state
        out = [state.put("sem.k", "a"), state.put("sem.k", "b"),
               state.get("sem.k"), state.version("sem.k")]
        ok, ver, _ = state.cas("sem.k", 2, "c")
        out.append((ok, ver))
        out.append(state.cas("sem.k", 2, "zz"))
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
        ok, ver, _cur = state.cas("race.k", 0, i)
        return (ok, ver)

    got = value(gather([future(lambda i=i: body(i)) for i in range(6)]))
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
    def body():
        from repro_torch.core import state
        try:
            state.wait("never.k", 1, timeout=0.1)
        except Exception as exc:                        # noqa: BLE001
            return type(exc).__name__
        return "no-error"

    assert value(future(body)) == "StateTimeout"


@pytest.mark.state
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_state_large_value_rides_the_blob_path(backend, kind):
    """A value above PAYLOAD_REF_THRESHOLD crosses as a content-addressed
    blob, driver to worker and back, bit for bit; a tensor comes back a
    tensor of its dtype."""
    arr = np.arange(1 << 15, dtype=np.float64)          # 256 KiB
    big = arr if kind == "numpy" else torch.from_numpy(arr.copy())
    rc.state.put("big.down", big)

    def body():
        from repro_torch.core import state
        a = state.get("big.down")
        state.put("big.up", a * 2.0)
        return float(a.sum()), tuple(a.shape), type(a).__name__

    got = value(future(body))
    assert got == (float(arr.sum()), arr.shape, type(big).__name__)
    back = rc.state.get("big.up")
    assert type(back) is type(big)
    np.testing.assert_array_equal(np.asarray(back), arr * 2.0)


@pytest.mark.state
def test_state_op_script_over_the_pipe_matches_the_jax_package(backend):
    """The op script of tests/test_torch_state.py, run by a task body in a
    worker (every op a pipe RPC), gives the JAX package's StateService
    replies; only the stats step differs in kind (a client's counters)."""
    from repro.core import state as ref_state
    from test_torch_state import _op_script

    def body():
        from repro_torch.core import state
        return _op_script(state, state.StateTimeout)

    got = value(future(body))
    want = _op_script(ref_state.StateService(), ref_state.StateTimeout)
    assert got[:-1] == want[:-1]
    assert got[-1][0] == "stats" and got[-1][1]["ops"] > 0


# --------------------------------------------------------------------------
# worker isolation
# --------------------------------------------------------------------------

def test_worker_isolation():
    """Workers are other interpreters, and they import neither JAX nor the
    JAX package (this test process has both loaded)."""
    import jax  # noqa: F401
    import repro.core  # noqa: F401
    rc.plan("processes", workers=1)

    def probe():
        import os
        import sys
        return os.getpid(), sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith(("jax.", "jaxlib"))
            or m == "repro" or m.startswith("repro."))

    pid, bad = value(future(probe))
    assert pid != os.getpid()
    assert bad == []


# --------------------------------------------------------------------------
# fault rows (tests/test_faults.py:36-160)
# --------------------------------------------------------------------------

def _die():
    os._exit(23)


def test_worker_death_is_future_error(pool):
    with pytest.raises(rc.WorkerDiedError):
        value(future(_die))


def test_pool_self_heals_after_death(pool):
    with pytest.raises(rc.WorkerDiedError):
        value(future(_die))
    assert future_map(lambda x: x + 1, [1, 2, 3, 4]) == [2, 3, 4, 5]


def test_retry_gives_up_after_n(pool):
    with pytest.raises(rc.WorkerDiedError):
        retry(_die, times=2)


def _flaky(marker):
    def flaky():
        import os as _os
        if not _os.path.exists(marker):
            open(marker, "w").close()
            _os._exit(9)               # first attempt: simulated node failure
        return "recovered"
    return flaky


def test_retry_succeeds_on_flaky(pool, tmp_path):
    assert retry(_flaky(str(tmp_path / "flaky-ran")), times=3) == "recovered"


def test_retry_backoff_never_sleeps_the_caller(pool, tmp_path):
    flaky = _flaky(str(tmp_path / "flaky-ran"))
    assert value(future(lambda: "warm")) == "warm"   # pool spawn != timing
    t0 = time.monotonic()
    rf = rc.retry_future(flaky, times=3, backoff_s=0.4)
    created_in = time.monotonic() - t0
    assert created_in < 0.3, f"creation blocked {created_in:.2f}s"
    assert value(rf) == "recovered"
    assert time.monotonic() - t0 >= 0.4          # the backoff really ran


def test_retry_attempt_creation_failure_resolves_not_hangs(pool,
                                                           monkeypatch):
    import repro_torch.core.mapreduce as mr
    real_future = mr.future
    calls = {"n": 0}

    def flaky_future(fn, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("backend gone between attempts")
        return real_future(fn, **kw)

    monkeypatch.setattr(mr, "future", flaky_future)

    def bad():
        raise ValueError("attempt fails")

    rf = rc.retry_future(bad, times=3, backoff_s=0.05, on=Exception)
    with pytest.raises(RuntimeError, match="backend gone"):
        value(rf)


def test_evaluation_errors_do_not_retry(pool):
    def bad():
        raise ValueError("deterministic bug")

    with pytest.raises(ValueError):
        retry(bad, times=3)


def test_future_either_prefers_fast(pool):
    t0 = time.time()
    v = future_either(lambda: (time.sleep(5.0), "straggler")[1],
                      lambda: (time.sleep(0.05), "healthy")[1])
    assert v == "healthy"
    assert time.time() - t0 < 4.0      # did not wait for the straggler


def test_future_map_retries_dead_chunks(pool, tmp_path):
    marker = str(tmp_path / "chunk-died")

    def elem(x):
        import os as _os
        if x == 3 and not _os.path.exists(marker):
            open(marker, "w").close()
            _os._exit(7)
        return x * 2

    assert future_map(elem, [1, 2, 3, 4], chunks=4, retries=2) \
        == [2, 4, 6, 8]


def test_elastic_resize():
    rc.plan("processes", workers=2, blob_store_bytes=1 << 20)  # own pool
    backend = rc.active_backend()
    try:
        backend.resize(3)
        assert backend.workers == 3 and backend.free_slots() == 3
        assert future_map(lambda x: x, list(range(8))) == list(range(8))
        backend.resize(1)
        assert backend.workers == 1 and backend.free_slots() == 1
        assert value(future(lambda: "still-alive")) == "still-alive"
    finally:
        rc.shutdown()


def test_cancel_running_task(pool):
    f = future(lambda: time.sleep(30))
    time.sleep(0.1)
    assert f.cancel()
    with pytest.raises(rc.FutureError):
        value(f)
    assert value(future(lambda: 1)) == 1          # pool healed


# --------------------------------------------------------------------------
# stream, map-reduce and state rows on processes
# --------------------------------------------------------------------------

def test_backpressure_bounds_concurrency_processes():
    rc.plan("processes", workers=3)
    try:
        def body(x):
            import time as _t
            t0 = _t.time()
            _t.sleep(0.02)
            return (t0, _t.time())

        s = stream(range(12), max_in_flight=2)
        spans = s.map(body).collect()
        events = sorted([(t0, 1) for t0, _ in spans]
                        + [(t1, -1) for _, t1 in spans])
        cur = peak = 0
        for _, step in events:
            cur += step
            peak = max(peak, cur)
        assert peak <= 2
        assert s.stats["peak_in_flight"] <= 2
    finally:
        rc.shutdown()


def test_stream_retries_dead_chunk_processes(pool, tmp_path):
    marker = str(tmp_path / "chunk-died")

    def elem(x, _marker=marker):
        import os as _os
        if x == 3 and not _os.path.exists(_marker):
            open(_marker, "w").close()
            _os._exit(7)
        return x * 2

    s = stream(range(6), max_in_flight=2)
    assert s.map(elem, retries=2).collect() == [0, 2, 4, 6, 8, 10]
    assert s.stats["retried"] >= 1


def test_stream_retries_exhausted_raises(pool):
    def die(x):
        import os as _os
        _os._exit(13)

    with pytest.raises(rc.WorkerDiedError):
        stream(range(4)).map(die, retries=1).collect()


def test_rng_invariant_to_chunking_on_processes():
    def draw(x, key):
        return float(rng_mod.normal(key, ()))

    rc.set_session_seed(7)
    ref = future_map(draw, [0] * 6, seed=True, chunks=1)
    rc.plan("processes", workers=WORKERS)
    rc.set_session_seed(7)
    for chunks in (1, 2, 6):
        assert future_map(draw, [0] * 6, seed=True, chunks=chunks) == ref


@pytest.mark.state
def test_sigkill_mid_update_no_lost_update_no_torn_version(pool, tmp_path):
    """A worker SIGKILLed while hammering state.update: its future fails
    with WorkerDiedError, every surviving update lands, and value ==
    version (each commit was exactly one fold)."""
    pidfile = str(tmp_path / "victim.pid")

    def victim(_p=pidfile):
        import os as _os
        import time as _time
        from repro_torch.core import state
        with open(_p + ".tmp", "w") as fh:
            fh.write(str(_os.getpid()))
        _os.replace(_p + ".tmp", _p)          # pid visible only when complete
        deadline = _time.monotonic() + 20
        while _time.monotonic() < deadline:   # hammer until the kill lands
            state.update("kill.acc", lambda v: (v or 0) + 1)
        return "survived"

    def steady():
        from repro_torch.core import state
        for _ in range(10):
            state.update("kill.acc", lambda v: (v or 0) + 1)
        return True

    fv = future(victim)
    _poll(lambda: os.path.exists(pidfile), what="the victim's pid")
    _poll(lambda: (rc.state.get("kill.acc", 0) or 0) >= 20,
          what="the victim's updates")
    with open(pidfile) as fh:
        os.kill(int(fh.read()), signal.SIGKILL)
    with pytest.raises(rc.WorkerDiedError):
        value(fv)
    others = [future(steady) for _ in range(3)]
    assert value(gather(others)) == [True] * 3     # pool self-healed
    final = rc.state.get("kill.acc")
    assert rc.state.version("kill.acc") == final   # no torn version
    assert final >= 50                             # no lost surviving update


# --------------------------------------------------------------------------
# the slice: xLSTM prefill futures in workers
# --------------------------------------------------------------------------

def test_xlstm_prefill_futures_in_workers_match_the_direct_call_and_jax():
    """Prefill futures of the smoke xLSTM on two workers give the port's
    direct tokens and logits bit for bit and the JAX package's logits within
    the model tolerance; the parameters (a dict of tensors, digested over
    its pickle) ship to a worker once, and future_map over four batches
    gives the sequential map's tokens."""
    import jax
    import jax.numpy as jnp
    from _torch_parity import MODEL_TOL, jax_params, torch_params
    from repro.configs import get_arch as jax_arch
    from repro.models import Model as JModel
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.train import make_prefill_step

    jcfg, cfg = jax_arch("xlstm-125m", smoke=True), \
        get_arch("xlstm-125m", smoke=True)
    jp, npp = jax_params(jcfg, seed=0)
    params = torch_params(npp, cfg)
    model = Model(cfg)
    prefill = make_prefill_step(model)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 64))
    batch = {"tokens": torch.from_numpy(toks)}
    first = prefill(params, batch)
    logits, _ = model.apply(params, batch)

    rc.plan("processes", workers=2, blob_store_bytes=64 << 20)  # own pool
    try:
        backend = rc.active_backend()
        puts = []
        for w in backend._idle:
            w.parent_conn = _PutTally(w.parent_conn)
            puts.append(w.parent_conn)
        shipped = []
        for _ in range(3):
            got, pid = value(future(lambda: (prefill(params, batch),
                                             os.getpid())))
            assert pid != os.getpid()
            assert torch.equal(got, first)
            shipped.append(sorted(t.put_bytes for t in puts))
        nbytes = sum(t.numel() * t.element_size()
                     for t in _leaves(params))
        # the first future ships the parameters (a zlib'd pickle of the
        # dict) to one worker; the later ones, on that warm worker, nothing
        assert shipped[0][0] == 0 and shipped[0][1] > nbytes / 2
        assert shipped[1] == shipped[2] == shipped[0]
        wl = value(future(lambda: model.apply(params, batch)[0]))
        assert torch.equal(wl, logits)
        want, _ = jax.jit(JModel(jcfg).apply)(jp, {"tokens": jnp.asarray(toks)})
        np.testing.assert_allclose(wl.numpy(), np.asarray(want), **MODEL_TOL)

        rng = np.random.default_rng(4)
        batches = [{"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, size=(1, 32)))} for _ in range(4)]
        seq = [prefill(params, b) for b in batches]
        out = future_map(lambda b: prefill(params, b), batches)
        assert all(torch.equal(a, b) for a, b in zip(out, seq))
    finally:
        rc.shutdown()


def _leaves(tree):
    from repro_torch.tree import leaves
    return list(leaves(tree))


class _PutTally:
    """Wraps a worker's pipe end: counts the payload bytes of its ``put``
    messages."""

    def __init__(self, conn):
        self._conn = conn
        self.put_bytes = 0

    def send(self, msg):
        if msg[0] == "put":
            self.put_bytes += len(msg[2])
        self._conn.send(msg)

    def __getattr__(self, name):
        return getattr(self._conn, name)


def test_an_undecodable_task_fails_the_future_not_the_worker():
    """A task whose payload cannot be rebuilt in the worker (here: a tensor
    whose pickle says it lives on a card the worker has not) fails with the
    error, and the same worker runs the next task."""
    from repro_torch.core.globals_capture import _rebuild_tensor

    class OnTheCard:
        def __reduce__(self):
            return (_rebuild_tensor, (b"\0" * 16, "float32", (4,), "cuda",
                                      False))

    if torch.cuda.is_available():
        pytest.skip("the worker has a card")
    g = OnTheCard()
    rc.plan("processes", workers=1)
    pid = value(future(lambda: os.getpid()))
    with pytest.raises(rc.ChannelError, match="no CUDA device"):
        value(future(lambda: g))
    assert value(future(lambda: os.getpid())) == pid


class _LoadsNowhereBut:
    """A value that unpickles everywhere but in the process ``pid``."""

    def __init__(self, pid):
        self.pid = pid

    def __reduce__(self):
        return (_load_unless_in, (self.pid,))


def _load_unless_in(pid):
    if os.getpid() == pid:
        raise RuntimeError("this result does not load in the parent")
    return _LoadsNowhereBut(pid)


def test_a_result_that_does_not_load_in_the_parent_fails_the_future():
    """A worker's reply that the parent cannot unpickle (on the card: a
    result tensor the parent's card has no room for) fails its future with
    that error, and the pool goes on."""
    parent = os.getpid()
    rc.plan("processes", workers=1)
    with pytest.raises(RuntimeError, match="does not load in the parent"):
        value(future(lambda: _LoadsNowhereBut(parent)))
    assert value(future(lambda: 41 + 1)) == 42
