"""Future API conformance and shared state on the port's cluster, and the
slice end to end.

* The backend-parametrised rows of tests/test_torch_conformance.py (the
  port's mirror of tests/test_conformance.py) on the reference's cluster
  rows: ``cluster`` (``workers=2``) and ``cluster+tls+token`` (launched
  workers behind TLS and the token preamble; needs ``openssl``). Each
  gives the sequential backend's values, relays and errors.
* The cluster rows of tests/test_state.py: concurrent folds are exact
  over the socket state lane, CAS losses are real races, a SIGKILL
  mid-update tears nothing, watches fan out.
* The slice: xLSTM prefill futures on cluster workers (smoke size) give
  the port's direct call bit for bit and the JAX package's logits within
  the model tolerance; a warm worker is sent 0 ``put`` bytes; a held
  logits tensor chains on its holder and pulls bit for bit.

The rows share warm pools (``planning.py``); the module's end shuts them
down.
"""

import os
import time

import numpy as np
import pytest
import torch
from _torch_cluster_harness import HarnessLauncher, ephemeral_tls
from test_torch_conformance import (  # noqa: F401  (rows run here)
    test_chain_propagates_parent_error, test_chain_raises_continuation_error,
    test_chain_relays_whole_chain_stdout, test_exception_relayed_as_is,
    test_first_returns_earliest_completion,
    test_first_successful_all_failures_propagates_first,
    test_first_successful_skips_failures,
    test_gather_values_and_error_propagation, test_map_matches_sequential,
    test_nested_parallelism_protection,
    test_recover_handles_error_and_passes_value,
    test_result_chain_exception_and_recover,
    test_result_chain_rng_stream_invariance, test_result_chain_values,
    test_rng_stream_invariance, test_same_value, test_snapshot_semantics,
    test_state_cas_exactly_one_winner,
    test_state_concurrent_update_is_exact_fold,
    test_state_semantics_tuple, test_state_wait_blocks_until_put,
    test_state_wait_timeout_relayed, test_stdout_relay,
    test_stream_error_relayed_as_is, test_stream_fused_seeded_maps_rng_parity,
    test_stream_matches_map, test_stream_reduce_over_generator,
    test_stream_two_maps_fused_parity, test_then_flattens_returned_future,
    test_then_map_chain_value, test_value_timeout, test_warning_relay)

import repro_torch.core as rc
from repro_torch.core import future, gather, state

#: fast-heal knobs (same as tests/test_faults.py)
_FAST = dict(heartbeat_interval=0.1, heartbeat_timeout=3.0,
             relaunch_backoff=0.05, relaunch_backoff_cap=0.2)

#: seconds any one wait on a worker may take
WAIT = 60.0

#: the reference's cluster rows of tests/test_conformance.py
CLUSTER_ROWS = [
    ("cluster", {"workers": 2}),
    ("cluster+tls+token", {"hosts": 2, "_secure": True}),
]


def value(f, timeout: float = WAIT):
    return rc.value(f, timeout=timeout)


def _plan_kwargs(kw):
    kw = dict(kw)
    if kw.pop("_secure", False):
        kw.update(token="conformance-secret", tls=ephemeral_tls())
    return kw


@pytest.fixture(autouse=True)
def _reset_port():
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


@pytest.fixture(params=CLUSTER_ROWS, ids=[r[0] for r in CLUSTER_ROWS])
def backend(request):
    """Each conformance row runs once a cluster row, on its warm pool (made
    whole first; parked again, so that a row which sets its own session
    seed instantiates the backend under it, as a fresh plan would)."""
    kw = _plan_kwargs(request.param[1])
    rc.plan("cluster", **kw)
    rc.active_backend().wait_for_workers(timeout=WAIT)
    rc.plan("sequential")
    rc.plan("cluster", **kw)
    yield "cluster"
    rc.plan("sequential")


def _poll(pred, timeout=WAIT, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise TimeoutError(f"{what} not reached within {timeout}s")


# --------------------------------------------------------------------------
# tests/test_state.py: the cluster rows
# --------------------------------------------------------------------------

@pytest.fixture
def eight():
    """Eight cluster workers, one warm pool for the 8-way rows."""
    rc.plan("cluster", workers=8)
    rc.active_backend().wait_for_workers(8, timeout=WAIT)
    yield
    rc.plan("sequential")


@pytest.mark.state
def test_eight_cluster_workers_exact_fold(eight):
    per_task = 4

    def body():
        from repro_torch.core import state
        for _ in range(per_task):
            state.update("acc8", lambda v: (v or 0) + 1)
        return True

    fs = [future(body) for _ in range(8)]
    assert value(gather(fs)) == [True] * 8
    assert state.get("acc8") == 8 * per_task
    assert state.version("acc8") == 8 * per_task


@pytest.mark.state
def test_cas_loses_exactly_the_races_it_should():
    rc.plan("cluster", workers=4)

    def body(i):
        from repro_torch.core import state
        wins, attempts = 0, 0
        for _ in range(6):
            while True:
                ver = state.version("cas.k")
                attempts += 1
                ok, newver, _cur = state.cas("cas.k", ver, i)
                if ok:
                    assert newver == ver + 1
                    wins += 1
                    break
        return wins, attempts

    got = value(gather([future(lambda i=i: body(i)) for i in range(4)]))
    total_wins = sum(w for w, _ in got)
    total_attempts = sum(a for _, a in got)
    assert total_wins == 4 * 6
    assert rc.state.version("cas.k") == total_wins
    assert total_attempts >= total_wins


@pytest.mark.state
def test_update_fn_reruns_are_invisible_in_history():
    rc.plan("cluster", workers=4)

    def body():
        from repro_torch.core import state
        for _ in range(8):
            state.update("rerun.acc", lambda v: (v or 0) + 1)
        return state.stats()["cas_retries"]

    retries = value(gather([future(body) for _ in range(4)]))
    assert state.get("rerun.acc") == 32
    assert state.version("rerun.acc") == 32
    assert all(r >= 0 for r in retries)


@pytest.mark.state
@pytest.mark.launcher
def test_sigkill_mid_update_no_lost_update_no_torn_version(tmp_path):
    harness = HarnessLauncher()
    rc.plan("cluster", hosts=2, launcher=harness, **_FAST)
    pidfile = str(tmp_path / "victim.pid")

    def victim(_p=pidfile):
        import os as _os
        import time as _time
        from repro_torch.core import state
        with open(_p + ".tmp", "w") as fh:
            fh.write(str(_os.getpid()))
        _os.replace(_p + ".tmp", _p)
        deadline = _time.monotonic() + 20
        while _time.monotonic() < deadline:
            state.update("kill.acc", lambda v: (v or 0) + 1)
        return "survived"

    def steady():
        from repro_torch.core import state
        for _ in range(10):
            state.update("kill.acc", lambda v: (v or 0) + 1)
        return True

    fv = future(victim)
    watcher = harness.kill_on_pidfile(pidfile)
    others = [future(steady) for _ in range(3)]
    with pytest.raises(rc.WorkerDiedError):
        value(fv)
    watcher.join(timeout=30)
    assert watcher.killed is not None
    assert value(gather(others)) == [True] * 3
    final = rc.state.get("kill.acc")
    assert rc.state.version("kill.acc") == final
    assert final >= 30
    rc.shutdown()


@pytest.mark.state
def test_wait_fanout_one_put_releases_all_waiters():
    rc.plan("cluster", workers=4)

    def waiter():
        from repro_torch.core import state
        val, ver = state.wait("fan.k", 1, timeout=30)
        return (val, ver)

    ws = [future(waiter) for _ in range(3)]
    svc = state.service()
    _poll(lambda: svc.stats()["watches"] >= 3, what="3 parked watchers")
    rc.state.put("fan.k", "fire")
    assert value(gather(ws)) == [("fire", 1)] * 3


@pytest.mark.state
def test_wait_min_version_skips_stale_values():
    rc.plan("cluster", workers=2)
    rc.state.put("mv.k", "old")

    def waiter():
        from repro_torch.core import state
        return state.wait("mv.k", 2, timeout=30)

    w = future(waiter)
    svc = state.service()
    _poll(lambda: svc.stats()["watches"] >= 1, what="parked watcher")
    rc.state.put("mv.k", "new")
    assert value(w) == ("new", 2)


@pytest.mark.state
def test_add_exact_under_eight_way_contention(eight):
    per_task = 25

    def body():
        from repro_torch.core import state
        for _ in range(per_task):
            state.add("fold.add", 1)
        return True

    fs = [future(body) for _ in range(8)]
    assert value(gather(fs)) == [True] * 8
    assert state.get("fold.add") == 8 * per_task
    assert state.version("fold.add") == 8 * per_task


@pytest.mark.state
def test_extend_exact_under_eight_way_contention(eight):
    per_task = 10

    def body(wid):
        from repro_torch.core import state
        for i in range(per_task):
            state.extend("fold.list", [(wid, i)])
        return True

    fs = [future(lambda w=w: body(w)) for w in range(8)]
    assert value(gather(fs)) == [True] * 8
    got = state.get("fold.list")
    assert sorted(got) == sorted(
        (w, i) for w in range(8) for i in range(per_task))
    assert state.version("fold.list") == 8 * per_task


@pytest.mark.state
def test_large_state_value_rides_out_of_band_and_back():
    """A large tensor put from a worker rides the content-addressed state
    lane out-of-band and comes back equal to the driver's own result."""
    rc.plan("cluster", workers=2)
    t = torch.arange(1 << 16, dtype=torch.float32)

    def body(a):
        from repro_torch.core import state
        state.put("big.up", a * 2.0)
        got = state.get("big.up")
        return float(got.sum())

    assert value(future(body, t)) == float((t * 2.0).sum())
    assert torch.equal(rc.state.get("big.up"), t * 2.0)


# --------------------------------------------------------------------------
# the slice: xLSTM prefill futures on cluster workers
# --------------------------------------------------------------------------

def test_xlstm_prefill_futures_on_cluster_match_the_direct_call_and_jax():
    """Prefill futures of the smoke xLSTM on two cluster workers give the
    port's direct tokens bit for bit and the JAX package's logits within
    the model tolerance; the parameters ship to a worker once (a warm
    worker is sent 0 put bytes); a held logits tensor chains on its holder
    without crossing the driver and pulls bit for bit."""
    import jax
    import jax.numpy as jnp
    from _torch_parity import MODEL_TOL, jax_params, torch_params
    from repro.configs import get_arch as jax_arch
    from repro.models import Model as JModel
    from repro_torch.configs import get_arch
    from repro_torch.core.backends import transport
    from repro_torch.core.backends.blobstore import RemoteValue
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

    rc.plan("cluster", workers=2, blob_store_bytes=64 << 20,
            token=os.urandom(8).hex())
    try:
        backend = rc.active_backend()
        backend.wait_for_workers(2, timeout=WAIT)
        seen, before = set(), dict(backend.put_bytes())
        for _ in range(3):
            got, pid = value(future(lambda: (prefill(params, batch),
                                             os.getpid())))
            assert pid != os.getpid()
            assert torch.equal(got, first)
            after = dict(backend.put_bytes())
            put = after[pid] - before.get(pid, 0)
            # the parameters ship to a worker once: a worker that holds
            # them is sent 0 put bytes
            assert (put == 0) if pid in seen else (put > 0), (pid, put)
            seen.add(pid)
            before = after

        f = future(lambda: model.apply(params, batch)[0])
        run = backend.collect(f._handle)
        assert isinstance(run.value, RemoteValue)
        holders = backend.locations(run.value.digest)
        assert len(holders) == 1
        transport.reset_wire_stats()
        total = f.then(lambda t: t.double().sum().item()).value(timeout=WAIT)
        assert transport.wire_stats()["bytes_recv"] < logits.nbytes // 10
        assert total == logits.double().sum().item()
        wl = f.value()
        assert torch.equal(wl, logits)
        want, _ = jax.jit(JModel(jcfg).apply)(jp, {"tokens": jnp.asarray(toks)})
        np.testing.assert_allclose(wl.numpy(), np.asarray(want), **MODEL_TOL)
    finally:
        rc.shutdown()
