"""Lineage reconstruction and proactive replication on the port's cluster:
a mirror of the 9 rows of tests/test_lineage.py and the two lineage rows of
tests/test_dataflow.py (:357, :382), and the outcomes the JAX package's
cluster must share, compared on the same scenario: the
``recovery_stats()`` counts after an eviction and after a replication,
and the error type and message at the depth cap, when the budget is spent
and when no lineage is recorded.

A worker-resident result whose every copy is gone is re-produced by
running its recorded producing task again (its parents first, capped by
``lineage_max_depth`` / ``lineage_max_attempts``); the rebuilt bytes are
the sequential value's, bit for bit. Synchronisation is on driver state
and marker files, never on sleeps; wall-clock bounds are loose (ROADMAP
note R1).
"""

import os
import re
import time

import numpy as np
import pytest
from _torch_cluster_harness import HarnessLauncher

import repro_torch.core as rc
from repro_torch.core import future
from repro_torch.core.backends.blobstore import DRIVER_STORE

pytestmark = pytest.mark.lineage

#: crosses RESULT_REF_THRESHOLD (64 KiB); fast for the non-acceptance cases
_N = 1 << 17          # 1 MiB of float64

#: the acceptance scenario sizes the intermediate at 8 MiB
_N8 = 1 << 20         # 8 MiB of float64

#: fast-heal knobs (same as the faults and dataflow rows)
_FAST = dict(heartbeat_interval=0.1, heartbeat_timeout=3.0,
             relaunch_backoff=0.05, relaunch_backoff_cap=0.2)

#: seconds any one wait on a worker may take
WAIT = 60.0


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


def _big(bias=0.0):
    """1 MiB payload with a row-unique digest (DRIVER_STORE is
    process-global: a loss row needs bytes no earlier row pulled)."""
    return np.arange(_N, dtype=np.float64) + bias


def _big8(bias=0.0):
    return np.arange(_N8, dtype=np.float64) + bias


def _sequential(fn, *args):
    """The sequential backend's value of ``fn(*args)``: what a rebuilt
    result must equal bit for bit."""
    prev = rc.plan("sequential")
    try:
        return future(fn, *args).value()
    finally:
        rc.plan(prev)


def _remote_value_of(f):
    """The held result's handle (either package's RemoteValue)."""
    run = f._backend.collect(f._handle)
    assert getattr(run.value, "is_remote_value", False), run.value
    return run.value


def _holder_pids(backend, digest):
    wids = backend.locations(digest)
    with backend._pool_cv:
        return {w.meta.get("pid") for w in backend._all if w.wid in wids}


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise TimeoutError(f"{what} not reached within {timeout}s")


def _make_once_blocker(pidfile):
    """Chain body whose *first* execution publishes its pid and parks
    until the harness SIGKILLs the worker; the run after recovery sees
    the marker and computes. Local function so it ships by value."""
    def body(a, _p=pidfile):
        import os as _os
        import time as _time
        if not _os.path.exists(_p):
            with open(_p + ".tmp", "w") as fh:
                fh.write(str(_os.getpid()))
            _os.replace(_p + ".tmp", _p)
            while True:
                _time.sleep(0.005)
        return float(a.sum())
    return body


def _make_parker(pidfile, release):
    """Chain body that parks its worker until the release marker."""
    def body(a, _p=pidfile, _r=release):
        import os as _os
        import time as _time
        with open(_p + ".tmp", "w") as fh:
            fh.write(str(_os.getpid()))
        _os.replace(_p + ".tmp", _p)
        while not _os.path.exists(_r):
            _time.sleep(0.005)
        return float(a[0])
    return body


# --------------------------------------------------------------------------
# tests/test_lineage.py
# --------------------------------------------------------------------------

@pytest.mark.launcher
def test_sole_holder_sigkill_midchain_rebuilds_bit_identical(tmp_path):
    """SIGKILL the sole holder of an 8 MiB intermediate while the
    dependent hop runs on it: the hop's retry rebuilds the intermediate
    from lineage on the survivor, the chain resolves to the right value
    and the intermediate's digest pulls the sequential value bit for
    bit."""
    want = _sequential(_big8, 17.5)
    h = HarnessLauncher()
    rc.plan("cluster", hosts=2, launcher=h, **_FAST)
    backend = rc.active_backend()
    f = future(_big8, 17.5)
    digest = _remote_value_of(f).digest
    assert digest not in DRIVER_STORE     # sole copy is worker-resident
    pidfile = str(tmp_path / "holder.pid")
    watcher = h.kill_on_pidfile(pidfile)
    g = f.then(_make_once_blocker(pidfile))
    assert g.value(timeout=WAIT) == float(want.sum())
    watcher.join(30.0)
    assert watcher.killed is not None     # the kill really landed
    assert backend.recovery_stats()["reconstructions"] >= 1
    assert f.value().tobytes() == want.tobytes()
    assert digest in DRIVER_STORE
    rc.shutdown()


@pytest.mark.launcher
def test_min_replicas_survives_holder_death_with_zero_reexecutions():
    h = HarnessLauncher()
    rc.plan("cluster", hosts=2, launcher=h, min_replicas=2, **_FAST)
    backend = rc.active_backend()
    f = future(_big8, 23.5)
    digest = _remote_value_of(f).digest
    _wait(lambda: len(backend.locations(digest)) >= 2,
          what="proactive replica registered")
    assert backend.recovery_stats()["replications"] >= 1
    pid = next(iter(_holder_pids(backend, digest)))
    with backend._pool_cv:
        dead_wid = next(w.wid for w in backend._all
                        if w.meta.get("pid") == pid)
    h.kill(h.by_pid(pid))
    _wait(lambda: dead_wid not in backend.locations(digest)
          and backend.locations(digest),
          what="death pruned; surviving replica still registered")
    g = f.then(lambda a: float(a.sum()))
    assert g.value(timeout=WAIT) == float(_big8(23.5).sum())
    assert backend.recovery_stats()["reconstructions"] == 0
    rc.shutdown()


def _displaced(pkg, bias, **kw):
    """tests/test_lineage.py:163's scenario on ``pkg``'s cluster: one
    worker whose store holds one result, so a second result displaces the
    first, never pulled. Returns the first future and the backend."""
    blob_bytes = int(_N * 8 * 1.5)
    pkg.plan("cluster", workers=1, blob_store_bytes=blob_bytes, **kw)
    f = pkg.future(_big, bias)
    _remote_value_of(f)
    f2 = f.then(lambda a: a + 1.0)        # displaces f's blob on the holder
    f2.value()
    return f, pkg.active_backend()


def test_reexecution_budget_exhausted_surfaces_clear_error():
    """lineage_max_attempts=0 turns every rebuild into the budget error."""
    f, _ = _displaced(rc, 29.5, lineage_max_attempts=0)
    with pytest.raises(rc.LineageExhaustedError, match="budget"):
        f.value()


def test_depth_cap_raises_lineage_exhausted():
    rc.plan("cluster", workers=1)
    backend = rc.active_backend()
    with pytest.raises(rc.LineageExhaustedError, match="depth cap"):
        backend._reconstruct(b"\x00" * 16,
                             _depth=backend._lineage_max_depth + 1)


def test_lost_digest_without_lineage_is_diagnosable():
    """Bytes the driver never saw produced fail with the no-lineage
    message, not a hang."""
    rc.plan("cluster", workers=1)
    backend = rc.active_backend()
    with pytest.raises(rc.LineageExhaustedError,
                       match="no producing task is recorded"):
        backend._reconstruct(b"\x01" * 16)


def test_gc_drops_lineage_record():
    """Evicting a digest by RemoteValue GC also drops its lineage: the
    registry cannot outgrow the set of live results."""
    import gc
    rc.plan("cluster", workers=2)
    backend = rc.active_backend()
    f = future(_big, 31.75)
    rv = _remote_value_of(f)
    digest = rv.digest
    with backend._lineage_lock:
        assert digest in backend._lineage
    del f, rv
    gc.collect()

    def _gone():
        with backend._lineage_lock:
            return digest not in backend._lineage
    _wait(_gone, what="GC-driven lineage drop")


def test_lineage_registry_is_bounded():
    rc.plan("cluster", workers=1, lineage_keep=2)
    backend = rc.active_backend()
    fs = [future(_big, 100.0 + i) for i in range(3)]
    rvs = [_remote_value_of(f) for f in fs]
    with backend._lineage_lock:
        assert len(backend._lineage) <= 2
        assert rvs[0].digest not in backend._lineage   # oldest LRU-evicted
        assert rvs[2].digest in backend._lineage
    assert fs and rvs                                  # keep refs pinned


def test_peer_fetch_promotes_fetcher_to_replica(tmp_path):
    """A task-path peer fetch leaves a second registered holder behind
    (the ("stored", d, n, "fetch") confirmation)."""
    rc.plan("cluster", workers=2)
    backend = rc.active_backend()
    pidfile, release = str(tmp_path / "pid"), str(tmp_path / "go")
    f = future(_big, 41.5)
    digest = _remote_value_of(f).digest
    assert len(backend.locations(digest)) == 1
    promotions = backend.recovery_stats()["replica_promotions"]
    # occupy the holder deterministically: this chain is locality-routed
    blocker = f.then(_make_parker(pidfile, release))
    _wait(lambda: os.path.exists(pidfile), what="parker pinned on holder")
    g = f.then(lambda a: float(a.sum()))   # holder busy -> other worker
    assert g.value(timeout=WAIT) == float(_big(41.5).sum())
    _wait(lambda: len(backend.locations(digest)) >= 2,
          what="fetcher promoted to replica")
    assert backend.recovery_stats()["replica_promotions"] >= promotions + 1
    open(release, "w").close()
    assert blocker.value(timeout=WAIT) == float(_big(41.5)[0])


@pytest.mark.launcher
def test_slow_holder_races_reconstruction():
    """Freeze the sole holder past the heartbeat timeout: the driver
    declares it dead and rebuilds from lineage; the frozen process (whose
    peer server still has the original bytes) is resumed once the rebuild
    has begun. Content addressing makes the race benign: the value is the
    sequential one, bit for bit, whichever side wins."""
    want = _sequential(_big, 37.5)
    h = HarnessLauncher()
    rc.plan("cluster", hosts=2, launcher=h, **_FAST)
    backend = rc.active_backend()
    f = future(_big, 37.5)
    digest = _remote_value_of(f).digest
    pid = next(iter(_holder_pids(backend, digest)))
    wp = h.by_pid(pid)
    assert wp is not None
    h.stall(wp)            # silent past heartbeat_timeout: declared dead
    try:
        _wait(lambda: not backend.locations(digest),
              what="frozen holder declared dead")
        g = f.then(lambda a: float(a.sum()))
        _wait(lambda: backend.recovery_stats()["reconstructions"] >= 1,
              what="the rebuild began")
    finally:
        h.resume(wp)       # the zombie comes back mid-recovery
    assert g.value(timeout=WAIT) == float(want.sum())
    assert f.value().tobytes() == want.tobytes()
    assert backend.recovery_stats()["reconstructions"] >= 1
    # the pool keeps serving fresh work after the zombie resumed
    assert future(lambda: 7).value(timeout=WAIT) == 7
    rc.shutdown()


# --------------------------------------------------------------------------
# tests/test_dataflow.py's two lineage rows
# --------------------------------------------------------------------------

def test_evicted_everywhere_reconstructs_from_lineage():
    """Displace f's blob from its only holder: the pull finds no live
    copy anywhere, so the driver runs f's producing task again and the
    value comes back digest-identical."""
    want = _sequential(_big, 3.5)
    f, backend = _displaced(rc, 3.5)
    rv = _remote_value_of(f)
    v = f.value()
    assert v.tobytes() == want.tobytes()
    assert rv.digest in DRIVER_STORE     # rebuilt bytes are digest-exact
    assert backend is rc.active_backend()
    assert backend.recovery_stats()["reconstructions"] >= 1


@pytest.mark.launcher
def test_holder_death_recovers_dependent_chain_via_lineage():
    """SIGKILL the worker holding f's result before g dispatches: f's
    producing task runs again, the chain resolves (no WorkerDiedError
    escapes), and the recovery shows in ``recovery_stats()``."""
    want = _sequential(_big, 5.25)
    h = HarnessLauncher()
    rc.plan("cluster", hosts=2, launcher=h, **_FAST)
    backend = rc.active_backend()
    f = future(_big, 5.25)
    rv = _remote_value_of(f)
    pid = next(iter(_holder_pids(backend, rv.digest)))
    wp = h.by_pid(pid)
    assert wp is not None
    h.kill(wp)
    _wait(lambda: not backend.locations(rv.digest), what="death detected")
    g = f.then(lambda a: float(a.sum()))
    assert g.value(timeout=WAIT) == float(want.sum())
    assert f.value().tobytes() == want.tobytes()
    assert backend.recovery_stats()["reconstructions"] >= 1
    # self-heal: the replacement joins and fresh chains work end to end
    h.wait_launches(3)
    f2 = future(_big, 5.375)
    assert f2.then(lambda a: float(a.sum())).value(timeout=WAIT) \
        == float(_big(5.375).sum())
    rc.shutdown()


# --------------------------------------------------------------------------
# The same outcomes as the JAX package's cluster
# --------------------------------------------------------------------------

def _scenario_counts(pkg, scenario: str) -> dict:
    """``recovery_stats()`` after one deterministic scenario on ``pkg``'s
    cluster: ``evicted`` (a displaced sole copy pulled, so rebuilt once)
    or ``replicated`` (a result pushed to a second worker under
    ``min_replicas=2``)."""
    try:
        if scenario == "evicted":
            f, backend = _displaced(pkg, 61.5)
            np.testing.assert_array_equal(f.value(), _big(61.5))
        else:
            pkg.plan("cluster", workers=2, min_replicas=2)
            backend = pkg.active_backend()
            f = pkg.future(_big, 62.5)
            digest = _remote_value_of(f).digest
            _wait(lambda: len(backend.locations(digest)) == 2,
                  what="the replica registered")
            _wait(lambda: backend.recovery_stats()["replications"] == 1,
                  what="the replication counted")
        return backend.recovery_stats(by_tenant=True)
    finally:
        pkg.shutdown()


@pytest.mark.parametrize("scenario", ["evicted", "replicated"])
def test_recovery_stats_counts_are_the_references(scenario):
    import repro.core as ref_core
    ref = _scenario_counts(ref_core, scenario)
    port = _scenario_counts(rc, scenario)
    assert port == ref
    assert port["reconstructions"] == (scenario == "evicted")
    assert port["replications"] == (scenario == "replicated")


def _cap_error(pkg, which: str) -> Exception:
    """The LineageExhaustedError ``pkg``'s cluster raises at the depth
    cap, with the budget spent, or with no lineage recorded."""
    try:
        if which == "budget":
            f, _ = _displaced(pkg, 63.5, lineage_max_attempts=0)
            target = f.value
        else:
            pkg.plan("cluster", workers=1, lineage_max_depth=3)
            backend = pkg.active_backend()
            if which == "depth":
                def target():
                    backend._reconstruct(b"\x00" * 16, "hop", _depth=4)
            else:
                def target():
                    backend._reconstruct(b"\x01" * 16, "hop")
        with pytest.raises(pkg.LineageExhaustedError) as info:
            target()
        return info.value
    finally:
        pkg.shutdown()


@pytest.mark.parametrize("which", ["depth", "budget", "no_lineage"])
def test_cap_errors_are_the_references(which):
    """Same error type and message as the reference (the digest's hex
    and the future's label aside: the two packages encode an array's
    bytes each their own way, and number their futures apart)."""
    import repro.core as ref_core
    ref = _cap_error(ref_core, which)
    port = _cap_error(rc, which)

    def masked(exc):
        out = re.sub(r"\b[0-9a-f]{12}\b", "<digest>", str(exc))
        return re.sub(r"\(future-\d+\)", "(<label>)", out)

    assert type(port).__name__ == type(ref).__name__
    assert masked(port) == masked(ref)
    assert {"depth": "depth cap (3)", "budget": "(0/0 attempts)",
            "no_lineage": "no producing task"}[which] in str(port)
    assert port.digest is not None
