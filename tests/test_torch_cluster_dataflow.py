"""Worker-to-worker dataflow on the port's cluster (a mirror of
tests/test_dataflow.py, less its two lineage rows, which
tests/test_torch_lineage.py mirrors): remote results, locality-scheduled
chains, peer blob fetch, driver-side GC. Also the frame rows of
tests/test_payload_cache.py (:322-388), two rows of tests/test_lineage.py
(:163 against the JAX package at ``lineage_max_attempts=0``, and :185), an
unknown kwarg refused at ``plan()``, and held tensors.

Each row's values are the sequential backend's. The rows share warm pools
(``planning.py``); the module's end shuts them down.
"""

import os
import pickle
import socket
import time

import numpy as np
import pytest
import torch
from _torch_cluster_harness import HarnessLauncher

import repro_torch.core as rc
from repro_torch.core import future, gather, stream, value
from repro_torch.core.backends import transport
from repro_torch.core.backends.blobstore import (DRIVER_STORE, RemoteValue,
                                                 blob_digest)

pytestmark = pytest.mark.dataflow

#: big enough to cross RESULT_REF_THRESHOLD (64 KiB), small enough for fast
#: tests
_N = 1 << 17          # 1 MiB of float64

#: fast-heal knobs (same as tests/test_faults.py)
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


def _plan(**kw):
    """Plan a cluster and wait until all its workers are up (a warm pool
    an earlier row hurt heals first)."""
    rc.plan("cluster", **kw)
    backend = rc.active_backend()
    backend.wait_for_workers(timeout=WAIT)
    return backend


def _big(bias=0.0):
    """1 MiB payload; ``bias`` gives a test a digest no other test shares
    (DRIVER_STORE is process-global and content-addressed)."""
    return np.arange(_N, dtype=np.float64) + bias


def _remote_value_of(f):
    run = f._backend.collect(f._handle)
    assert isinstance(run.value, RemoteValue), run.value
    return run.value


def _holder_pids(backend, digest):
    wids = backend.locations(digest)
    with backend._pool_cv:
        return {w.meta.get("pid") for w in backend._all if w.wid in wids}


def _wait(pred, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise TimeoutError(f"{what} not reached within {timeout}s")


def _make_blocker(pidfile, release):
    """Chain body that parks its worker until the release marker appears
    (a local function, so it ships by value)."""
    def body(a, _p=pidfile, _r=release):
        import os as _os
        import time as _time
        with open(_p, "w") as fh:
            fh.write(str(_os.getpid()))
        while not _os.path.exists(_r):
            _time.sleep(0.005)
        return float(a[0])
    return body


# --------------------------------------------------------------------------
# Remote results + locality scheduling
# --------------------------------------------------------------------------

def test_large_result_stays_worker_resident_and_pulls_writable():
    backend = _plan(workers=2)
    f = future(_big)
    rv = _remote_value_of(f)
    assert rv.nbytes >= _N * 8
    assert backend.locations(rv.digest)
    assert rv.digest not in DRIVER_STORE
    v = f.value()
    assert isinstance(v, np.ndarray) and v.flags.writeable
    assert np.array_equal(v, _big())
    assert rv.digest in DRIVER_STORE


def test_small_results_travel_inline():
    _plan(workers=2)
    f = future(lambda: np.arange(16, dtype=np.float64))
    run = f._backend.collect(f._handle)
    assert isinstance(run.value, np.ndarray)
    assert np.array_equal(f.value(), np.arange(16, dtype=np.float64))


def test_chain_runs_on_holder_and_skips_the_driver_bytes():
    backend = _plan(workers=2)
    f = future(_big)
    rv = _remote_value_of(f)
    holder_pids = _holder_pids(backend, rv.digest)
    transport.reset_wire_stats()
    g = f.then(lambda a: (os.getpid(), float(a.sum())))
    pid, total = g.value()
    wire = transport.wire_stats()
    assert total == float(_big().sum())
    assert pid in holder_pids
    assert wire["bytes_sent"] < _N * 8 // 10, wire
    assert wire["bytes_recv"] < _N * 8 // 10, wire


def test_remote_value_refuses_direct_pickle():
    _plan(workers=1)
    f = future(_big)
    rv = _remote_value_of(f)
    with pytest.raises(TypeError, match="cannot be pickled directly"):
        pickle.dumps(rv)


def _driver_only_helper():
    return "never runs on a worker"


def test_undecodable_task_is_clean_error_not_worker_death():
    backend = _plan(workers=1)
    with pytest.raises(Exception,
                       match="test_torch_cluster_dataflow|_driver_only"):
        future(lambda: _driver_only_helper()).value(timeout=WAIT)
    assert future(lambda: 41 + 1).value(timeout=WAIT) == 42
    assert not backend._relaunch_log


def test_error_and_recover_mid_chain_with_remote_parent():
    _plan(workers=2)

    def boom(a):
        raise ValueError(f"boom:{int(a[0])}")

    f = future(_big)
    g = f.then(boom)
    with pytest.raises(ValueError, match="boom:0"):
        g.value()
    h = f.then(boom).recover(lambda exc: f"recovered:{exc}")
    assert h.value().startswith("recovered:")


def test_gather_pulls_cross_worker_results():
    _plan(workers=2)
    fs = [future(lambda k=k: np.full(_N, float(k))) for k in range(3)]
    got = value(gather(fs))
    for k, v in enumerate(got):
        assert np.array_equal(v, np.full(_N, float(k)))


def test_large_call_args_are_content_addressed_and_deduped():
    _plan(workers=1)
    big = np.full(_N, 3.0)
    assert future(lambda a: float(a.sum()), big).value() == float(big.sum())
    transport.reset_wire_stats()
    assert future(lambda a: float(a.sum()), big).value() == float(big.sum())
    assert transport.wire_stats()["bytes_sent"] < _N * 8 // 10


def test_a_list_of_large_args_ships_leaf_by_leaf():
    """The items of a top-level list argument are content-addressed one by
    one: the task frame stays small, each large leaf rides a put once a
    worker, and a second call with the same list sends none of it."""
    backend = _plan(workers=1)
    flat = [np.full(_N, float(k)) for k in range(3)] + [np.ones(4)]
    want = sum(float(a.sum()) for a in flat)
    wid = backend.worker_pids()[0]
    before = backend.put_bytes().get(wid, 0)
    transport.reset_wire_stats()
    assert future(lambda xs: sum(float(a.sum()) for a in xs),
                  flat).value(timeout=WAIT) == want
    first = transport.wire_stats()["bytes_sent"]
    assert backend.put_bytes()[wid] - before >= 3 * _N * 8
    assert first - (backend.put_bytes()[wid] - before) < _N * 8 // 10
    transport.reset_wire_stats()
    assert future(lambda xs: len(xs), flat).value(timeout=WAIT) == 4
    assert transport.wire_stats()["bytes_sent"] < _N * 8 // 10


def test_remote_results_off_restores_inline_results():
    _plan(workers=2, remote_results=False)
    f = future(_big)
    run = f._backend.collect(f._handle)
    assert isinstance(run.value, np.ndarray)
    g = f.then(lambda a: float(a.sum()))
    assert g.value() == float(_big().sum())


def test_worker_resident_and_gathered_values_are_bit_identical():
    """The dataflow path is invisible in the numbers: byte-equal results
    with results worker-resident, driver-gathered, and on sequential."""
    def prog():
        rc.set_session_seed(42)
        f = future(_big)
        g = f.then(lambda a: np.sqrt(a + 1.0))
        h = g.then(lambda a: a.tobytes())
        return h.value()

    _plan(workers=2, remote_results=True)
    via_workers = prog()
    _plan(workers=2, remote_results=False)
    via_driver = prog()
    rc.plan("sequential")
    assert via_workers == via_driver == prog()


def test_warm_pool_reattach_preserves_location_map():
    backend = _plan(workers=2)
    f = future(_big)
    rv = _remote_value_of(f)
    assert backend.locations(rv.digest)
    rc.plan("sequential")
    rc.plan("cluster", workers=2)
    assert rc.active_backend() is backend
    assert backend.locations(rv.digest)
    assert np.array_equal(f.value(), _big())


def test_warm_pool_key_follows_the_token_never_holding_it():
    """A plan() swap back to the same token re-attaches to the parked
    cluster; another token gets a cluster of its own; the raw token is
    not in the pool's key."""
    from repro_torch.core import planning
    a = _plan(workers=1, token="token-a")
    assert "token-a" not in repr(planning._active_key)
    rc.plan("sequential")
    b = _plan(workers=1, token="token-b")
    assert b is not a
    rc.plan("sequential")
    assert _plan(workers=1, token="token-a") is a


def test_fused_stream_maps_match_cluster_and_sequential():
    ref = [float(np.sqrt(v * 2.0 + 1.0)) for v in range(12)]
    for name, kw in (("sequential", {}), ("cluster", {"workers": 2})):
        rc.plan(name, **kw)
        s = (stream(range(12))
             .map(lambda v: v * 2.0, chunk=3)
             .map(lambda v: float(np.sqrt(v + 1.0))))
        assert s.collect(ordered=True) == ref, name
        assert s.stats["dispatched"] == 4, (name, s.stats)


# --------------------------------------------------------------------------
# Held tensors: encoded through their bytes, decoded where they are needed
# --------------------------------------------------------------------------

def test_held_tensor_chains_on_holder_and_pulls_bit_for_bit():
    backend = _plan(workers=2)

    def make():
        g = torch.Generator().manual_seed(11)
        return torch.randn(256, 1024, generator=g)

    want = make()
    f = future(make)
    rv = _remote_value_of(f)
    holder_pids = _holder_pids(backend, rv.digest)
    transport.reset_wire_stats()
    pid, total = f.then(lambda t: (os.getpid(), t.double().sum().item())) \
        .value(timeout=WAIT)
    assert pid in holder_pids
    assert total == want.double().sum().item()
    assert transport.wire_stats()["bytes_recv"] < want.nbytes // 10
    got = f.value()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    got.add_(1.0)                         # a writable tensor of its own
    assert torch.equal(f.value(), want + 1.0)


def test_held_tensor_peer_fetched_by_the_other_worker(tmp_path):
    backend = _plan(workers=2)
    pidfile, release = str(tmp_path / "pid"), str(tmp_path / "go")
    f = future(lambda: torch.arange(1 << 16, dtype=torch.float32))
    rv = _remote_value_of(f)
    holder_pids = _holder_pids(backend, rv.digest)
    blocker = f.then(_make_blocker(pidfile, release))
    _wait(lambda: os.path.exists(pidfile), what="blocker pinned on holder")
    transport.reset_wire_stats()
    g = future(lambda t: (os.getpid(), float(t.sum())), rv)
    pid, total = g.value(timeout=WAIT)
    sent = transport.wire_stats()["bytes_sent"]
    open(release, "w").close()
    assert pid not in holder_pids
    assert total == float(torch.arange(1 << 16, dtype=torch.float32).sum())
    assert sent < rv.nbytes // 10, sent
    assert blocker.value(timeout=WAIT) == 0.0


# --------------------------------------------------------------------------
# Peer fetch: protocol pin, busy holder, partition fallback, eviction
# --------------------------------------------------------------------------

def test_peer_server_protocol_pin():
    backend = _plan(workers=1)
    f = future(_big)
    rv = _remote_value_of(f)
    with backend._pool_cv:
        peers = [w.meta.get("peer") for w in backend._all]
    peer = next(p for p in peers if p)
    with socket.create_connection(tuple(peer), timeout=10) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        transport.send_frame(s, ("fetch", rv.digest))
        msg = transport.recv_frame(s)
        assert msg[0] == "offer" and msg[1] == rv.digest
        blob = bytes(msg[2])
        assert blob_digest(blob) == rv.digest
        assert len(blob) == rv.nbytes
        transport.send_frame(s, ("fetch", b"\x00" * 16))
        msg = transport.recv_frame(s)
        assert msg[0] == "onak" and msg[1] == b"\x00" * 16


def test_peer_fetch_serves_chain_while_holder_is_busy(tmp_path):
    backend = _plan(workers=2)
    pidfile, release = str(tmp_path / "pid"), str(tmp_path / "go")
    f = future(_big)
    rv = _remote_value_of(f)
    holder_pids = _holder_pids(backend, rv.digest)
    blocker = f.then(_make_blocker(pidfile, release))
    _wait(lambda: os.path.exists(pidfile), what="blocker pinned on holder")
    with open(pidfile) as fh:
        assert int(fh.read()) in holder_pids
    transport.reset_wire_stats()
    g = f.then(lambda a: (os.getpid(), float(a.sum())))
    pid, total = g.value()
    sent = transport.wire_stats()["bytes_sent"]
    open(release, "w").close()
    assert total == float(_big().sum())
    assert pid not in holder_pids
    assert sent < _N * 8 // 10, sent
    assert blocker.value() == 0.0


def test_partitioned_peer_falls_back_to_driver(tmp_path):
    # a digest of its own: the row above made both warm workers hold
    # _big()'s (a task-path peer fetch registers a replica)
    backend = _plan(workers=2)
    pidfile, release = str(tmp_path / "pid"), str(tmp_path / "go")
    f = future(_big, 7.125)
    rv = _remote_value_of(f)
    holder_pids = _holder_pids(backend, rv.digest)
    blocker = f.then(_make_blocker(pidfile, release))
    _wait(lambda: os.path.exists(pidfile), what="blocker pinned on holder")
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_addr = probe.getsockname()
    probe.close()
    real_peer_addrs = backend._peer_addrs
    backend._peer_addrs = lambda digest, exclude=None: (
        ([dead_addr], None) if real_peer_addrs(digest, exclude)[0]
        else real_peer_addrs(digest, exclude))
    try:
        g = f.then(lambda a: (os.getpid(), float(a.sum())))
        pid, total = g.value()
    finally:
        backend._peer_addrs = real_peer_addrs
        open(release, "w").close()
    assert total == float(_big(7.125).sum())
    assert pid not in holder_pids
    assert blocker.value() == 7.125


def test_eviction_under_fetch_naks_then_driver_backfills():
    blob_bytes = int(_N * 8 * 1.5)
    backend = _plan(workers=2, blob_store_bytes=blob_bytes)
    f = future(_big)
    rv = _remote_value_of(f)
    f.value()
    assert rv.digest in DRIVER_STORE
    f2 = f.then(lambda a: a * 2.0)
    rv2 = _remote_value_of(f2)
    assert backend.locations(rv2.digest)
    g = f.then(lambda a: float(a.sum()))
    assert g.value() == float(_big().sum())


# --------------------------------------------------------------------------
# A lost sole copy: LineageExhaustedError (tests/test_lineage.py:163, :185)
# --------------------------------------------------------------------------

def _displaced_pull(pkg, **later):
    """tests/test_lineage.py:163 on ``pkg``'s cluster: displace the sole
    copy of f's result under store pressure, then pull it."""
    blob_bytes = int(_N * 8 * 1.5)
    pkg.plan("cluster", workers=1, blob_store_bytes=blob_bytes, **later)
    try:
        f = pkg.future(_big, 29.25)
        run = f._backend.collect(f._handle)
        assert getattr(run.value, "is_remote_value", False)
        f2 = f.then(lambda a: a + 1.0)      # displaces f's blob on the holder
        f2.value()
        with pytest.raises(pkg.LineageExhaustedError) as info:
            f.value()
        return info.value
    finally:
        pkg.shutdown()


def test_lost_sole_copy_raises_lineage_exhausted_as_the_reference():
    """At ``lineage_max_attempts=0`` the reference and the port both raise
    LineageExhaustedError with the spent-budget message for a displaced
    sole copy."""
    import repro.core as ref_core
    ref_err = _displaced_pull(ref_core, lineage_max_attempts=0)
    port_err = _displaced_pull(rc, lineage_max_attempts=0)
    assert type(port_err).__name__ == type(ref_err).__name__
    assert "budget" in str(ref_err)
    assert "budget" in str(port_err)
    assert "(0/0 attempts)" in str(port_err) and "(0/0 attempts)" in \
        str(ref_err)
    assert port_err.digest is not None


def test_lost_digest_without_lineage_is_diagnosable():
    """Bytes the driver never saw produced fail with the no-lineage
    message, not a hang (tests/test_lineage.py:185)."""
    backend = _plan(workers=1)
    with pytest.raises(rc.LineageExhaustedError,
                       match="no producing task is recorded"):
        backend._reconstruct(b"\x01" * 16)


def test_unknown_kwarg_is_refused_at_plan():
    """A kwarg the cluster does not take raises TypeError naming it at
    ``plan()``, and the plan stays as it was."""
    with pytest.raises(TypeError, match="no_such_knob"):
        rc.plan("cluster", workers=1, no_such_knob=1)
    assert rc.active_backend().name == "sequential"


# --------------------------------------------------------------------------
# Holder death
# --------------------------------------------------------------------------

@pytest.mark.launcher
def test_pulled_result_survives_holder_death():
    """A result pulled to the driver before its holder dies stays
    available: DRIVER_STORE is a location too."""
    h = HarnessLauncher()
    rc.plan("cluster", hosts=2, launcher=h, **_FAST)
    backend = rc.active_backend()
    f = future(_big, 6.5)
    rv = _remote_value_of(f)
    v1 = f.value()
    pid = next(iter(_holder_pids(backend, rv.digest)))
    h.kill(h.by_pid(pid))
    _wait(lambda: not backend.locations(rv.digest), what="death detected")
    g = f.then(lambda a: float(a.sum()))
    assert g.value(timeout=WAIT) == float(_big(6.5).sum())
    assert np.array_equal(v1, _big(6.5))
    rc.shutdown()


@pytest.mark.launcher
def test_holder_death_loses_an_unpulled_result():
    """SIGKILL the sole holder of a result nobody pulled: the copy is
    lost, and a chain on it and its value() rebuild it from lineage, bit
    for bit the sequential backend's value."""
    rc.plan("sequential")
    want = future(_big, 5.75).value()
    h = HarnessLauncher()
    rc.plan("cluster", hosts=2, launcher=h, **_FAST)
    backend = rc.active_backend()
    f = future(_big, 5.75)
    rv = _remote_value_of(f)
    pid = next(iter(_holder_pids(backend, rv.digest)))
    h.kill(h.by_pid(pid))
    _wait(lambda: not backend.locations(rv.digest), what="death detected")
    assert f.then(lambda a: float(a.sum())).value(timeout=WAIT) \
        == float(want.sum())
    got = f.value()
    assert got.tobytes() == want.tobytes()
    assert backend.recovery_stats()["reconstructions"] == 1
    h.wait_launches(3)
    f2 = future(_big)
    assert f2.then(lambda a: float(a.sum())).value(timeout=WAIT) \
        == float(_big().sum())
    rc.shutdown()


# --------------------------------------------------------------------------
# Driver-side GC of worker-resident blobs
# --------------------------------------------------------------------------

def test_remote_value_gc_releases_worker_blobs():
    import gc
    backend = _plan(workers=2)
    f = future(_big, 41.25)
    rv = _remote_value_of(f)
    digest = rv.digest
    assert backend.locations(digest)
    del f, rv
    gc.collect()
    _wait(lambda: not backend.locations(digest), what="GC eviction")


def test_gc_spares_shared_digest_until_last_reference_dies():
    import gc
    backend = _plan(workers=2)
    f1 = future(_big, 42.75)
    f2 = future(_big, 42.75)
    rv1, rv2 = _remote_value_of(f1), _remote_value_of(f2)
    assert rv1.digest == rv2.digest
    digest = rv1.digest
    del f1, rv1
    gc.collect()
    time.sleep(0.3)
    assert backend.locations(digest)
    assert f2.then(lambda a: float(a.sum())).value() \
        == float(_big(42.75).sum())
    del f2, rv2
    gc.collect()
    _wait(lambda: not backend.locations(digest), what="GC eviction")


def test_stale_release_spares_a_copy_made_after_it(tmp_path, monkeypatch):
    """Fault F4: a released digest's ``evict`` that reaches the holder
    after the holder stored a new result with the same digest must not
    drop the new copy, which the driver records as held. The evict frame
    is held back at the driver until the new result is in (the order a
    busy worker's reader can see), then sent; the chain on the new
    result must still run on the holder without the 1 MiB from the
    driver's store."""
    import gc

    from repro_torch.core.backends import cluster as cluster_mod
    backend = _plan(workers=1)
    f1 = future(_big, 44.25)
    digest = _remote_value_of(f1).digest
    f1.value()                       # a copy in DRIVER_STORE to backfill from
    pidfile, release = str(tmp_path / "pid"), str(tmp_path / "go")

    def again(_p=pidfile, _r=release):
        import os as _os
        import time as _time
        with open(_p, "w") as fh:
            fh.write(str(_os.getpid()))
        while not _os.path.exists(_r):
            _time.sleep(0.005)
        return np.arange(1 << 17, dtype=np.float64) + 44.25

    f2 = future(again)
    _wait(lambda: os.path.exists(pidfile), what="second producer running")
    held, real = [], cluster_mod.send_frame

    def holding_evict(sock, frame, lock=None):
        if frame[0] == "evict" and frame[1] == digest:
            held.append((sock, frame, lock))
            return 0
        return real(sock, frame, lock)

    monkeypatch.setattr(cluster_mod, "send_frame", holding_evict)
    del f1
    gc.collect()
    _wait(lambda: held, what="the release's evict frame")
    open(release, "w").close()
    rv2 = _remote_value_of(f2)
    assert rv2.digest == digest and backend.locations(digest)
    for sock, frame, lock in held:   # the late evict reaches the worker
        real(sock, frame, lock)
    transport.reset_wire_stats()
    chain = f2.then(lambda a: (os.getpid(), float(a.sum())))
    pid, total = chain.value(timeout=WAIT)
    wire = transport.wire_stats()
    assert total == float(_big(44.25).sum())
    assert pid == int(open(pidfile).read())
    assert wire["bytes_sent"] < _N * 8 // 10, wire
    # the new copy's own release empties the driver's report counts
    del f2, rv2, chain
    gc.collect()
    _wait(lambda: not backend.locations(digest), what="the second release")
    assert all(not w.reports for w in list(backend._all))


def test_report_counts_empty_after_the_release_in_the_f4_order():
    """The holder's side of fault F4, in the order above: a result stored
    and reported, the same digest stored and reported again, then the
    first release's evict (n=1) keeps the copy and one count, and the
    second release's evict (n=1) drops it and leaves the map empty."""
    from repro_torch.core.backends.blobstore import BlobStore
    from repro_torch.core.backends.cluster_worker import HeldReports
    store = BlobStore()
    reports = HeldReports(store)
    digest, blob = b"d" * 16, b"x" * 64
    reports.put(digest, blob)
    reports.put(digest, blob)
    assert not reports.evict(digest, 1)
    assert digest in store and reports.counts == {digest: 1}
    assert reports.evict(digest, 1)
    assert digest not in store and reports.counts == {}
    reports.count(digest)                     # a stale count, no copy
    assert not reports.evict(digest, 1) and reports.counts == {}


def test_chain_on_gc_candidate_still_resolves():
    import gc
    _plan(workers=2)
    f = future(_big, 43.5)
    g = f.then(lambda a: float(a.sum()))
    del f
    gc.collect()
    assert g.value() == float(_big(43.5).sum())


# --------------------------------------------------------------------------
# Zero-copy OOB frames (tests/test_payload_cache.py:322-388)
# --------------------------------------------------------------------------

def test_array_frames_ship_out_of_band():
    arr = np.random.default_rng(5).standard_normal(1 << 15) \
        .astype(np.float32)
    payload = ("result", 9, arr)
    blob = transport.encode_frame(payload)
    assert blob[8] == 2
    assert len(blob) < arr.nbytes + 4096

    a, b = socket.socketpair()
    transport.send_frame(a, payload)
    got = transport.recv_frame(b)
    assert got[0] == "result" and got[1] == 9
    np.testing.assert_array_equal(got[2], arr)

    transport.send_frame(a, payload)
    reader = transport.FrameReader(b)
    frames = []
    while not frames:
        frames += reader.feed()
    np.testing.assert_array_equal(frames[0][2], arr)
    a.close()
    b.close()


def test_empty_array_frame_round_trips():
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    payload = ("result", 3, np.empty((0,), np.float32),
               np.arange(4, dtype=np.float32))
    transport.send_frame(a, payload)
    got = transport.recv_frame(b)
    assert got[0] == "result" and got[1] == 3
    assert got[2].size == 0 and got[2].dtype == np.float32
    np.testing.assert_array_equal(got[3], np.arange(4, dtype=np.float32))
    a.close()
    b.close()


def test_frame_reader_bulk_path_reassembles_dripped_large_frame():
    a, b = socket.socketpair()
    body = os.urandom(300_000)
    blob = transport.encode_frame(("task", 1, body))
    reader = transport.FrameReader(b)
    out = []
    for i in range(0, len(blob), 8192):
        a.sendall(blob[i:i + 8192])
        out += reader.feed()
    assert out == [("task", 1, body)]
    assert reader._bulk is None and not reader._buf
    a.close()
    b.close()


def test_put_frame_keeps_a_large_payload_out_of_band_and_unzipped():
    """A put frame's payload blob rides as a PickleBuffer: out-of-band,
    never zlib'd a second time by the frame layer."""
    blob = transport.encode_payload({"w": "x" * (1 << 18)}, int8=False)
    frame = transport.encode_frame(("put", b"d" * 16,
                                    pickle.PickleBuffer(blob)))
    assert frame[8] == 2
    assert frame.endswith(blob)
