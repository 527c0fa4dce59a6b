"""The port's multi-tenant serving tier (``repro_torch.core.serving``): a
mirror of the 11 rows of tests/test_serving.py, and the start-time fair
queuing of the cluster's tenant scheduler held against the JAX package's:
both schedulers' picking logic, driven without sockets over the same
backlogged queues and weights, pick the same sequence of tenants.

Each row serves in this process over a cluster whose workers are real
processes. Wall-clock bounds are loose (ROADMAP note R1): the
``max_in_flight`` row holds the cap by the largest in-flight count it
observes and the small tenant's precedence by completion order, with the
capped tenant's tasks parked on a marker file; the fair-share row parks
the single worker until every queue is full.
"""

import itertools
import os
import threading
import time
import types

import pytest
from _torch_cluster_harness import ephemeral_tls

import repro_torch.core as rc
from repro_torch.core import future, gather, state, value
from repro_torch.core.backends.base import TaskSpec
from repro_torch.core.errors import ChannelError
from repro_torch.core.globals_capture import dumps_robust, ship_function
from repro_torch.core.serving import ServingClientBackend, serve

pytestmark = pytest.mark.serving

#: seconds any one wait may take
WAIT = 60.0

_ids = itertools.count(1)


@pytest.fixture(autouse=True)
def _reset_port():
    rc.plan("sequential")
    rc.state.reset()
    yield
    rc.plan("sequential")
    rc.state.reset()


@pytest.fixture(scope="module", autouse=True)
def _release_pools():
    yield
    rc.shutdown()


def _task(fn):
    """The shipped TaskSpec future.py would build, for rows that drive a
    ServingClientBackend directly (two sessions in one process: plan() is
    global, so a second tenant cannot come from plan())."""
    sources: dict = {}
    shipped = dumps_robust(
        {"fn": ship_function(fn, {}, (), ref_sink=sources),
         "args": (), "kwargs": {}, "capture_stdout": True,
         "capture_conditions": True, "seed_declared": False},
        ref_sink=sources)
    return TaskSpec(task_id=next(_ids), fn=None, shipped=shipped,
                    payload_sources=sources)


def _value(client, handle):
    run = client.collect(handle)
    if run.error is not None:
        raise run.error
    return run.value


def _wait(pred, timeout=WAIT, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise TimeoutError(f"{what} not reached within {timeout}s")


def _make_parker(marker, release):
    """Task body that marks its start and parks until ``release``."""
    def body(_m=marker, _r=release):
        import os as _os
        import time as _time
        open(_m, "w").close()
        while not _os.path.exists(_r):
            _time.sleep(0.005)
        return "slow"
    return body


# --------------------------------------------------------------------------
# Transport security: refused before any frame is decoded, never a hang
# --------------------------------------------------------------------------

def test_wrong_token_rejected_fast_and_server_survives():
    with serve({"workers": 1}, tokens={"alice": "s1"}) as srv:
        host, port = srv.address
        t0 = time.monotonic()
        with pytest.raises(ChannelError):
            ServingClientBackend(addr=(host, port), token="WRONG")
        assert time.monotonic() - t0 < 30.0
        # the listener shrugged it off: a good credential still works
        c = ServingClientBackend(addr=(host, port), token="s1")
        assert _value(c, c.submit(_task(lambda: 7))) == 7
        c.shutdown()


def test_plaintext_dial_to_tls_listener_rejected():
    with serve({"workers": 1}, tokens={"a": "s"},
               tls=ephemeral_tls()) as srv:
        host, port = srv.address
        t0 = time.monotonic()
        with pytest.raises(ChannelError):
            ServingClientBackend(addr=(host, port), token="s")  # no TLS
        assert time.monotonic() - t0 < 30.0
        ca = srv.tls.certfile
        c = ServingClientBackend(addr=(host, port), token="s", tls_ca=ca)
        assert _value(c, c.submit(_task(lambda: 8))) == 8
        c.shutdown()


def test_unauthenticated_raw_socket_cannot_submit():
    """A raw connection that skips the handshake and speaks frames is
    hung up on before the frame decoder: it can neither submit tasks nor
    pull state or blobs."""
    import socket as socket_mod

    from repro_torch.core.backends.transport import recv_frame, send_frame
    with serve({"workers": 1}, tokens={"a": "s"}) as srv:
        raw = socket_mod.create_connection(srv.address, timeout=5)
        raw.settimeout(30.0)
        with pytest.raises((ChannelError, EOFError, OSError)):
            # first bytes are not the AUTH magic -> listener hangs up
            send_frame(raw, ("sub", 1, b"evil", [], {}, {}))
            recv_frame(raw)
        raw.close()


def test_cluster_listener_rejects_tokenless_worker_dial():
    """The inner cluster's own worker listener is behind the same
    preamble: a dial with a bad token is refused, so no one can skip the
    serving tier and register as a worker to receive task pickles."""
    from repro_torch.core.backends.cluster_worker import run_worker
    with serve({"workers": 1, "token": "wsecret"},
               tokens={"a": "s"}) as srv:
        caddr = srv.inner.address
        with pytest.raises((ChannelError, EOFError, OSError)):
            run_worker(caddr[0], caddr[1], token="BAD")


# --------------------------------------------------------------------------
# The long-lived server: sessions, the full API, TTL
# --------------------------------------------------------------------------

def test_plan_serving_full_future_and_state_api():
    with serve({"workers": 2}, tokens={"alice": "s1"}) as srv:
        host, port = srv.address
        rc.plan("serving", addr=f"{host}:{port}", token="s1")
        xs = [future(lambda i=i: i * i) for i in range(6)]
        assert value(gather(xs)) == [i * i for i in range(6)]
        # evaluation errors come back as themselves
        with pytest.raises(ZeroDivisionError):
            value(future(lambda: 1 // 0))
        # driver-side calls and task-body calls reach the same
        # tenant-scoped namespace on the server
        state.put("cfg", {"lr": 0.1})
        n, _ = state.add("steps", 3)
        assert n == 3

        def body():
            from repro_torch.core import state as st
            st.add("steps", 1)
            return st.get("cfg")["lr"]

        assert value(future(body)) == 0.1
        assert state.get("steps") == 4
        be = rc.planning.active_backend()
        stats = be.session_stats()
        assert stats["tenant"] == "alice"
        assert stats["tenant_stats"]["completed"] >= 8
        rc.plan("sequential")
        rc.shutdown()


def test_session_ttl_expiry_is_a_clean_error_not_a_hang():
    with serve({"workers": 1}, tokens={"t": "x"}, session_ttl=0.8) as srv:
        c = ServingClientBackend(addr=srv.address, token="x")
        assert _value(c, c.submit(_task(lambda: 1))) == 1
        # the server's expired frame (or the EOF behind it) has landed
        _wait(lambda: c._down is not None, what="the session expired")
        t0 = time.monotonic()
        with pytest.raises(ChannelError, match="expired"):
            c.free_slots()
        with pytest.raises(ChannelError, match="expired"):
            c.submit(_task(lambda: 2))
        # the state API's error contract is StateError; the expired-session
        # ChannelError rides inside it, still at once and still clear
        with pytest.raises((ChannelError, state.StateError), match="expired"):
            c._state.get("anything")
        assert time.monotonic() - t0 < 30.0
        c.shutdown()


# --------------------------------------------------------------------------
# Tenancy: isolation, fair-share caps, attribution
# --------------------------------------------------------------------------

def test_two_tenant_sessions_state_isolation_and_attribution():
    with serve({"workers": 2},
               tokens={"alice": "s1", "bob": "s2"},
               tenants={"alice": {"weight": 3.0},
                        "bob": {"weight": 1.0}}) as srv:
        a = ServingClientBackend(addr=srv.address, token="s1")
        b = ServingClientBackend(addr=srv.address, token="s2")
        assert (a.tenant, b.tenant) == ("alice", "bob")
        ha = [a.submit(_task(lambda i=i: ("a", i))) for i in range(5)]
        hb = [b.submit(_task(lambda i=i: ("b", i))) for i in range(3)]
        assert [_value(a, h) for h in ha] == [("a", i) for i in range(5)]
        assert [_value(b, h) for h in hb] == [("b", i) for i in range(3)]
        # same key, different namespaces
        a._state.put("k", "alice-data")
        b._state.put("k", "bob-data")
        assert a._state.get("k") == "alice-data"
        assert b._state.get("k") == "bob-data"
        # attribution: the completed count is bumped by a done-callback
        # that may run after the client saw the result
        _wait(lambda: a.session_stats()["tenant_stats"]["completed"] == 5
              and b.session_stats()["tenant_stats"]["completed"] == 3,
              what="every completion attributed")
        sa = a.session_stats()
        assert sa["tenant_stats"]["bytes_sent"] > 0
        assert "by_tenant" in sa["recovery"]
        a.shutdown()
        b.shutdown()


def test_max_in_flight_cap_keeps_a_worker_free_for_the_other_tenant(
        tmp_path):
    """Tenant ``hog`` is capped at one task in flight: its 4 tasks, each
    parked until released, hold one worker at most, so ``small``'s task
    takes the other and completes before any of hog's."""
    release = str(tmp_path / "go")
    with serve({"workers": 2},
               tokens={"hog": "h", "small": "s"},
               tenants={"hog": {"max_in_flight": 1},
                        "small": {}}) as srv:
        hog = ServingClientBackend(addr=srv.address, token="h")
        small = ServingClientBackend(addr=srv.address, token="s")
        order: list = []                  # list.append is atomic
        peak = [0]
        stop = threading.Event()

        def watch():
            while not stop.is_set():
                peak[0] = max(peak[0], srv.inner.tenant_stats().get(
                    "hog", {}).get("in_flight", 0))
                time.sleep(0.002)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        hh = []
        for i in range(4):
            h = hog.submit(_task(_make_parker(str(tmp_path / f"hog{i}"),
                                              release)))
            hog.add_done_callback(h, lambda _h: order.append("hog"))
            hh.append(h)
        _wait(lambda: any(os.path.exists(tmp_path / f"hog{i}")
                          for i in range(4)), what="a hog task started")
        hs = small.submit(_task(lambda: "quick"))
        small.add_done_callback(hs, lambda _h: order.append("small"))
        assert _value(small, hs) == "quick"
        started = sum(os.path.exists(tmp_path / f"hog{i}") for i in range(4))
        open(release, "w").close()
        assert [_value(hog, h) for h in hh] == ["slow"] * 4
        stop.set()
        watcher.join()
        assert started == 1               # the cap held while parked
        assert peak[0] == 1, peak[0]
        assert order[0] == "small", order
        _wait(lambda: hog.session_stats()["tenant_stats"]["completed"] == 4,
              what="hog's completions attributed")
        hog.shutdown()
        small.shutdown()


# --------------------------------------------------------------------------
# The warm pool: credentials are key material
# --------------------------------------------------------------------------

def test_warm_pool_key_handles_dict_kwargs_and_credentials(monkeypatch):
    from repro_torch.core import planning
    monkeypatch.delenv("REPRO_CLUSTER_TOKEN", raising=False)
    # dict-valued kwargs (tenants=...) must be poolable, not a TypeError
    rc.plan("cluster", workers=1, tenants={"a": {"weight": 2.0}})
    b1 = planning.active_backend()
    assert value(future(lambda: 1)) == 1
    rc.plan("threads")
    rc.plan("cluster", workers=1, tenants={"a": {"weight": 2.0}})
    assert planning.active_backend() is b1      # same spec -> reattach
    # a credential change is an identity change: same kwargs, new token
    # must NOT reattach to the unsecured warm pool
    rc.plan("threads")
    monkeypatch.setenv("REPRO_CLUSTER_TOKEN", "rotated-secret")
    rc.plan("cluster", workers=1, tenants={"a": {"weight": 2.0}})
    b2 = planning.active_backend()
    assert b2 is not b1
    assert value(future(lambda: 2)) == 2
    rc.shutdown()


def test_warm_pool_key_hashes_tls_config_material():
    from repro_torch.core import planning
    tls = ephemeral_tls()
    k1 = planning._backend_key(
        planning.spec("cluster", workers=1, token="t", tls=tls),
        (planning.spec("cluster", workers=1, token="t", tls=tls),))
    hash(k1)                                    # must be hashable
    k2 = planning._backend_key(
        planning.spec("cluster", workers=1, token="other", tls=tls),
        (planning.spec("cluster", workers=1, token="other", tls=tls),))
    assert k1 != k2                             # token is key material
    # and the raw token never appears in the key (it's hashed)
    assert "other" not in repr(k2)
    # a serving client's token and CA pin are key material too
    k3 = planning._backend_key(
        planning.spec("serving", addr="h:1", token="s", tls_ca="ca.pem"),
        (planning.spec("serving", addr="h:1", token="s", tls_ca="ca.pem"),))
    k4 = planning._backend_key(
        planning.spec("serving", addr="h:1", token="s2", tls_ca="ca.pem"),
        (planning.spec("serving", addr="h:1", token="s2", tls_ca="ca.pem"),))
    assert k3 != k4 and "s2" not in repr(k4)


# --------------------------------------------------------------------------
# Start-time fair queuing
# --------------------------------------------------------------------------

def test_weighted_fair_share_interleaves_3_to_1(tmp_path):
    """Start-time fair queuing end to end through the serving tier: one
    worker, parked by a third tenant until both queues hold 12 tasks;
    then the weight-3 tenant gets 3 of every 4 dispatches, and the light
    tenant is never starved."""
    release, parked = str(tmp_path / "go"), str(tmp_path / "parked")
    with serve({"workers": 1},
               tokens={"heavy": "h", "light": "l", "ops": "o"},
               tenants={"heavy": {"weight": 3.0},
                        "light": {"weight": 1.0}}) as srv:
        heavy = ServingClientBackend(addr=srv.address, token="h")
        light = ServingClientBackend(addr=srv.address, token="l")
        ops = ServingClientBackend(addr=srv.address, token="o")
        # the scheduler's picks, in dispatch order (completions reach the
        # two sessions through two writers, so their order may interleave)
        picks: list = []
        real_dispatch = srv.inner._dispatch

        def recording(task, worker, handle=None):
            picks.append(task.tenant)
            return real_dispatch(task, worker, handle=handle)

        srv.inner._dispatch = recording
        hp = ops.submit(_task(_make_parker(parked, release)))
        _wait(lambda: os.path.exists(parked), what="the worker parked")
        handles = []
        for client in (heavy, light):
            for _ in range(12):
                handles.append((client, client.submit(_task(lambda: True))))
        _wait(lambda: all(srv.inner.tenant_stats()[n]["queued"] == 12
                          for n in ("heavy", "light")),
              what="both queues backlogged")
        open(release, "w").close()
        assert _value(ops, hp) == "slow"
        for client, h in handles:
            assert _value(client, h) is True
        assert picks[0] == "ops" and len(picks) == 25, picks
        window = picks[1:13]
        assert window.count("heavy") == 9, picks
        assert "light" in window[:4], picks
        for c in (heavy, light, ops):
            c.shutdown()


def _sfq_picks(pkg_cluster, weights: dict, backlog: int) -> list:
    """The tenants ``pkg_cluster.ClusterBackend``'s fair-share dispatcher
    picks, in order, for ``backlog`` queued tasks a tenant: no sockets
    and no workers; one stand-in idle worker whose dispatch records the
    tenant, completes the task and goes back to the idle list."""
    backend = pkg_cluster.ClusterBackend(workers=1, launcher="external",
                                         tenants=weights)
    picks: list = []
    done = threading.Event()
    total = backlog * len(weights)
    worker = types.SimpleNamespace(wid=0, sock=object())

    def dispatch(task, w, handle=None):
        picks.append(task.tenant)
        handle.error = ChannelError("recorded")
        backend._complete(handle)
        with backend._pool_cv:
            backend._idle.append(w)
            backend._pool_cv.notify_all()
        if len(picks) == total:
            done.set()
        return handle

    backend._dispatch = dispatch
    try:
        tid = itertools.count(1)
        for _ in range(backlog):
            for name in weights:
                backend.submit_queued(pkg_cluster.TaskSpec(
                    task_id=next(tid), fn=None, tenant=name))
        with backend._pool_cv:
            backend._idle.append(worker)
            backend._pool_cv.notify_all()
        assert done.wait(WAIT)
        return picks
    finally:
        backend.shutdown()


@pytest.mark.parametrize("weights", [
    {"heavy": 3.0, "light": 1.0},
    {"a": 1.0, "b": 1.0},
    {"x": 2.0, "y": 1.0, "z": 0.5},
])
def test_fair_share_picks_are_the_references(weights):
    from repro.core.backends import cluster as ref_cluster

    from repro_torch.core.backends import cluster as port_cluster
    ref = _sfq_picks(ref_cluster, weights, backlog=8)
    port = _sfq_picks(port_cluster, weights, backlog=8)
    assert port == ref
    # over the first full round each tenant's share is its weight's
    n = int(sum(weights.values()) * 2)
    head = port[:n]
    for name, w in weights.items():
        assert head.count(name) == int(w * 2), (name, head)


# --------------------------------------------------------------------------
# Session frames: the reference's bytes where they hold plain objects
# --------------------------------------------------------------------------

@pytest.mark.parametrize("frame", [
    ("welcome", {"tenant": "alice", "session": 1, "workers": 2,
                 "session_ttl": None}),
    ("sub", 3, b"shipped" * 100, [b"\x01" * 16],
     {b"\x01" * 16: b"blob" * 50},
     {"label": "future-3", "capture_stdout": True,
      "capture_conditions": True, "seed_declared": False}),
    ("free", 4), ("free_rep", 4, 2), ("stats", 5), ("cancel", 3),
    ("state", 6, "get", ("k", 0)), ("bye",), ("expired",),
], ids=lambda f: f[0])
def test_session_frames_are_the_references_byte_for_byte(frame):
    from repro.core.backends import transport as ref_transport

    from repro_torch.core.backends import transport as port_transport
    assert port_transport.encode_frame(frame) \
        == ref_transport.encode_frame(frame)
