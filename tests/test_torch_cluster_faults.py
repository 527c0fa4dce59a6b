"""Faults and the launcher subsystem on the port's cluster: the cluster
rows of tests/test_faults.py (harness-injected kills, pre-hello death,
relaunch backoff, reaping, idle exit, the ssh and command launchers), of
tests/test_stream.py (:111, :258), of tests/test_continuations.py (a
cross-backend wait and gather, cancelled losers, infrastructure errors to
``recover``) and of tests/test_conformance.py (worker isolation, death
in the matrix).

Faults are injected by ``tests/_torch_cluster_harness.py``, the port's
copy of the reference's harness. Wall-clock bounds are loose (ROADMAP
note R1).
"""

import os
import pickle
import signal
import time

import pytest
from _torch_cluster_harness import HarnessLauncher

import repro_torch.core as rc
from repro_torch.core import (first, future, future_map, gather, stream,
                              wait_any)
from repro_torch.core.backends.base import BACKEND_REGISTRY
from repro_torch.core.backends.cluster import ClusterBackend
from repro_torch.core.backends.launchers import (CommandLauncher, Launcher,
                                                 LocalLauncher, SSHLauncher,
                                                 resolve_launcher)

#: fast-heal knobs so the fault tests run in seconds, not default backoffs
_FAST = dict(heartbeat_interval=0.1, heartbeat_timeout=3.0,
             relaunch_backoff=0.05, relaunch_backoff_cap=0.2)

#: seconds any one wait on a worker may take
WAIT = 60.0


def value(f, timeout: float = WAIT):
    return rc.value(f, timeout=timeout)


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


def _wait_dead(wp, timeout=10.0):
    deadline = time.monotonic() + timeout
    while wp.poll() is None and time.monotonic() < deadline:
        time.sleep(0.01)
    return wp.poll()


# --------------------------------------------------------------------------
# tests/test_faults.py: the launcher subsystem under injected faults
# --------------------------------------------------------------------------

@pytest.mark.launcher
def test_harness_kill_mid_map_relaunches_and_retries(tmp_path):
    h = HarnessLauncher()
    rc.plan("cluster", hosts=2, launcher=h, **_FAST)
    marker = str(tmp_path / "victim-pid")
    backend = rc.active_backend()
    watcher = h.kill_on_pidfile(marker)

    def elem(x, _marker=marker):
        import os as _os
        import time as _time
        if x == 3 and not _os.path.exists(_marker):
            with open(_marker, "w") as fh:
                fh.write(str(_os.getpid()))
                fh.flush()
            while True:                  # stay mid-task until the kill lands
                _time.sleep(0.05)
        return x * 2

    out = future_map(elem, list(range(6)), chunks=6, retries=2)
    assert out == [0, 2, 4, 6, 8, 10]
    watcher.join(timeout=10)
    assert watcher.killed is not None
    assert _wait_dead(watcher.killed) is not None
    h.wait_launches(3, timeout=30)
    assert backend._relaunch_log
    rc.shutdown()


@pytest.mark.launcher
def test_worker_dead_before_hello_surfaces_stderr():
    boom = CommandLauncher(template=(
        "{python} -c \"import sys; "
        "sys.stderr.write('boom-before-hello'); sys.exit(7)\""))
    with pytest.raises(rc.ChannelError, match="boom-before-hello"):
        ClusterBackend(hosts=1, launcher=boom, connect_timeout=15, **_FAST)


@pytest.mark.launcher
def test_relaunch_backoff_cap_is_honored():
    h = HarnessLauncher()
    backend = ClusterBackend(hosts=1, launcher=h,
                             heartbeat_interval=0.1, heartbeat_timeout=3.0,
                             relaunch_backoff=0.05, relaunch_backoff_cap=0.2,
                             relaunch_reset_after=3600.0)
    kills = 5
    try:
        for i in range(kills):
            procs = h.wait_launches(i + 1, timeout=WAIT)
            backend.wait_for_workers(1, timeout=WAIT)
            h.kill(procs[-1])
            deadline = time.time() + 30
            while len(backend._relaunch_log) < i + 1:
                assert time.time() < deadline, "relaunch never scheduled"
                time.sleep(0.01)
        delays = list(backend._relaunch_log)
        assert len(delays) == kills
        assert delays == sorted(delays)
        assert max(delays) <= 0.2 + 1e-9
        assert delays[-1] == pytest.approx(0.2)
        assert delays[0] == pytest.approx(0.05)
    finally:
        backend.shutdown()


@pytest.mark.launcher
def test_shutdown_reaps_all_launched_workers():
    h = HarnessLauncher()
    rc.plan("cluster", hosts=2, launcher=h, **_FAST)
    assert future_map(lambda x: x + 1, [1, 2, 3]) == [2, 3, 4]
    assert len(h.alive()) == 2
    rc.shutdown()
    for wp in h.procs:
        assert wp.poll() is not None, f"orphaned: {wp.describe()}"


@pytest.mark.launcher
def test_max_idle_does_not_kill_running_task():
    backend = ClusterBackend(
        hosts=1, launcher=LocalLauncher(worker_args=("--max-idle-s", "1")),
        **_FAST)
    try:
        f = future(lambda: (time.sleep(2.5), "survived")[1], backend=backend)
        assert value(f) == "survived"
    finally:
        backend.shutdown()


@pytest.mark.launcher
def test_relaunch_retries_through_transient_launch_failure():
    class Flaky(Launcher):
        local_only = True

        def __init__(self):
            self.ok = LocalLauncher()
            self.boom = CommandLauncher(
                "{python} -c \"import sys; sys.exit(3)\"")
            self.calls = 0

        def launch(self, host, driver_addr, *, tag=None):
            self.calls += 1
            inner = self.boom if self.calls in (2, 3) else self.ok
            return inner.launch(host, driver_addr, tag=tag)

        def describe(self):
            return "flaky"

    fl = Flaky()
    backend = ClusterBackend(hosts=1, launcher=fl,
                             heartbeat_interval=0.1, heartbeat_timeout=3.0,
                             relaunch_backoff=0.05, relaunch_backoff_cap=0.2,
                             relaunch_reset_after=3600.0)
    try:
        os.kill(backend.worker_pids()[0], signal.SIGKILL)
        deadline = time.time() + WAIT
        while True:
            try:
                assert value(future(lambda: "healed", backend=backend)) \
                    == "healed"
                break
            except rc.WorkerDiedError:
                assert time.time() < deadline, "pool never healed"
        assert fl.calls >= 4
        with backend._pool_cv:
            assert backend._capacity == 1    # the slot was never burned
    finally:
        backend.shutdown()


@pytest.mark.launcher
def test_idle_exit_retires_instead_of_relaunch_churn():
    h = HarnessLauncher(LocalLauncher(worker_args=("--max-idle-s", "0.5")))
    backend = ClusterBackend(hosts=1, launcher=h, **_FAST)
    try:
        assert value(future(lambda: "used once", backend=backend)) \
            == "used once"
        wp = h.procs[0]
        assert _wait_dead(wp, timeout=30) is not None
        time.sleep(1.0)                      # would-be relaunch window
        assert h.launches == 1               # no churn
        with backend._pool_cv:
            assert backend._capacity == 0    # slot retired, not respawned
        backend.resize(1)
        backend.wait_for_workers(1, timeout=WAIT)
        assert h.launches == 2
    finally:
        backend.shutdown()


@pytest.mark.launcher
def test_ssh_launcher_command_shape():
    plain = SSHLauncher(user="u", python="python3.11",
                        pythonpath="/opt/repro/src",
                        env=(("OMP_NUM_THREADS", "1"),))
    cmd = plain.command("nodeA", ("driver.example", 45000), tag="t-1")
    assert cmd[0] == "ssh" and "BatchMode=yes" in cmd
    assert cmd[-2] == "u@nodeA"
    remote = cmd[-1]
    assert "PYTHONPATH=/opt/repro/src" in remote
    assert "OMP_NUM_THREADS=1" in remote
    assert ("-m repro_torch.core.backends.cluster_worker "
            "driver.example:45000") in remote
    assert "--tag t-1" in remote
    assert "-R" not in cmd

    tun = SSHLauncher(reverse_tunnel=True)
    cmd = tun.command("nodeB", ("driver.example", 45000), tag="t-2")
    assert cmd[cmd.index("-R") + 1] == "45000:127.0.0.1:45000"
    assert "cluster_worker 127.0.0.1:45000" in cmd[-1]


@pytest.mark.launcher
def test_resolve_launcher_defaults_and_templates():
    assert isinstance(resolve_launcher(None, None), LocalLauncher)
    assert isinstance(resolve_launcher(None, 4), LocalLauncher)
    assert isinstance(resolve_launcher(None, ("a", "b")), SSHLauncher)
    assert resolve_launcher("external", 2) is None
    tmpl = resolve_launcher("srun {python} -m "
                            "repro_torch.core.backends.cluster_worker "
                            "{driver}")
    assert isinstance(tmpl, CommandLauncher)
    split = resolve_launcher("x {driver_host} {driver_port}")
    assert isinstance(split, CommandLauncher)
    with pytest.raises(ValueError):
        resolve_launcher("sssh")
    cl = CommandLauncher("bash -c true {tag} --x={nope} ${HOME} {driver}")
    wp = cl.launch("127.0.0.1", ("127.0.0.1", 9), tag="t9")
    assert "--x={nope}" in wp.cmd and "${HOME}" in wp.cmd
    assert "127.0.0.1:9" in wp.cmd and "t9" in wp.cmd
    wp.wait(10)
    s = SSHLauncher(reverse_tunnel=True)
    assert hash(s) == hash(pickle.loads(pickle.dumps(s)))
    assert {s: 1}[SSHLauncher(reverse_tunnel=True)] == 1


@pytest.mark.launcher
def test_local_launcher_worker_env_names_the_port():
    """The launched worker runs the port's module with the checkout's
    ``src`` first on its path and single-threaded numerics."""
    from repro_torch.core.backends import launchers
    env = LocalLauncher()._worker_env((("EXTRA", "1"),))
    src = env["PYTHONPATH"].split(os.pathsep)[0]
    assert os.path.isdir(os.path.join(src, "repro_torch"))
    assert env["EXTRA"] == "1" and "OMP_NUM_THREADS" in env
    assert launchers.WORKER_MODULE == \
        "repro_torch.core.backends.cluster_worker"


@pytest.mark.launcher
def test_detaching_bootstrap_pairs_tagless_worker():
    tmpl = ("bash -c \"{python} -m repro_torch.core.backends.cluster_worker "
            "{driver} >/dev/null 2>&1 & exit 0\"")
    backend = ClusterBackend(hosts=1, launcher=CommandLauncher(tmpl),
                             connect_timeout=WAIT, **_FAST)
    try:
        assert value(future(lambda: 40 + 2, backend=backend)) == 42
        with backend._pool_cv:
            owned = [w.proc for w in backend._all if w.ready]
        assert owned and all(wp is not None for wp in owned)
        assert owned[0].poll() == 0          # the bootstrap itself detached
    finally:
        backend.shutdown()


@pytest.mark.launcher
def test_harness_partition_is_worker_death():
    h = HarnessLauncher()
    rc.plan("cluster", hosts=1, launcher=h, **_FAST)
    backend = rc.active_backend()
    f = future(lambda: time.sleep(60))
    wp = h.busy_proc(backend, timeout=10)
    assert h.partition(backend, wp)
    with pytest.raises(rc.WorkerDiedError):
        value(f)
    assert value(future(lambda: "healed")) == "healed"
    rc.shutdown()


@pytest.mark.launcher
def test_tls_and_token_cluster_resolves_and_refuses_a_stranger():
    """The full preamble on the port: TLS on the listener, the worker dials
    and the peer servers, plus the token; a plaintext dialer with no token
    is dropped before any frame is decoded. Needs the ``openssl``
    binary."""
    import socket

    from _torch_cluster_harness import ephemeral_tls
    from repro_torch.core.backends import transport
    rc.plan("cluster", hosts=2, token="tls-secret", tls=ephemeral_tls())
    backend = rc.active_backend()
    assert value(future(lambda: os.getpid())) in backend.worker_pids()
    before = transport.wire_stats()["frames_recv"]
    with socket.create_connection(backend.address, timeout=10) as s:
        s.settimeout(15)
        s.sendall(transport.encode_frame(("hello", {"pid": 1})))
        try:
            assert s.recv(1) == b""          # closed on us
        except OSError:
            pass
    assert len(backend.worker_pids()) == 2
    assert transport.wire_stats()["frames_recv"] - before < 50
    rc.shutdown()


# --------------------------------------------------------------------------
# tests/test_stream.py (:111, :258)
# --------------------------------------------------------------------------

def test_admission_never_exceeds_cluster_idle_set():
    rc.plan("cluster", workers=2)
    backend = rc.active_backend()
    backend.wait_for_workers(2, timeout=WAIT)
    assert backend.free_slots() == 2

    def body(v):
        import time as _t
        _t.sleep(0.02)
        return v + 1

    s = stream(range(30), max_in_flight=16)
    assert s.map(body, chunk=3).collect() == [v + 1 for v in range(30)]
    assert s.stats["peak_in_flight"] <= 4
    assert backend.free_slots() == 2


@pytest.mark.launcher
def test_mid_stream_worker_kill_relaunch_and_retry(tmp_path):
    h = HarnessLauncher()
    rc.plan("cluster", hosts=2, launcher=h, **_FAST)
    marker = str(tmp_path / "victim-pid")
    watcher = h.kill_on_pidfile(marker)

    def elem(x, _marker=marker):
        import os as _os
        import time as _time
        if x == 3 and not _os.path.exists(_marker):
            with open(_marker, "w") as fh:
                fh.write(str(_os.getpid()))
                fh.flush()
            while True:
                _time.sleep(0.05)
        return x * 2

    s = stream(range(6), max_in_flight=2)
    assert s.map(elem, retries=2).collect() == [0, 2, 4, 6, 8, 10]
    assert s.stats["retried"] >= 1
    watcher.join(timeout=10)
    assert watcher.killed is not None
    assert _wait_dead(watcher.killed) is not None
    rc.shutdown()


# --------------------------------------------------------------------------
# tests/test_continuations.py: the cluster rows
# --------------------------------------------------------------------------

def test_wait_any_two_backends_single_event_wait():
    tb = BACKEND_REGISTRY["threads"](workers=1)
    cb = BACKEND_REGISTRY["cluster"](workers=1)
    try:
        slow = future(lambda: time.sleep(5.0) or "slow", backend=cb)
        fast = future(lambda: time.sleep(0.3) or "fast", backend=tb)
        t0 = time.monotonic()
        ready = wait_any([slow, fast])
        assert fast in ready and slow not in ready
        assert time.monotonic() - t0 < 4.0   # woke on the fast one
        slow.cancel()
    finally:
        cb.shutdown()
        tb.shutdown()


def test_gather_spans_backends():
    tb = BACKEND_REGISTRY["threads"](workers=1)
    cb = BACKEND_REGISTRY["cluster"](workers=1)
    try:
        g = gather([future(lambda: "t", backend=tb),
                    future(lambda: "c", backend=cb)])
        assert value(g) == ["t", "c"]
    finally:
        cb.shutdown()
        tb.shutdown()


def test_first_cancels_losers_cluster():
    rc.plan("cluster", workers=2)
    rc.active_backend().wait_for_workers(2, timeout=WAIT)
    fast = future(lambda: "winner")
    slow = future(lambda: time.sleep(60) or "loser")
    assert value(first([fast, slow])) == "winner"
    t0 = time.monotonic()
    with pytest.raises(rc.FutureError):
        value(slow)
    assert time.monotonic() - t0 < 30


def test_recover_catches_infrastructure_errors():
    rc.plan("cluster", workers=1)
    f = future(lambda: os._exit(37)).recover(lambda exc: type(exc).__name__)
    assert value(f) == "WorkerDiedError"


# --------------------------------------------------------------------------
# tests/test_conformance.py: worker isolation, death in the matrix
# --------------------------------------------------------------------------

def test_worker_isolation():
    """Cluster workers are other interpreters, and neither ``jax`` nor
    ``repro`` is in their ``sys.modules``."""
    rc.plan("cluster", workers=1)
    pid, mods = value(future(lambda: (os.getpid(), sorted(
        m for m in __import__("sys").modules
        if m.split(".")[0] in ("jax", "repro")))))
    assert pid != os.getpid() and mods == []


def test_cluster_worker_death_self_heal_in_matrix():
    rc.plan("cluster", workers=2)
    rc.active_backend().wait_for_workers(2, timeout=WAIT)
    with pytest.raises(rc.WorkerDiedError):
        value(future(lambda: os._exit(41)))
    assert future_map(lambda x: x * 10, [1, 2, 3]) == [10, 20, 30]
