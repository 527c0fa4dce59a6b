"""The port's TCP cluster transport (a mirror of
tests/test_cluster_transport.py, all 28 rows): framing, handshake,
heartbeats, death, self-heal, and the event-driven ``resolve()`` /
``as_completed()`` semantics on ``plan("cluster")`` of ``repro_torch``.

Held against the JAX package on the same inputs: ``encode_frame`` of the
same plain objects and numpy arrays gives the same bytes in both packages
(in-band, zlib'd and out-of-band), and either package's ``dial_auth``
passes the other's ``serve_auth`` with the right token and is refused with
a wrong one before any frame is read. Tensors ride frames as their bytes
(out-of-band), never as CUDA IPC handles.

The cluster rows share one warm two-worker pool (``planning.py`` parks it
between tests; the module's end shuts it down). Wall-clock bounds are
loose (ROADMAP note R1): a loaded host must not fail them.
"""

import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st

import repro.core.backends.transport as ref_transport
import repro_torch.core as rc
from repro_torch.core import as_completed, future, future_map, resolve
from repro_torch.core.backends import transport
from repro_torch.core.backends.cluster import ClusterBackend
from repro_torch.core.errors import ChannelError

#: seconds any one wait on a worker may take
WAIT = 60.0


def value(f, timeout: float = WAIT):
    return rc.value(f, timeout=timeout)


@pytest.fixture(autouse=True)
def _reset_port():
    """Plan, seed and state per test; a cluster is parked warm between
    tests, not shut down."""
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
def cluster():
    """The warm two-worker pool, whole again: a worker an earlier row
    killed has been relaunched and has said hello."""
    rc.plan("cluster", workers=2)
    backend = rc.active_backend()
    backend.wait_for_workers(2, timeout=WAIT)
    yield backend
    rc.plan("sequential")


# --------------------------------------------------------------------------
# framing
# --------------------------------------------------------------------------

def test_framing_roundtrip():
    a, b = socket.socketpair()
    frames = [("hello", {"pid": 1, "host": "x"}),
              ("task", 7, b"\x00" * 100_000),
              ("hb",)]
    for f in frames:
        transport.send_frame(a, f)
    assert [transport.recv_frame(b) for _ in frames] == frames
    a.close()
    b.close()


def test_frame_reader_reassembles_partial_delivery():
    a, b = socket.socketpair()
    blob = transport.encode_frame(("task", 1, b"y" * 5000))
    reader = transport.FrameReader(b)
    out = []
    for i in range(0, len(blob), 997):         # drip-feed odd-sized chunks
        a.sendall(blob[i:i + 997])
        out += reader.feed()
    assert out == [("task", 1, b"y" * 5000)]
    a.close()
    b.close()


def test_truncated_frame_is_channel_error():
    a, b = socket.socketpair()
    blob = transport.encode_frame(("result", 1, "x"))
    a.sendall(blob[:-2])
    a.close()
    reader = transport.FrameReader(b)
    with pytest.raises(ChannelError):
        while True:
            reader.feed()
    b.close()


def test_clean_close_is_eof():
    a, b = socket.socketpair()
    a.close()
    with pytest.raises(EOFError):
        transport.FrameReader(b).feed()
    b.close()


def test_large_frame_is_compressed_on_the_wire():
    """Frames past COMPRESS_THRESHOLD ship zlib-compressed (flag byte 1)
    and round-trip identically through both read paths."""
    payload = ("result", 3, b"Z" * (2 * transport.COMPRESS_THRESHOLD))
    blob = transport.encode_frame(payload)
    (n,) = transport._LEN.unpack(blob[:8])
    assert blob[8] == 1                       # zlib codec flag
    assert n == len(blob) - 8
    assert len(blob) < transport.COMPRESS_THRESHOLD

    a, b = socket.socketpair()
    transport.send_frame(a, payload)
    assert transport.recv_frame(b) == payload
    transport.send_frame(a, payload)
    reader = transport.FrameReader(b)
    frames = []
    while not frames:
        frames += reader.feed()
    assert frames == [payload]
    a.close()
    b.close()


def test_small_and_incompressible_frames_stay_raw():
    small = transport.encode_frame(("hb",))
    assert small[8] == 0                      # raw codec flag
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, 2 * transport.COMPRESS_THRESHOLD,
                         dtype="uint8").tobytes()
    framed = transport.encode_frame(("result", 1, noise))
    assert framed[8] == 0
    a, b = socket.socketpair()
    transport.send_frame(a, ("result", 1, noise))
    assert transport.recv_frame(b)[2] == noise
    a.close()
    b.close()


# --------------------------------------------------------------------------
# the same bytes as the JAX package's frames; tensors out-of-band
# --------------------------------------------------------------------------

_PARITY_FRAMES = {
    "in-band": ("hello", {"pid": 7, "host": "h", "peer": ("127.0.0.1", 9)}),
    "in-band-task": ("task", 3, b"\x01" * 1000, (b"d" * 16,),
                     {b"d" * 16: [("127.0.0.1", 4000)]}, True),
    "zlib": ("result", 3, "Z" * (3 * 64 * 1024)),
    "oob-array": ("result", 9, np.random.default_rng(5)
                  .standard_normal(1 << 12).astype(np.float32)),
    "oob-empty": ("result", 1, np.empty((0,), np.float32),
                  np.arange(4, dtype=np.int64)),
    "oob-picklebuffer": ("put", b"p" * 16,
                         pickle.PickleBuffer(b"blob" * 5000)),
}


@pytest.mark.parametrize("case", sorted(_PARITY_FRAMES))
def test_encode_frame_is_byte_identical_to_the_reference(case):
    obj = _PARITY_FRAMES[case]
    got = transport.encode_frame(obj)
    assert got == ref_transport.encode_frame(obj)
    flag = {"zlib": 1}.get(case, 2 if case.startswith("oob") else 0)
    assert got[8] == flag
    # and each package decodes the other's frame to the same objects
    assert _plain(transport._decode_payload(memoryview(got)[8:])) \
        == _plain(ref_transport._decode_payload(memoryview(got)[8:])) \
        == _plain(obj)


def _plain(obj):
    """A comparable form of a decoded frame: buffers as bytes, arrays as
    (dtype, shape, bytes)."""
    if isinstance(obj, (tuple, list)):
        return tuple(_plain(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (memoryview, pickle.PickleBuffer)):
        return bytes(obj)
    if isinstance(obj, np.ndarray):
        return (obj.dtype.str, obj.shape, obj.tobytes())
    return obj


def test_tensor_frames_ride_out_of_band_as_their_bytes():
    """A tensor in a frame is its raw bytes in an out-of-band buffer (no
    pickle copy of the body, no IPC handle), rebuilt equal on the other
    side, on both read paths."""
    t = torch.randn(1 << 14, generator=torch.Generator().manual_seed(3))
    payload = ("result", 5, {"t": t, "bf16": t[:64].to(torch.bfloat16)})
    blob = transport.encode_frame(payload)
    assert blob[8] == 2                       # OOB frame codec
    assert len(blob) < t.nbytes + 4096
    a, b = socket.socketpair()
    transport.send_frame(a, payload)
    got = transport.recv_frame(b)[2]
    assert torch.equal(got["t"], t) and got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"], t[:64].to(torch.bfloat16))
    transport.send_frame(a, payload)
    reader = transport.FrameReader(b)
    frames = []
    while not frames:
        frames += reader.feed()
    assert torch.equal(frames[0][2]["t"], t)
    a.close()
    b.close()


def test_cuda_tensor_frame_refused_without_a_card():
    """A frame's CUDA tensor is rebuilt only where there is a card: here
    its rebuild raises ChannelError instead of landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.core.globals_capture import _rebuild_tensor
    with pytest.raises(ChannelError, match="no CUDA device"):
        _rebuild_tensor(memoryview(b"\0" * 16), "float32", (4,), "cuda",
                        False)


# --------------------------------------------------------------------------
# the auth preamble against the JAX package's, both ways
# --------------------------------------------------------------------------

def _auth_pair(serve, dial, serve_token, dial_token):
    """Run ``serve`` on one end of a socket pair and ``dial`` on the other;
    returns (served principal or exception, dial exception or None, the
    bytes the listener read after the preamble)."""
    a, b = socket.socketpair()
    out = {}

    def _serve():
        try:
            out["who"] = serve(a, {"cluster": serve_token}, timeout=5)
        except Exception as exc:                              # noqa: BLE001
            out["who"] = exc

    th = threading.Thread(target=_serve)
    th.start()
    try:
        dial(b, dial_token, timeout=5)
        out["dial"] = None
    except Exception as exc:                                  # noqa: BLE001
        out["dial"] = exc
    th.join(10)
    a.close()
    b.close()
    return out["who"], out["dial"]


@pytest.mark.parametrize("listener,dialer", [("port", "jax"),
                                             ("jax", "port")])
def test_auth_preamble_interoperates_with_the_reference(listener, dialer):
    serve = (transport if listener == "port" else ref_transport).serve_auth
    dial = (transport if dialer == "port" else ref_transport).dial_auth
    who, err = _auth_pair(serve, dial, "s3cret", "s3cret")
    assert who == "cluster" and err is None
    who, err = _auth_pair(serve, dial, "s3cret", "wrong")
    assert isinstance(who, Exception) and "bad token" in str(who)
    assert isinstance(err, Exception) and "bad token" in str(err)


def test_bad_token_is_refused_before_any_frame_is_decoded():
    """A dialer with the wrong token never reaches pickle: the listener
    answers the deny verdict and raises, and the frame the dialer sends
    next is never read."""
    a, b = socket.socketpair()
    decoded = []
    real = transport._decode_payload
    transport._decode_payload = lambda p: decoded.append(p) or real(p)
    out = {}

    def _serve():
        try:
            transport.serve_auth(a, {"cluster": "right"}, timeout=5)
            out["frame"] = transport.recv_frame(a)
        except ChannelError as exc:
            out["err"] = exc

    th = threading.Thread(target=_serve)
    th.start()
    try:
        with pytest.raises(ChannelError, match="bad token"):
            transport.dial_auth(b, "wrong", timeout=5)
        try:
            transport.send_frame(b, ("task", 1, b"evil"))
        except OSError:
            pass
        th.join(10)
    finally:
        transport._decode_payload = real
        a.close()
        b.close()
    assert "err" in out and "frame" not in out and not decoded


# --------------------------------------------------------------------------
# handshake / topology
# --------------------------------------------------------------------------

def test_workers_are_remote_processes_over_tcp(cluster):
    """The backend is a real socket cluster, not a processes alias."""
    from repro_torch.core.backends.processes import ProcessBackend
    assert not isinstance(cluster, ProcessBackend)
    host, port = cluster.address
    assert port > 0
    pids = cluster.worker_pids()
    assert len(pids) == 2
    assert os.getpid() not in pids
    assert value(future(lambda: os.getpid())) in pids


def test_standalone_worker_connects_and_resolves():
    """`python -m repro_torch.core.backends.cluster_worker HOST:PORT` —
    the hand-launched path (launcher="external"): the driver waits, the
    operator-launched worker dials in with the token."""
    backend = ClusterBackend(hosts=1, launcher="external",
                             connect_timeout=120, token="by-hand")
    proc = None
    try:
        host, port = backend.address
        src_root = os.path.join(os.path.dirname(__file__), "..", "src")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.abspath(src_root)
        env["OMP_NUM_THREADS"] = "1"
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.core.backends.cluster_worker",
             f"{host}:{port}", "--token", "by-hand"], env=env)
        backend.wait_for_workers()
        pid = value(future(lambda: os.getpid(), backend=backend))
        assert pid == proc.pid
        mods = value(future(lambda: sorted(
            m for m in __import__("sys").modules
            if m.split(".")[0] in ("jax", "repro")), backend=backend))
        assert mods == []
    finally:
        backend.shutdown()
        if proc is not None:
            proc.wait(timeout=30)
            assert proc.returncode == 0     # stop frame -> clean exit


# --------------------------------------------------------------------------
# death detection + self-heal (test_faults.py over sockets)
# --------------------------------------------------------------------------

def test_tcp_worker_kill_is_worker_died_error(cluster):
    with pytest.raises(rc.WorkerDiedError):
        value(future(lambda: os._exit(31)))


def test_pool_self_heals_after_tcp_death(cluster):
    with pytest.raises(rc.WorkerDiedError):
        value(future(lambda: os._exit(31)))
    assert future_map(lambda x: x + 1, [1, 2, 3, 4]) == [2, 3, 4, 5]


def test_sigkill_mid_task(cluster):
    f = future(lambda: time.sleep(60))
    victim = None
    deadline = time.time() + 10
    while victim is None and time.time() < deadline:
        busy = [w for w in cluster._all if w.busy is not None]
        if busy:
            victim = busy[0].meta.get("pid")
    assert victim is not None
    os.kill(victim, signal.SIGKILL)
    with pytest.raises(rc.WorkerDiedError):
        value(f)
    assert value(future(lambda: "healed")) == "healed"


def test_heartbeat_timeout_detects_frozen_worker():
    """A worker that stops heartbeating (SIGSTOP: alive socket, wedged
    process) is declared dead within heartbeat_timeout, not task-duration."""
    backend = ClusterBackend(workers=1, heartbeat_interval=0.1,
                             heartbeat_timeout=1.0)
    pid = None
    try:
        f = future(lambda: time.sleep(60), backend=backend)
        pid = backend.worker_pids()[0]
        os.kill(pid, signal.SIGSTOP)
        t0 = time.time()
        with pytest.raises(rc.WorkerDiedError, match="heartbeat"):
            value(f)
        assert time.time() - t0 < 30.0
        assert max(backend.heartbeat_gaps().values() or [0.0]) >= 0.0
    finally:
        if pid is not None:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        backend.shutdown()


def test_cancel_kills_and_heals(cluster):
    f = future(lambda: time.sleep(60))
    time.sleep(0.2)
    assert f.cancel()
    with pytest.raises(rc.FutureError):
        value(f)
    assert value(future(lambda: 1)) == 1


# --------------------------------------------------------------------------
# resolve() / as_completed() semantics
# --------------------------------------------------------------------------

def test_as_completed_yields_in_completion_order(cluster):
    fs = [future(lambda s=s: (time.sleep(s), s)[1]) for s in (2.0, 0.05)]
    assert [value(f) for f in as_completed(fs)] == [0.05, 2.0]


def test_as_completed_threads_order():
    rc.plan("threads", workers=3)
    fs = [future(lambda s=s: (time.sleep(s), s)[1])
          for s in (1.2, 0.02, 0.5)]
    assert [value(f) for f in as_completed(fs)] == [0.02, 0.5, 1.2]


def test_resolve_blocks_until_all(cluster):
    fs = [future(lambda s=s: time.sleep(s)) for s in (0.05, 0.25)]
    out = resolve(fs)
    assert out is fs
    assert all(f.resolved() for f in fs)


def test_resolve_timeout_raises():
    rc.plan("threads", workers=2)
    f = future(lambda: time.sleep(5.0))
    t0 = time.time()
    with pytest.raises(TimeoutError):
        resolve([f], timeout=0.1)
    assert time.time() - t0 < 4.0
    assert not f.resolved()


def test_as_completed_timeout_raises():
    rc.plan("threads", workers=2)
    f = future(lambda: time.sleep(5.0))
    with pytest.raises(TimeoutError):
        list(as_completed([f], timeout=0.1))


def test_resolve_launches_lazy_futures():
    fs = [future(lambda i=i: i * 2, lazy=True) for i in range(3)]
    resolve(fs)
    assert [value(f) for f in fs] == [0, 2, 4]


# --------------------------------------------------------------------------
# property-based round-trips: arbitrary frames x {plain, zlib, OOB, payload
# codecs} survive both read paths and partial sends byte-exact
# --------------------------------------------------------------------------

class _ScriptedSock:
    """Feeds pre-encoded bytes in scripted chunk sizes."""

    def __init__(self, data: bytes, sizes):
        self._data = memoryview(bytes(data))
        self._sizes = list(sizes)
        self._off = 0

    def _take(self, cap: int) -> int:
        remaining = len(self._data) - self._off
        if remaining == 0 or cap <= 0:
            return 0
        want = self._sizes.pop(0) if self._sizes else remaining
        return max(1, min(want, cap, remaining))

    def recv(self, n: int) -> bytes:
        k = self._take(n)
        chunk = bytes(self._data[self._off:self._off + k])
        self._off += k
        return chunk

    def recv_into(self, buf, n=None) -> int:
        cap = len(buf) if not n else min(n, len(buf))
        k = self._take(cap)
        buf[:k] = self._data[self._off:self._off + k]
        self._off += k
        return k


class _PartialSendSock:
    """sendmsg that accepts a scripted number of bytes per call."""

    def __init__(self, caps):
        self.sent = bytearray()
        self._caps = list(caps)

    def sendmsg(self, views) -> int:
        total = sum(len(v) for v in views)
        cap = self._caps.pop(0) if self._caps else total
        budget = max(1, min(cap, total))
        took = budget
        for v in views:
            k = min(len(v), budget)
            self.sent += bytes(v[:k])
            budget -= k
            if budget == 0:
                break
        return took


def _frame_case(data):
    """Draw one (frame-object, comparator) case covering every wire path,
    tensors included."""
    kind = data.draw(st.sampled_from(
        ["plain", "zlib", "oob-array", "oob-empty-array", "oob-picklebuf",
         "oob-tensor", "payload-raw", "payload-int8", "payload-pickle"]))
    if kind == "plain":
        obj = ("hello", {"pid": data.draw(st.integers(0, 1 << 30)),
                         "host": "h"})
        return obj, lambda got: got == obj
    if kind == "zlib":
        n = data.draw(st.integers(transport.COMPRESS_THRESHOLD,
                                  transport.COMPRESS_THRESHOLD * 2))
        obj = ("result", 7, "Z" * n)
        return obj, lambda got: got == obj
    if kind in ("oob-array", "oob-empty-array"):
        n = 0 if kind == "oob-empty-array" else data.draw(
            st.integers(1, 4096))
        arr = (np.arange(n, dtype=np.float32)
               * np.float32(data.draw(st.floats(-4.0, 4.0))))
        obj = ("result", 3, arr)

        def check(got, arr=arr):
            g = got[2]
            return (got[0], got[1]) == ("result", 3) \
                and g.dtype == arr.dtype and g.shape == arr.shape \
                and bytes(g.tobytes()) == arr.tobytes()
        return obj, check
    if kind == "oob-tensor":
        n = data.draw(st.integers(0, 4096))
        t = torch.arange(n, dtype=torch.float32) * 0.37
        obj = ("result", 4, t)
        return obj, lambda got, t=t: (got[:2] == ("result", 4)
                                      and torch.equal(got[2], t))
    if kind == "oob-picklebuf":
        n = data.draw(st.integers(0, 8192))
        blob = bytes(bytearray(
            data.draw(st.lists(st.integers(0, 255), min_size=0,
                               max_size=32)))) * (n // 32 + 1)
        obj = ("put", b"d" * 16, pickle.PickleBuffer(blob))
        return obj, lambda got, blob=blob: (
            got[0] == "put" and bytes(got[1]) == b"d" * 16
            and bytes(got[2]) == blob)
    n = data.draw(st.integers(0, 2048))
    if kind == "payload-pickle":
        val = {"k": list(range(n % 50)), "s": "x" * n}
        blob = transport.encode_payload(val, int8=False)
        arr = None
    else:
        if kind == "payload-int8":
            n = max(n, 1)
        arr = np.arange(n, dtype=np.float32) * np.float32(0.37)
        blob = transport.encode_payload(
            arr, name=None, int8=(kind == "payload-int8"),
            digest=b"p" * 16)
    obj = ("put", b"p" * 16, pickle.PickleBuffer(blob))

    def check(got, blob=blob, kind=kind, arr=arr):
        if not (got[0] == "put" and bytes(got[2]) == blob):
            return False
        if kind == "payload-raw":
            val, _cacheable = transport.decode_payload(bytes(got[2]))
            return val.tobytes() == arr.tobytes() and val.dtype == arr.dtype
        return True
    return obj, check


@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_transport_roundtrip_property(data):
    obj, check = _frame_case(data)
    blob = transport.encode_frame(obj)
    sizes = data.draw(st.lists(st.integers(1, 2048), min_size=0,
                               max_size=40))
    reader = transport.FrameReader(_ScriptedSock(blob, sizes))
    frames = []
    for _ in range(len(blob) + 1):
        frames += reader.feed()
        if frames:
            break
    assert len(frames) == 1
    assert check(frames[0])


@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_transport_blocking_recv_property(data):
    obj, check = _frame_case(data)
    blob = transport.encode_frame(obj)
    sizes = data.draw(st.lists(st.integers(1, 1024), min_size=0,
                               max_size=40))
    got = transport.recv_frame(_ScriptedSock(blob, sizes))
    assert check(got)


@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_sendmsg_scatter_property(data):
    obj, _check = _frame_case(data)
    parts = transport.encode_frame_parts(obj)
    caps = data.draw(st.lists(st.integers(1, 4096), min_size=0,
                              max_size=40))
    sock = _PartialSendSock(caps)
    transport._sendmsg_all(sock, parts)
    assert bytes(sock.sent) == transport.encode_frame(obj)


def test_empty_array_frame_roundtrip_single_byte_reads():
    arr = np.empty((0,), dtype=np.float32)
    obj = ("result", 1, arr)
    blob = transport.encode_frame(obj)

    reader = transport.FrameReader(_ScriptedSock(blob, [1] * len(blob)))
    frames = []
    while not frames:
        frames += reader.feed()
    assert frames[0][2].shape == (0,)

    got = transport.recv_frame(_ScriptedSock(blob, [1] * len(blob)))
    assert got[2].shape == (0,)

    sock = _PartialSendSock([1] * len(blob))
    transport._sendmsg_all(sock, transport.encode_frame_parts(obj))
    assert bytes(sock.sent) == blob


# --------------------------------------------------------------------------
# dataflow frames (fetch / offer / onak, task hints, held manifests)
# --------------------------------------------------------------------------

def _digest16(data):
    return bytes(bytearray(data.draw(
        st.lists(st.integers(0, 255), min_size=16, max_size=16))))


def _dataflow_frame_case(data):
    kind = data.draw(st.sampled_from(
        ["fetch", "offer", "offer-empty", "onak", "task-hints",
         "result-held"]))
    d = _digest16(data)
    if kind == "fetch":
        obj = ("fetch", d)
        return obj, lambda got: got[0] == "fetch" and bytes(got[1]) == d
    if kind in ("offer", "offer-empty"):
        n = 0 if kind == "offer-empty" else data.draw(st.integers(1, 8192))
        unit = bytes(bytearray(data.draw(
            st.lists(st.integers(0, 255), min_size=1, max_size=32))))
        blob = (unit * (n // len(unit) + 1))[:n]
        obj = ("offer", d, pickle.PickleBuffer(blob))
        return obj, lambda got, blob=blob: (
            got[0] == "offer" and bytes(got[1]) == d
            and bytes(got[2]) == blob)
    if kind == "onak":
        obj = ("onak", d)
        return obj, lambda got: got[0] == "onak" and bytes(got[1]) == d
    if kind == "task-hints":
        addrs = [("127.0.0.1", data.draw(st.integers(1024, 65535)))
                 for _ in range(data.draw(st.integers(0, 3)))]
        hints, keep = {d: addrs}, data.draw(st.booleans())
        obj = ("task", data.draw(st.integers(1, 1 << 30)), b"blob",
               (d,), hints, keep)
        return obj, lambda got, hints=hints, keep=keep: (
            got[0] == "task" and got[4] == hints and bool(got[5]) is keep)
    nbytes = data.draw(st.integers(0, 1 << 40))
    held = ((d, nbytes),)
    obj = ("result", data.draw(st.integers(1, 1 << 30)), "run", held)
    return obj, lambda got, held=held: (
        got[0] == "result" and got[3] == held)


@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_dataflow_frames_roundtrip_split_reads(data):
    obj, check = _dataflow_frame_case(data)
    blob = transport.encode_frame(obj)
    sizes = data.draw(st.lists(st.integers(1, 2048), min_size=0,
                               max_size=40))
    reader = transport.FrameReader(_ScriptedSock(blob, sizes))
    frames = []
    for _ in range(len(blob) + 1):
        frames += reader.feed()
        if frames:
            break
    assert len(frames) == 1
    assert check(frames[0])


@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_dataflow_frames_roundtrip_blocking_recv(data):
    obj, check = _dataflow_frame_case(data)
    blob = transport.encode_frame(obj)
    sizes = data.draw(st.lists(st.integers(1, 1024), min_size=0,
                               max_size=40))
    assert check(transport.recv_frame(_ScriptedSock(blob, sizes)))


@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_dataflow_frames_partial_sendmsg(data):
    obj, _check = _dataflow_frame_case(data)
    parts = transport.encode_frame_parts(obj)
    caps = data.draw(st.lists(st.integers(1, 4096), min_size=0,
                              max_size=40))
    sock = _PartialSendSock(caps)
    transport._sendmsg_all(sock, parts)
    assert bytes(sock.sent) == transport.encode_frame(obj)


def test_fetch_offer_roundtrip_single_byte_reads():
    d = bytes(range(16))
    cases = [(("fetch", d), None), (("onak", d), None),
             (("offer", d, pickle.PickleBuffer(b"")), b""),
             (("offer", d, pickle.PickleBuffer(b"x" * 257)), b"x" * 257)]
    for obj, payload in cases:
        blob = transport.encode_frame(obj)
        reader = transport.FrameReader(_ScriptedSock(blob, [1] * len(blob)))
        frames = []
        while not frames:
            frames += reader.feed()
        got = frames[0]
        got2 = transport.recv_frame(_ScriptedSock(blob, [1] * len(blob)))
        for g in (got, got2):
            assert g[0] == obj[0] and bytes(g[1]) == d
            if payload is not None:
                assert bytes(g[2]) == payload
        sock = _PartialSendSock([1] * len(blob))
        transport._sendmsg_all(sock, transport.encode_frame_parts(obj))
        assert bytes(sock.sent) == blob


def test_no_sleep_polling_in_collection_paths():
    """No time.sleep-based polling in the future_map / future_either /
    resolve collection loops of the port."""
    import importlib
    import inspect
    future_mod = importlib.import_module("repro_torch.core.future")
    from repro_torch.core import mapreduce
    for fn in (mapreduce.future_map, mapreduce.future_either,
               future_mod.resolve, future_mod.as_completed,
               future_mod.wait_any):
        assert "time.sleep" not in inspect.getsource(fn), fn.__name__
