"""The port's payload pipeline (``repro_torch.core.backends.blobstore`` and
``transport``, ``repro_torch.optim.compression``) against the JAX package:
the compression arithmetic, byte-identical codec blobs that either package
decodes, equal content digests; then the rows of tests/test_payload_cache.py
that run on no backend or on ``processes`` (the cluster's rows on
``processes`` in its place), tensor payloads (bf16 as 2-byte words, the
digest memo keyed on a tensor's version, the shared decoded cache) and the
warm pool re-attached by worker pid.

Every wait on a worker has a timeout, so that a hang fails its test.
"""

import os
import pickle
import socket
import time

import numpy as np
import pytest
import torch
from _torch_parity import _reset_port  # noqa: F401

import repro_torch.core as rc
from repro_torch.core import future, value
from repro_torch.core.backends import blobstore, transport
from repro_torch.core.backends.blobstore import (BlobStore, PayloadRef,
                                                 PAYLOAD_REF_THRESHOLD,
                                                 content_digest)
from repro_torch.optim import compression

WAIT = 60.0


@pytest.fixture(autouse=True)
def _codecs_reset():
    """Both packages' array codecs raw and their EF state empty."""
    from repro.core.backends import transport as jt
    for mod in (transport, jt):
        mod.set_array_codec("raw")
        mod.reset_array_codec_state()
    yield
    for mod in (transport, jt):
        mod.set_array_codec("raw")
        mod.reset_array_codec_state()


def _v(f):
    return value(f, timeout=WAIT)


# --------------------------------------------------------------------------
# parity with the JAX package: compression first (int8 blobs are byte-
# identical only where it holds), then the codec blobs and digests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_quantize_int8_matches_the_jax_package(scale):
    import jax.numpy as jnp
    from repro.optim import compression as jc
    x = (np.random.default_rng(1).standard_normal(50_000) * scale) \
        .astype(np.float32)
    jq, js = jc.quantize_int8(jnp.asarray(x))
    tq, ts = compression.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        compression.dequantize_int8(tq, ts).numpy(),
        np.asarray(jc.dequantize_int8(jq, js)))


def test_topk_sparsify_matches_the_jax_package():
    """On an input without ties in |x|: the same values, the same flat
    indices, the same restore."""
    import jax.numpy as jnp
    from repro.optim import compression as jc
    rng = np.random.default_rng(2)
    x = ((rng.permutation(4000) + 0.5) * rng.choice([-1, 1], 4000)) \
        .astype(np.float32).reshape(50, 80)
    jv, ji, jshape = jc.topk_sparsify(jnp.asarray(x), 0.05)
    tv, ti, tshape = compression.topk_sparsify(torch.from_numpy(x), 0.05)
    assert tshape == tuple(jshape)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        compression.topk_restore(tv, ti, tshape).numpy(),
        np.asarray(jc.topk_restore(jv, ji, jshape)))


def test_error_feedback_residual_matches_after_three_steps():
    import jax.numpy as jnp
    from repro.optim import compression as jc
    rng = np.random.default_rng(3)
    jef, tef = jc.ErrorFeedback(), compression.ErrorFeedback()
    for _ in range(3):
        g = {"w": rng.standard_normal((64, 32)).astype(np.float32),
             "b": [rng.standard_normal(32).astype(np.float32)]}
        (jq, _), (tq, _) = (
            jef.compress({"w": jnp.asarray(g["w"]),
                          "b": [jnp.asarray(g["b"][0])]}),
            tef.compress({"w": torch.from_numpy(g["w"]),
                          "b": [torch.from_numpy(g["b"][0])]}))
        np.testing.assert_array_equal(tq["w"][0].numpy(),
                                      np.asarray(jq["w"][0]))
    np.testing.assert_array_equal(tef.residual["w"].numpy(),
                                  np.asarray(jef.residual["w"]))
    np.testing.assert_array_equal(tef.residual["b"][0].numpy(),
                                  np.asarray(jef.residual["b"][0]))


def _codec_cases():
    rng = np.random.default_rng(4)
    return {
        "raw-float32": (rng.standard_normal(20_000).astype(np.float32), {}),
        "raw-int64": (np.arange(20_000, dtype=np.int64).reshape(100, 200),
                      {}),
        "int8-fresh-ef": (rng.standard_normal((40, 500)).astype(np.float32),
                          {"int8": True, "name": "w"}),
        "int8-no-name": (rng.standard_normal(9000).astype(np.float32),
                         {"int8": True}),
        "pickle": ({"k": list(range(6000)), "s": "x" * 10}, {}),
        "zlib-pickle": ({"toks": ["token-%d" % (i % 100)
                                  for i in range(20_000)]}, {}),
    }


@pytest.mark.parametrize("case", list(_codec_cases()))
def test_encode_payload_is_byte_identical_to_the_jax_package(case):
    """The same numpy value encodes to the same blob in both packages, and
    each package decodes the other's blob to the same value."""
    from repro.core.backends import transport as jt
    val, kw = _codec_cases()[case]
    if kw.get("int8"):
        kw = dict(kw, digest=content_digest(val))
    got = transport.encode_payload(val, **kw)
    want = jt.encode_payload(val, **kw)
    assert got[0] == want[0]
    assert got == want
    for blob in (got, want):
        a, ca = transport.decode_payload(blob)
        b, cb = jt.decode_payload(blob)
        assert ca == cb
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, np.asarray(b))
            assert a.dtype == np.asarray(b).dtype
        else:
            assert a == b


def test_content_digest_matches_the_jax_package():
    from repro.core.backends import blobstore as jb
    rng = np.random.default_rng(5)
    for arr in (rng.standard_normal(7000).astype(np.float32),
                np.arange(12, dtype=np.int64).reshape(3, 4),
                rng.standard_normal((5, 6, 7)) > 0):
        assert content_digest(arr) == jb.content_digest(arr)
    blob = transport.encode_payload({"a": 1})
    assert blobstore.blob_digest(blob) == jb.blob_digest(blob)


def test_bf16_tensor_body_is_the_jax_bf16_array_bits():
    """bf16 rides as 2-byte words: the raw body of a ``torch.bfloat16``
    tensor is the JAX bf16 array's, bit for bit, and the port rebuilds the
    JAX package's bf16 blob as a bf16 tensor of the same bits."""
    import jax.numpy as jnp
    from repro.core.backends import transport as jt
    x = np.random.default_rng(6).standard_normal((64, 48)) \
        .astype(np.float32) * 3
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = np.asarray(jnp.asarray(x, jnp.bfloat16))
    got_meta, got_body = transport._unpack_meta(transport.encode_payload(xt))
    jblob = jt.encode_payload(xj)
    _, want_body = jt._unpack_meta(jblob)
    assert got_meta["dtype"] == "bfloat16" and got_meta["kind"] == "torch"
    assert bytes(got_body) == bytes(want_body)
    back, _ = transport.decode_payload(jblob)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), xt.view(torch.int16))


# --------------------------------------------------------------------------
# BlobStore unit behaviour (tests/test_payload_cache.py:34-84)
# --------------------------------------------------------------------------

def test_blobstore_lru_eviction_by_bytes():
    store = BlobStore(max_bytes=100)
    store.put(b"a" * 16, b"x" * 40)
    store.put(b"b" * 16, b"y" * 40)
    assert b"a" * 16 in store and b"b" * 16 in store
    store.get(b"a" * 16)                    # touch: a becomes most-recent
    store.put(b"c" * 16, b"z" * 40)         # over budget: evict LRU (b)
    assert b"b" * 16 not in store
    assert b"a" * 16 in store and b"c" * 16 in store
    assert store.stats()["evictions"] == 1


def test_blobstore_resolve_caches_decoded_arrays():
    store = BlobStore()
    arr = np.arange(6000, dtype=np.float32)
    digest = content_digest(arr)
    store.put(digest, transport.encode_payload(arr))
    v1 = store.resolve(digest)
    v2 = store.resolve(digest)
    assert v1 is v2                          # decoded-object cache hit
    assert not v1.flags.writeable            # handed out read-only
    np.testing.assert_array_equal(v1, arr)


def test_blobstore_shares_decoded_tensors():
    """The contract of ``blobstore.py``: a decoded tensor is one object for
    every task resolving its digest (torch has no read-only flag), so a
    task clones before it writes; the blob's bytes stay as they were."""
    store = BlobStore()
    t = torch.arange(6000, dtype=torch.float32)
    digest = content_digest(t)
    blob = transport.encode_payload(t)
    store.put(digest, blob)
    v1 = store.resolve(digest)
    v2 = store.resolve(digest)
    assert v1 is v2 and torch.equal(v1, t)
    mine = v1.clone()
    mine.add_(1)                             # the clone, not the shared one
    assert torch.equal(store.resolve(digest), t)
    v1.add_(1)                               # a write the contract forbids:
    assert store.resolve(digest) is v1       # every later resolver sees it
    assert store.get(digest) == blob         # ... but never the blob bytes
    assert torch.equal(transport.decode_payload(blob)[0], t)


def test_blobstore_put_replacement_invalidates_decoded_cache():
    store = BlobStore()
    digest = b"d" * 16
    a = np.arange(5000, dtype=np.int64)
    b = a * 2
    store.put(digest, transport.encode_payload(a))
    np.testing.assert_array_equal(store.resolve(digest), a)
    store.put(digest, transport.encode_payload(b))
    np.testing.assert_array_equal(store.resolve(digest), b)


def test_content_digest_is_memoized_and_content_addressed():
    a = np.random.default_rng(0).standard_normal(5000).astype(np.float32)
    assert content_digest(a) == content_digest(a)
    assert content_digest(a) == content_digest(a.copy())   # same content
    b = a.copy()
    b[0] += 1.0
    assert content_digest(a) != content_digest(b)          # new content


def test_tensor_digest_follows_in_place_writes():
    """A tensor's memo entry is keyed on its version counter: an in-place
    write (through the tensor or a view of it) gives a new digest, and
    restoring the bytes gives the old one back."""
    t = torch.arange(5000, dtype=torch.float32)
    d0 = content_digest(t)
    assert content_digest(t) == d0                         # memo hit
    t[0] += 1.0
    d1 = content_digest(t)
    assert d1 != d0
    t[:10].sub_(torch.tensor([1.0] + [0.0] * 9))          # through a view
    assert content_digest(t) == d0
    assert content_digest(t.clone()) == d0
    assert content_digest(t.to(torch.float64)) != d0       # dtype is identity
    assert content_digest(t.view(torch.int32)) != d0       # same bytes


# --------------------------------------------------------------------------
# Payload codec: lossless raw by default, opt-in int8+EF (test_payload_
# cache.py:85-321)
# --------------------------------------------------------------------------

@pytest.fixture
def int8_codec():
    transport.set_array_codec("int8")
    yield
    transport.set_array_codec("raw")


def test_float_arrays_ship_lossless_by_default():
    x = np.random.default_rng(4).standard_normal(8192).astype(np.float32)
    blob = transport.encode_payload(x)
    assert blob[0] == transport.P_RAWARR
    got, _ = transport.decode_payload(blob)
    np.testing.assert_array_equal(got, x)


def test_float_tensors_ship_lossless_by_default():
    for dtype in (torch.float32, torch.bfloat16, torch.int64, torch.bool):
        x = (torch.randn(3, 4096, generator=torch.Generator().manual_seed(7))
             * 100).to(dtype)
        blob = transport.encode_payload(x)
        assert blob[0] == transport.P_RAWARR
        got, cacheable = transport.decode_payload(blob)
        assert cacheable and got.dtype == dtype and got.shape == x.shape
        assert torch.equal(got, x)
    empty, _ = transport.decode_payload(
        transport.encode_payload(torch.empty(0, 3)))
    assert empty.shape == (0, 3)


def test_set_array_codec_toggles_and_validates():
    assert not transport.ARRAY_CODEC_INT8
    try:
        transport.set_array_codec("int8")
        assert transport.ARRAY_CODEC_INT8
        with pytest.raises(ValueError):
            transport.set_array_codec("zstd")
    finally:
        transport.set_array_codec("raw")
    assert not transport.ARRAY_CODEC_INT8


def test_codec_toggle_changes_float_array_digest():
    x = np.random.default_rng(9).standard_normal(8192).astype(np.float32)
    ints = np.arange(8192, dtype=np.int64)
    xt = torch.from_numpy(x.copy())
    d_raw, d_ints, d_t = content_digest(x), content_digest(ints), \
        content_digest(xt)
    assert transport.encode_payload(x)[0] == transport.P_RAWARR
    try:
        transport.set_array_codec("int8")
        assert content_digest(x) != d_raw
        assert content_digest(xt) != d_t
        assert content_digest(ints) == d_ints     # int64 never quantized
        assert transport.encode_payload(x)[0] == transport.P_INT8
    finally:
        transport.set_array_codec("raw")
    assert content_digest(x) == d_raw and content_digest(xt) == d_t


def test_int8_codec_compresses_float32_at_least_3_5x(int8_codec):
    x = np.random.default_rng(1).standard_normal(1 << 16).astype(np.float32)
    raw = len(pickle.dumps(x, pickle.HIGHEST_PROTOCOL))
    blob = transport.encode_payload(x)
    assert blob[0] == transport.P_INT8
    assert raw >= 3.5 * len(blob), (raw, len(blob))


def test_int8_codec_round_trip_error_is_bounded(int8_codec):
    rng = np.random.default_rng(2)
    for scale_exp in (-3, 0, 4):
        x = (rng.standard_normal(1 << 14) * 10.0 ** scale_exp) \
            .astype(np.float32)
        for val in (x, torch.from_numpy(x.copy())):
            got, cacheable = transport.decode_payload(
                transport.encode_payload(val))
            assert cacheable
            bound = float(np.abs(x).max()) / 127 + 1e-9
            assert float(np.abs(np.asarray(got) - x).max()) <= bound


def test_error_feedback_reinjects_quantization_error(int8_codec):
    rng = np.random.default_rng(3)
    steps = [rng.standard_normal(4096).astype(np.float32) for _ in range(8)]
    total_true = np.zeros(4096, np.float32)
    total_ef = np.zeros(4096, np.float32)
    total_plain = np.zeros(4096, np.float32)
    for s in steps:
        total_true += s
        ef_val, _ = transport.decode_payload(
            transport.encode_payload(s, name="ef-global"))
        total_ef += ef_val
        plain_val, _ = transport.decode_payload(
            transport.encode_payload(s))            # no name -> no EF
        total_plain += plain_val
    err_ef = float(np.abs(total_ef - total_true).mean())
    err_plain = float(np.abs(total_plain - total_true).mean())
    assert err_ef < err_plain


def test_int8_reencode_of_aged_out_digest_is_deterministic(int8_codec):
    rng = np.random.default_rng(11)
    arrs = [rng.standard_normal(4096).astype(np.float32) for _ in range(6)]
    for a in arrs:                           # 6 digests > _EF_REPLAY_KEEP=4
        transport.encode_payload(a, name="age")
    residual_before = transport._EF["age"].ef.residual.clone()
    b1 = transport.encode_payload(arrs[0], name="age")   # aged-out digest
    assert torch.equal(transport._EF["age"].ef.residual, residual_before)
    got, _ = transport.decode_payload(b1)
    bound = float(np.abs(arrs[0]).max()) / 127 + 1e-9
    assert float(np.abs(got - arrs[0]).max()) <= bound


def test_bfloat16_tensors_ship_and_digest():
    xb = (torch.arange(20_000, dtype=torch.float32) / 7).to(torch.bfloat16)
    assert content_digest(xb) is not None
    blob = transport.encode_payload(xb)
    assert blob[0] == transport.P_RAWARR
    got, cacheable = transport.decode_payload(blob)
    assert cacheable and got.dtype == torch.bfloat16
    assert torch.equal(got, xb)
    try:
        transport.set_array_codec("int8")
        got8, _ = transport.decode_payload(transport.encode_payload(xb))
    finally:
        transport.set_array_codec("raw")
    assert got8.dtype == torch.bfloat16
    bound = float(xb.float().abs().max()) / 127 * 1.01
    assert float((got8.float() - xb.float()).abs().max()) <= bound


def test_codec_toggle_between_creation_and_dispatch_respects_digest():
    from repro_torch.core.globals_capture import extract_payload_refs
    x = np.random.default_rng(10).standard_normal(20_000).astype(np.float32)
    refd, sources = extract_payload_refs({"x": x}, backend="processes")
    (digest,) = sources
    transport.set_array_codec("int8")            # toggle after creation
    try:
        blob = sources[digest].encode()
        assert blob[0] == transport.P_RAWARR     # creation-time codec wins
        got, _ = transport.decode_payload(blob)
        np.testing.assert_array_equal(got, x)
    finally:
        transport.set_array_codec("raw")


def test_encode_backfill_maps_encode_failure_to_nak():
    from repro_torch.core.backends.blobstore import encode_backfill

    class Boom:
        def encode(self):
            raise RuntimeError("unpicklable mid-flight")

    assert encode_backfill(None) is None
    assert encode_backfill(Boom()) is None


def test_non_float_arrays_ship_raw_and_lossless():
    x = np.arange(20000, dtype=np.int64)
    blob = transport.encode_payload(x)
    assert blob[0] == transport.P_RAWARR
    got, cacheable = transport.decode_payload(blob)
    assert cacheable
    np.testing.assert_array_equal(got, x)
    assert not got.flags.writeable


def test_int8_replay_is_byte_identical_after_content_advances(int8_codec):
    rng = np.random.default_rng(6)
    a = rng.standard_normal(8192).astype(np.float32)
    b = rng.standard_normal(8192).astype(np.float32)
    blob_a1 = transport.encode_payload(a, name="g")
    blob_b1 = transport.encode_payload(b, name="g")   # residual advances
    blob_a2 = transport.encode_payload(a, name="g")   # backfill of old digest
    blob_b2 = transport.encode_payload(b, name="g")
    assert blob_a2 == blob_a1
    assert blob_b2 == blob_b1


def test_large_compressible_pickle_payloads_ship_zlibbed():
    val = {"toks": ["token-%d" % (i % 100) for i in range(20_000)]}
    raw = len(pickle.dumps(val, pickle.HIGHEST_PROTOCOL))
    blob = transport.encode_payload(val)
    assert blob[0] == transport.P_ZPICKLE
    assert len(blob) < raw / 2
    got, cacheable = transport.decode_payload(blob)
    assert got == val
    assert not cacheable


def test_pickle_payloads_round_trip():
    val = {"k": list(range(6000))}
    blob = transport.encode_payload(val, pickled=None)
    assert blob[0] == transport.P_PICKLE
    got, cacheable = transport.decode_payload(blob)
    assert got == val
    assert not cacheable


def test_tensor_pickle_is_deterministic_raw_bytes():
    """A container of tensors pickles to the same bytes every time (its
    digest is stable while its tensors are), with no CUDA IPC or shared
    storage in it, and comes back equal."""
    from repro_torch.core.globals_capture import dumps_robust
    params = {"w": torch.randn(64, 64), "b": [torch.zeros(64)],
              "h": torch.randn(8, 8).to(torch.bfloat16)}
    blob = dumps_robust(params)
    assert dumps_robust(params) == blob
    assert b"storage" not in blob and b"rebuild_cuda" not in blob
    back = pickle.loads(blob)
    assert all(torch.equal(back[k], params[k]) for k in ("w", "h"))
    assert back["h"].dtype == torch.bfloat16
    params["w"][0, 0] += 1
    assert dumps_robust(params) != blob


def test_cuda_payload_is_refused_without_a_card(monkeypatch):
    """No fallback: a tensor payload (or pickled tensor) whose device type
    is CUDA raises on a process without CUDA; it is never rebuilt on the
    CPU."""
    from repro_torch.core.globals_capture import _rebuild_tensor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = transport._pack_meta(
        transport.P_RAWARR, {"dtype": "float32", "shape": (4,),
                             "kind": "torch", "device": "cuda"},
        np.arange(4, dtype=np.float32).tobytes())
    with pytest.raises(rc.ChannelError, match="no CUDA device"):
        transport.decode_payload(blob)
    with pytest.raises(rc.ChannelError, match="no CUDA device"):
        _rebuild_tensor(b"\0" * 16, "float32", (4,), "cuda", False)


def test_ensure_refs_surfaces_nak_as_channel_error():
    from repro_torch.core.backends.worker import ensure_refs
    store = BlobStore()
    digest = b"n" * 16
    with pytest.raises(rc.ChannelError, match=digest.hex()[:12]):
        ensure_refs(store, [digest], lambda d: None,
                    lambda: ("nak", digest))


def test_payload_refs_only_split_large_globals():
    from repro_torch.core.globals_capture import extract_payload_refs
    small = np.arange(16, dtype=np.float32)
    big = np.arange(PAYLOAD_REF_THRESHOLD, dtype=np.float32)
    tbig = torch.arange(PAYLOAD_REF_THRESHOLD, dtype=torch.float32)
    refd, sources = extract_payload_refs(
        {"small": small, "big": big, "n": 3, "tbig": tbig,
         "tsmall": tbig[:8]}, backend="processes")
    assert refd["small"] is small and refd["n"] == 3
    assert refd["tsmall"] is not None and not isinstance(refd["tsmall"],
                                                         PayloadRef)
    assert isinstance(refd["big"], PayloadRef)
    assert isinstance(refd["tbig"], PayloadRef)
    assert set(sources) == {refd["big"].digest, refd["tbig"].digest}


# --------------------------------------------------------------------------
# End to end on processes (test_payload_cache.py:199, :446, :461, :504,
# :521, :532, and the warm pool)
# --------------------------------------------------------------------------

def _pid_alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, TypeError):
        return False
    except PermissionError:
        return True
    return True


def test_processes_worker_dead_at_dispatch_raises_workerdied(monkeypatch):
    from repro_torch.core.backends import processes as proc_mod
    rc.plan("processes", workers=1)
    try:
        pid = _v(future(lambda: os.getpid()))
        os.kill(pid, 9)
        deadline = time.time() + 10
        while time.time() < deadline and _pid_alive(pid):
            time.sleep(0.05)
        monkeypatch.setattr(proc_mod._Worker, "alive", lambda self: True)
        with pytest.raises(rc.WorkerDiedError):
            _v(future(lambda: 1))
        monkeypatch.undo()
        assert _v(future(lambda: 2)) == 2        # pool self-healed
    finally:
        rc.shutdown()


def test_eviction_triggers_need_backfill():
    a = np.arange(50_000, dtype=np.int64)            # 400 KB, lossless codec
    b = torch.arange(50_000, 100_000, dtype=torch.int64)
    rc.plan("processes", workers=1, blob_store_bytes=600_000)
    try:
        assert _v(future(lambda: int(a[-1]))) == 49_999
        assert _v(future(lambda: int(b[-1]))) == 99_999   # evicts a
        assert _v(future(lambda: int(a[0]) + int(a[-1]))) == 49_999
        assert _v(future(lambda: int(b[0]))) == 50_000
    finally:
        rc.shutdown()


def test_task_refs_exceeding_store_bound_survive_via_pinning():
    a = np.arange(50_000, dtype=np.int64)            # 400 KB each
    b = torch.arange(50_000, dtype=torch.int64) * 2
    rc.plan("processes", workers=1, blob_store_bytes=600_000)
    try:
        assert _v(future(lambda: int(a[1]) + int(b[1]))) == 3
        assert _v(future(lambda: int(a[2]) + int(b[2]))) == 6
    finally:
        rc.shutdown()


def test_backfill_is_served_from_the_driver_store_not_encoded_again(
        monkeypatch):
    """A worker whose small store evicts a task's large payload asks it
    back; the driver store, bounded below the payload as well, keeps the
    in-flight task's sources pinned, so the payload is encoded once for
    all of its futures and the sends."""
    a = np.arange(60_000, dtype=np.int64)            # 480 KB, lossless
    monkeypatch.setattr(blobstore.DRIVER_STORE, "max_bytes", 400_000)
    encoded = []
    encode = transport.encode_payload

    def counted(value, **kw):
        encoded.append(kw.get("digest"))
        return encode(value, **kw)

    monkeypatch.setattr(transport, "encode_payload", counted)
    rc.plan("processes", workers=1, blob_store_bytes=600_000)
    try:
        for i in range(3):
            b = torch.full((40_000,), i, dtype=torch.int64)  # evicts a
            assert _v(future(lambda: int(a[-1]) + int(b[0]))) == 59_999 + i
        assert encoded.count(content_digest(a)) == 1
    finally:
        rc.shutdown()


def test_unpicklable_global_still_raises_at_creation():
    sock_obj = socket.socket()
    try:
        rc.plan("processes", workers=1)
        with pytest.raises(rc.NonExportableObjectError, match="sock"):
            future(lambda: sock_obj.fileno())
    finally:
        sock_obj.close()
        rc.shutdown()


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_shipped_float_global_is_lossless_by_default(kind):
    x = np.random.default_rng(7).standard_normal(40_000).astype(np.float32)
    g = x if kind == "numpy" else torch.from_numpy(x.copy())
    rc.plan("processes", workers=1)
    try:
        got = _v(future(lambda: g + 0.0))
        np.testing.assert_array_equal(np.asarray(got), x)
        assert isinstance(got, type(g))
    finally:
        rc.shutdown()


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_shipped_float_global_error_bounded_with_int8_opt_in(kind,
                                                             int8_codec):
    x = np.random.default_rng(7).standard_normal(40_000).astype(np.float32)
    g = x if kind == "numpy" else torch.from_numpy(x.copy())
    rc.plan("processes", workers=1)
    try:
        got = _v(future(lambda: g + 0.0))
        bound = float(np.abs(x).max()) / 127 + 1e-9
        assert float(np.abs(np.asarray(got) - x).max()) <= bound
    finally:
        rc.shutdown()


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


def _tally(backend) -> list:
    tallies = []
    for w in backend._idle:
        w.parent_conn = _PutTally(w.parent_conn)
        tallies.append(w.parent_conn)
    return tallies


def test_replan_reuses_live_processes_workers():
    """Re-planning to the same spec re-attaches to the parked pool: the
    same backend object and the same worker pids."""
    rc.plan("processes", workers=2)
    try:
        b1 = rc.active_backend()
        pids = sorted(b1.worker_pids())
        assert len(pids) == 2 and os.getpid() not in pids
        rc.plan("threads", workers=2)
        assert _v(future(lambda: 1)) == 1
        rc.plan("processes", workers=2)
        b2 = rc.active_backend()
        assert b2 is b1                          # no cold start
        assert sorted(b2.worker_pids()) == pids  # the same live workers
        assert _v(future(lambda: os.getpid())) in pids
    finally:
        rc.shutdown()


def test_replan_keeps_worker_blob_caches_warm():
    big = torch.arange(120_000, dtype=torch.int64)
    rc.plan("processes", workers=1)
    try:
        (tally,) = _tally(rc.active_backend())
        assert _v(future(lambda: int(big[0]))) == 0   # ships the payload
        assert tally.put_bytes > big.numel() * 8
        rc.plan("threads", workers=1)
        rc.plan("processes", workers=1)
        shipped = tally.put_bytes
        assert _v(future(lambda: int(big[1]))) == 1
        assert tally.put_bytes == shipped        # the worker still holds it
    finally:
        rc.shutdown()


def test_in_place_write_between_futures_ships_the_new_bytes():
    """A tensor global written in place between two futures reaches the
    worker with its new bytes (its digest follows the version counter);
    an unchanged one is not sent again."""
    w = torch.zeros(10_000)
    rc.plan("processes", workers=1)
    try:
        (tally,) = _tally(rc.active_backend())
        assert _v(future(lambda: float(w.sum()))) == 0.0
        first = tally.put_bytes
        assert _v(future(lambda: float(w.sum()))) == 0.0
        assert tally.put_bytes == first           # cache hit, no put
        w.add_(1.0)
        assert _v(future(lambda: float(w.sum()))) == 10_000.0
        assert tally.put_bytes > first            # the new bytes shipped
    finally:
        rc.shutdown()


def test_self_healed_worker_starts_with_cold_cache():
    big = np.arange(100_000, dtype=np.int64)         # 800 KB lossless
    rc.plan("processes", workers=1)
    try:
        backend = rc.active_backend()
        (tally,) = _tally(backend)
        assert _v(future(lambda: int(big[-1]))) == 99_999
        shipped = tally.put_bytes
        assert _v(future(lambda: int(big[-1]))) == 99_999    # cache hit
        assert tally.put_bytes == shipped
        with pytest.raises(rc.WorkerDiedError):
            _v(future(lambda: os._exit(31)))         # kill; pool self-heals
        (healed,) = _tally(backend)
        assert _v(future(lambda: int(big[-1]))) == 99_999
        assert healed.put_bytes > big.nbytes         # full re-ship
    finally:
        rc.shutdown()


def test_explicit_shutdown_really_tears_down_the_pool():
    rc.plan("processes", workers=1)
    pids = rc.active_backend().worker_pids()
    rc.plan("sequential")                    # parks the processes backend
    rc.shutdown()                            # kills parked backends too
    deadline = time.time() + 10
    while time.time() < deadline:
        if not any(_pid_alive(p) for p in pids):
            break
        time.sleep(0.05)
    assert not any(_pid_alive(p) for p in pids)


def test_dispatch_encode_failure_fails_future_not_worker(monkeypatch):
    big = np.arange(60_000, dtype=np.int64)
    rc.plan("processes", workers=1)
    try:
        def boom(self):
            raise RuntimeError("encode exploded")

        monkeypatch.setattr(blobstore.PayloadSource, "encode", boom)
        with pytest.raises(RuntimeError, match="encode exploded"):
            _v(future(lambda: int(big[0])))
        monkeypatch.undo()
        assert _v(future(lambda: int(big[1]))) == 1   # worker still usable
    finally:
        rc.shutdown()


def test_different_spec_is_not_reused():
    rc.plan("processes", workers=1)
    try:
        b1 = rc.active_backend()
        rc.plan("processes", workers=2)          # different spec
        b2 = rc.active_backend()
        assert b2 is not b1
    finally:
        rc.shutdown()
