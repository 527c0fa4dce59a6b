"""Repeated dispatch over a large global on the port's cluster: the
content-addressed shipping demo (the twin of ``examples/payload_cache.py``).

The paper's automatic-globals semantics snapshot and ship every global with
every future. Shipping is content-addressed instead:

* the first future referencing an 8 MiB float32 tensor pays one ``put``
  frame — ~2 MiB here because this demo opts into the int8+EF codec (the
  codec is lossy, so by default tensors ship losslessly and the first
  send is ~8 MiB); the blob rides the frame out-of-band, never zlib'd;
* every later future ships a few-hundred-byte task blob holding a 16-byte
  digest; the worker resolves it from a bounded LRU blob store (with a
  decoded-object cache, so it does not even decode it again);
* re-``plan()``-ing to a previously used spec re-attaches to the live
  workers, blob caches intact (warm pool).

Run on the GPU:  PYTHONPATH=src python examples/payload_cache_torch.py
On the CPU:      PYTHONPATH=src python examples/payload_cache_torch.py --device cpu
"""

import argparse
import time

import torch

import repro_torch.core as rc
from repro_torch.core.backends import transport
from repro_torch.device import resolve_device


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args().device)
    big = torch.sin(torch.arange(2 * 1024 * 1024, dtype=torch.float32,
                                 device=device))                # 8 MiB
    raw = big.numel() * big.element_size()

    # quantization-tolerant workload (weights/gradients): opt into the
    # lossy int8+EF codec for the 4x first-send reduction
    transport.set_array_codec("int8")
    try:
        rc.plan("cluster", workers=1)
        rc.value(rc.future(lambda: 1))              # warm the connection

        transport.reset_wire_stats()
        t0 = time.perf_counter()
        rc.value(rc.future(lambda: float(big[3])))
        first_s = time.perf_counter() - t0
        first_b = transport.wire_stats()["bytes_sent"]
        print(f"first dispatch : {first_b} B on the wire "
              f"({raw / first_b:.2f}x smaller than the raw tensor), "
              f"{first_s * 1e3:.1f}ms")

        n = 20
        base = transport.wire_stats()["bytes_sent"]
        t0 = time.perf_counter()
        for _ in range(n):
            rc.value(rc.future(lambda: float(big[3])))
        hit_s = (time.perf_counter() - t0) / n
        hit_b = (transport.wire_stats()["bytes_sent"] - base) / n
        print(f"cache-hit      : {hit_b:.0f} B on the wire "
              f"({first_b / hit_b:.0f}x less), {hit_s * 1e3:.1f}ms/future")
        assert hit_b < first_b / 100, "the tensor was shipped again"

        pid_before = rc.active_backend().worker_pids()
        rc.plan("threads", workers=2)               # interlude on threads
        rc.value(rc.future(lambda: "hi"))
        rc.plan("cluster", workers=1)               # warm pool re-attach
        pid_after = rc.active_backend().worker_pids()
        transport.reset_wire_stats()
        rc.value(rc.future(lambda: float(big[4])))
        replan_b = transport.wire_stats()["bytes_sent"]
        print(f"warm re-plan   : worker pids {pid_before} -> {pid_after} "
              f"(reused={pid_before == pid_after}), "
              f"{replan_b} B on the wire (cache still warm)")
    finally:
        transport.set_array_codec("raw")
        rc.shutdown()
        rc.plan("sequential")


if __name__ == "__main__":
    main()
