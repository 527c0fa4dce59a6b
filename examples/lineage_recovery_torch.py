"""Lineage-based recovery of lost worker-resident results on the port (the
twin of ``examples/lineage_recovery.py``).

Large cluster results stay on the producing worker (the driver holds a
content-addressed ``RemoteValue``; a tensor on the card is kept as a host
blob and rebuilt on the card of whoever decodes it). When the holder dies:

1. **Reconstruction.** The driver recorded, per held digest, the producing
   task (its frozen RNG stream key and content-addressed input refs) and
   its remote parents. A pull or a dependent dispatch that finds no live
   copy runs that task again on a surviving worker, parents first; the
   bytes come back under the original digest, bit for bit.
   ``lineage_max_depth`` and ``lineage_max_attempts`` turn pathological
   cases into a clear ``LineageExhaustedError``.

2. **Replication.** ``plan("cluster", ..., min_replicas=2)`` pushes a
   second copy of every newly held result to another worker, so a single
   holder death needs no re-execution at all.

Run on the GPU:  PYTHONPATH=src python examples/lineage_recovery_torch.py
On the CPU:      PYTHONPATH=src python examples/lineage_recovery_torch.py --device cpu
"""

import argparse
import os
import signal
import time

import torch

import repro_torch.core as rc
from repro_torch.core import future
from repro_torch.device import resolve_device

N = 1 << 19                                  # 2 MiB of float32

#: fast-heal knobs: a dead worker is seen and relaunched within seconds
FAST = dict(heartbeat_interval=0.1, heartbeat_timeout=3.0,
            relaunch_backoff=0.05, relaunch_backoff_cap=0.2)


def kill_one_holder(backend, digest) -> int:
    """SIGKILL one worker the driver lists as a holder of ``digest``, then
    wait until the death verdict prunes it from the location map (driver
    state, not a sleep)."""
    wids = backend.locations(digest)
    with backend._pool_cv:
        wid, pid = next((w.wid, w.meta.get("pid"))
                        for w in backend._all if w.wid in wids)
    os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + 30.0
    while wid in backend.locations(digest) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    return pid


def demo_reconstruction(device) -> None:
    print("== reconstruction: kill the sole holder, chain anyway ==")
    rc.plan("cluster", hosts=2, token=os.urandom(8).hex(), **FAST)
    backend = rc.active_backend()
    want = torch.arange(N, dtype=torch.float32, device=device) + 3.0
    f = future(lambda: torch.arange(N, dtype=torch.float32,
                                    device=device) + 3.0)
    digest = backend.collect(f._handle).value.digest
    pid = kill_one_holder(backend, digest)
    print(f"killed holder pid {pid}; locations now "
          f"{set(backend.locations(digest))}")
    g = f.then(lambda a: float(a.double().sum()))
    assert g.value(timeout=120) == float(want.double().sum())
    stats = backend.recovery_stats()
    print(f"chain resolved to {g.value():.1f} (exact); "
          f"recovery_stats={stats}")
    assert stats["reconstructions"] >= 1
    got = f.value()
    assert got.device.type == device.type and torch.equal(got.cpu(),
                                                          want.cpu())
    print("pull by the original digest: bit-identical bytes\n")
    rc.shutdown()


def demo_replication(device) -> None:
    print("== min_replicas=2: same death, zero re-executions ==")
    rc.plan("cluster", hosts=2, min_replicas=2, token=os.urandom(8).hex(),
            **FAST)
    backend = rc.active_backend()
    f = future(lambda: torch.arange(N, dtype=torch.float32,
                                    device=device) + 7.0)
    digest = backend.collect(f._handle).value.digest
    deadline = time.monotonic() + 30.0
    while len(backend.locations(digest)) < 2 \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    print(f"replicated to workers {sorted(backend.locations(digest))}")
    kill_one_holder(backend, digest)         # one of the two holders
    g = f.then(lambda a: float(a.double().sum()))
    want = (torch.arange(N, dtype=torch.float64) + 7.0).sum().item()
    assert g.value(timeout=120) == want
    stats = backend.recovery_stats()
    print(f"chain served by the surviving replica; recovery_stats={stats}")
    assert stats["reconstructions"] == 0, "a replica means no re-execution"
    rc.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args().device)
    demo_reconstruction(device)
    demo_replication(device)
    rc.plan("sequential")
    print("OK: lost results rebuilt digest-identical; replicas make "
          "recovery free")


if __name__ == "__main__":
    main()
