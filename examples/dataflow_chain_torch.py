"""Worker-to-worker dataflow on the port: locality-scheduled continuation
chains (the twin of ``examples/dataflow_chain.py``).

On ``plan("cluster")`` a task result above ``RESULT_REF_THRESHOLD`` stays
resident on the producing worker as a content-addressed blob. The driver's
result frame carries a small ``RemoteValue`` handle plus the digest's
holder; each ``then``/``map`` hop is scheduled *onto the holder* as a
~500 B control frame, and only the final ``value()`` pull moves real
bytes. A tensor on the card stays on the holder's card between hops (its
blob is a host copy kept in the holder's store, decoded back onto the
card by the next hop).

This demo runs the same 3-link chain with results worker-resident and
driver-gathered (``remote_results=False``) and prints the driver's wire
traffic a chain; the values are the same either way.

Run on the GPU:  PYTHONPATH=src python examples/dataflow_chain_torch.py
On the CPU:      PYTHONPATH=src python examples/dataflow_chain_torch.py --device cpu
"""

import argparse
import os
import time

import torch

import repro_torch.core as rc
from repro_torch.core.backends import transport
from repro_torch.device import resolve_device

N = 1 << 21                                  # 8 MiB of float32 a link


def run_chain(device) -> float:
    f = rc.future(lambda: torch.arange(N, dtype=torch.float32,
                                       device=device))
    return (f.then(lambda a: a + 1.0)        # hop 1: runs on f's holder
             .then(lambda a: a * 2.0)        # hop 2: same holder
             .then(lambda a: float(a[-1]))   # hop 3: a scalar comes home
             .value())


def measure(device, remote_results: bool, reps: int = 3):
    rc.plan("cluster", workers=2, remote_results=remote_results,
            token=os.urandom(8).hex())
    rc.value(rc.future(lambda: 1))           # warm connections
    run_chain(device)                        # warm the workers' devices
    transport.reset_wire_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        assert run_chain(device) == float(N) * 2.0
    dt = (time.perf_counter() - t0) / reps
    stats = transport.wire_stats()
    rc.shutdown()
    return (stats["bytes_sent"] + stats["bytes_recv"]) / reps, dt


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args().device)
    legacy_b, legacy_s = measure(device, remote_results=False)
    print(f"driver-gathered : {legacy_b:>12,.0f} B through driver/chain, "
          f"{legacy_s * 1e3:.1f}ms/chain")
    flow_b, flow_s = measure(device, remote_results=True)
    print(f"worker-resident : {flow_b:>12,.0f} B through driver/chain, "
          f"{flow_s * 1e3:.1f}ms/chain")
    print(f"reduction       : ~{legacy_b / max(flow_b, 1):.0f}x fewer "
          f"bytes through the driver")
    assert flow_b < legacy_b / 10, "the chain did not stay on the workers"

    # value() is the explicit pull: until then the intermediate lives only
    # in a worker's blob store
    rc.plan("cluster", workers=2)
    f = rc.future(lambda: torch.arange(N, dtype=torch.float32,
                                       device=device))
    g = f.then(lambda a: float(a.double().sum()))
    print(f"g.value() pulls : {g.value():.0f} (computed where a lived, "
          f"on {device})")
    rc.shutdown()
    rc.plan("sequential")


if __name__ == "__main__":
    main()
