"""Multi-pod training under failures on the port (the twin of
``examples/cluster_faults.py``): the paper's fault-tolerance story.

Runs the port's multi-pod driver (``repro_torch.launch.train``), each pod a
worker process connected to the TCP socket cluster backend, while
injecting: (1) a hard node failure mid-round, (2) a straggler pod raced by
a speculative duplicate, (3) an elastic resize between rounds. The run
must finish with a decreasing loss despite all three.

Worker bootstrap is the launcher subsystem's job: ``plan("cluster",
hosts=N)`` spawns N local workers via the default ``LocalLauncher``; an
``SSHLauncher`` or ``CommandLauncher`` bootstraps real machines with the
same line (see the twin's docstring). Either way the driver owns the fault
story: a dead worker's future fails with ``WorkerDiedError`` and a
replacement is relaunched on the same host with capped exponential backoff
(see ``core/backends/cluster.py``).

Run on the GPU:  PYTHONPATH=src python examples/cluster_faults_torch.py
On the CPU:      PYTHONPATH=src python examples/cluster_faults_torch.py --device cpu
"""

import argparse
import tempfile
import time

import repro_torch.core as rc
from repro_torch.device import resolve_device
from repro_torch.launch.train import MultiPodDriver, PodRunConfig


def demo_launcher_bootstrap():
    """The zero-hand-launched-processes loop, end to end: plan -> launched
    workers -> futures -> shutdown reaps everything."""
    rc.plan("cluster", hosts=2)           # LocalLauncher bootstraps 2 workers
    backend = rc.active_backend()
    print(f"launched workers (pids {backend.worker_pids()}) "
          f"on {backend.address}")
    assert rc.future_map(lambda x: x * x, [1, 2, 3, 4]) == [1, 4, 9, 16]
    rc.shutdown()
    print("launcher bootstrap OK: zero hand-launched processes")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args().device).type
    demo_launcher_bootstrap()
    tmp = tempfile.mkdtemp(prefix="repro-torch-cluster-")
    cfg = PodRunConfig(
        arch="xlstm-125m", pods=2, rounds=4, local_steps=3,
        batch=2, seq=32, smoke=True, device=device,
        ckpt_dir=f"{tmp}/ckpt",
        fail_marker=f"{tmp}/pod0-die-once",     # pod 0 dies on first touch
        straggle_pod=1, straggle_s=20.0,        # pod 1 is slow in round 0
        straggler_timeout_s=3.0,                # ... and gets raced
    )
    print(f"2 pods on {device}, 4 rounds; node-failure + straggler "
          f"injected; {tmp}")
    driver = MultiPodDriver(cfg)

    t0 = time.time()
    rec0 = driver.run_round(0)
    print(f"round 0 survived failure+straggler: loss={rec0['loss']:.4f} "
          f"({time.time() - t0:.1f}s, straggler was 20s)")
    driver.cfg.straggle_pod = None              # back to healthy pods

    rec1 = driver.run_round(1)
    print(f"round 1: loss={rec1['loss']:.4f}")

    print("elastic resize: 2 -> 3 pods")
    driver.resize(3)
    for rnd in (2, 3):
        rec = driver.run_round(rnd)
        print(f"round {rnd} (3 pods): loss={rec['loss']:.4f}")
        if driver.ckpt:
            driver.ckpt.save(rnd + 1, {str(i): p for i, p in
                                       enumerate(driver.params)})
    if driver.ckpt:
        driver.ckpt.wait()
        print("checkpoint at step", driver.ckpt.latest_step())

    losses = [h["loss"] for h in driver.history]
    print(f"losses: {['%.3f' % l for l in losses]}")
    assert losses[-1] < losses[0], "training failed to progress"
    print("OK: converged through failure, straggler, and resize")
    rc.shutdown()


if __name__ == "__main__":
    main()
