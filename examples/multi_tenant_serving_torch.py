"""Multi-tenant serving on the port: two client *processes*, one warm
cluster (the twin of ``examples/multi_tenant_serving.py``).

One long-lived server wraps a warm cluster behind token auth (TLS too
with ``--tls``, which needs the ``openssl`` binary); any number of client
processes ``plan("serving", addr=..., token=...)`` and get the full
Future/stream/state API, each mapped to a *tenant* with a fair-share
weight. Tensors cross the sessions as their bytes and are rebuilt on the
receiver's device of their type.

This script plays both roles:

* no ``--client`` — the **server**: starts ``serve()`` with two tenant
  credentials (alice weight 3, bob weight 1), spawns itself twice as
  client subprocesses, then prints the per-tenant attribution the
  fair-share scheduler recorded;
* ``--client ADDR TENANT TOKEN CA`` — a **client**: plans onto the
  serving backend and runs a ``stream()`` of tensor sums plus a
  shared-state fold, as it would against a private cluster. Each tenant's
  state namespace is its own: both clients use the same key.

Run on the GPU:  PYTHONPATH=src python examples/multi_tenant_serving_torch.py
On the CPU:      PYTHONPATH=src python examples/multi_tenant_serving_torch.py --device cpu
"""

import argparse
import os
import subprocess
import sys
import time

ITEMS = 24


def run_client(addr: str, tenant: str, token: str, ca: str,
               device: str) -> None:
    import torch

    import repro_torch.core as rc
    from repro_torch.core import plan, state, stream
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    plan("serving", addr=addr, token=token, tls_ca=ca)
    t0 = time.perf_counter()

    # admission flows through the session's free_slots RPC, dispatch
    # through the server's fair-share scheduler
    total = (stream(range(ITEMS))
             .map(lambda i: int((torch.arange(i + 1, device=dev) ** 2)[-1]))
             .reduce(lambda a, b: a + b))
    assert total == sum(i * i for i in range(ITEMS))

    # shared state, namespaced per tenant: both clients fold into
    # "progress" yet never see each other's counter
    for _ in range(5):
        state.add("progress", 1)
    done, _ver = state.add("progress", 0)
    assert done == 5

    stats = rc.planning.active_backend().session_stats()
    wall = time.perf_counter() - t0
    print(f"[{tenant}] sum(i^2, i<{ITEMS}) = {total}, "
          f"progress = {done}, "
          f"completed = {stats['tenant_stats']['completed']}, "
          f"bytes_sent = {stats['tenant_stats']['bytes_sent']}, "
          f"{wall:.2f}s", flush=True)
    plan("sequential")
    rc.shutdown()


def run_server(device: str, tls: bool) -> None:
    from repro_torch.core.serving import serve

    tokens = {name: os.urandom(8).hex() for name in ("alice", "bob")}
    with serve({"workers": 2},
               tokens=tokens,
               tenants={"alice": {"weight": 3.0},
                        "bob": {"weight": 1.0}},
               tls=tls or None) as srv:
        host, port = srv.address
        addr = f"{host}:{port}"
        print(f"server: cluster of {srv.inner.workers} workers behind "
              f"{'TLS+' if tls else ''}token on {addr}", flush=True)
        ca = srv.tls.certfile if srv.tls else ""
        clients = [
            subprocess.Popen([sys.executable, __file__, "--device", device,
                              "--client", addr, name, tokens[name], ca])
            for name in tokens
        ]
        for p in clients:
            rc = p.wait(timeout=180)
            assert rc == 0, f"client exited {rc}"
        print("server: per-tenant attribution",
              srv.inner.tenant_stats(), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tls", action="store_true",
                    help="serve TLS with a self-signed cert (needs openssl)")
    ap.add_argument("--client", nargs=4,
                    metavar=("ADDR", "TENANT", "TOKEN", "CA"))
    args = ap.parse_args()
    if args.client:
        run_client(*args.client, device=args.device)
    else:
        from repro_torch.device import resolve_device
        resolve_device(args.device)          # no card: fail here, not later
        run_server(args.device, args.tls)


if __name__ == "__main__":
    main()
