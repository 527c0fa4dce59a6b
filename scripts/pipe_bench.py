#!/usr/bin/env python3
"""Times one large message between two spawned processes over a
multiprocessing Pipe, as the processes backend sends a worker the
parameters' blob: the connection's own ``send_bytes``/``recv_bytes``
against the backend's ``Channel`` (``repro_torch.core.backends.worker``),
which reads a message into one buffer of its length.

    python3 scripts/pipe_bench.py [--mb 580]

Each route moves the same random message once, child to parent, after a
handshake (so the child's start is not timed), and is checked equal. Prints
the host's CPU count and each route's seconds and GB/s; the last line is a
JSON object with every number. Needs no card: it measures the host.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(conn, route: str, nbytes: int) -> None:
    from repro_torch.core.backends.worker import Channel
    blob = os.urandom(1 << 20) * (nbytes >> 20)
    ch = Channel(conn)
    ch.send(("ready",))
    ch.recv()                                # go
    if route == "recv_bytes":
        conn.send_bytes(blob)
    else:
        ch.send(("put", b"d" * 16, blob))
    ch.recv()                                # done


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=580)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import multiprocessing as mp

    from repro_torch.core.backends.worker import Channel

    nbytes = args.mb << 20
    ctx = mp.get_context("spawn")
    print(f"host: {os.cpu_count()} CPUs; one message of {nbytes} bytes")
    result = {"bytes": nbytes, "cpus": os.cpu_count()}
    for route in ("Channel", "recv_bytes"):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_child, args=(child, route, nbytes))
        proc.start()
        child.close()
        ch = Channel(parent)
        assert ch.recv() == ("ready",)
        ch.send(("go",))
        t0 = time.perf_counter()
        if route == "recv_bytes":
            got = parent.recv_bytes()
        else:
            got = ch.recv()[2]
        secs = time.perf_counter() - t0
        ch.send(("done",))
        proc.join(timeout=60)
        if len(got) != nbytes or proc.exitcode != 0:
            print(f"pipe_bench: {route} moved {len(got)} bytes, child exit "
                  f"{proc.exitcode}", file=sys.stderr)
            return 1
        result[route] = {"s": secs, "GB_per_s": nbytes / secs / 1e9}
        print(f"{route}: {secs:.3f} s, {nbytes / secs / 1e9:.3f} GB/s",
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
