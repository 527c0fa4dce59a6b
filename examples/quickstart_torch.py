"""Quickstart on the PyTorch port: the Future API and the streaming
frontend built on it (the twin of ``examples/quickstart.py``).

The three constructs, plan(), relaying, parallel RNG, EITHER, retries,
stream() pipelines with bounded in-flight backpressure, the cooperative
asyncio lane, worker processes (``plan("processes")``: a dying worker and
the healed pool), a TCP cluster (``plan("cluster")``: a large result kept
on its worker and a continuation run there), and the port's own backend,
``cuda_async``: futures resolved by CUDA events on the card's stream.

Run on the GPU:  PYTHONPATH=src python examples/quickstart_torch.py
On the CPU:      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse
import asyncio
import itertools
import os
import time
import warnings

import torch

import repro_torch.core as rc
from repro_torch.core import (ListEnv, future, future_either, future_map,
                              plan, resolved, stream, value)
from repro_torch.core import rng as rng_mod
from repro_torch.device import resolve_device


def slow_fcn(x):
    time.sleep(0.05)
    return x * x


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # -- the three constructs (paper §Three atomic constructs) -------------
    plan("sequential")
    x = 1
    f = future(lambda: slow_fcn(x))
    x = 2                       # snapshot semantics: the future saw x == 1
    print("value(f) =", value(f), "(uses x=1, not x=2)")

    # -- end-user picks the backend; the code above does not change --------
    plan("threads", workers=2)
    fs = [future(lambda i=i: slow_fcn(i)) for i in range(3)]
    print("resolved? ", resolved(fs))
    print("values:   ", value(fs))

    # -- parallel for-loop via a list environment (paper: listenv) ---------
    env = ListEnv()
    for i in range(4):
        env[i] = future(lambda i=i: slow_fcn(i))
    print("listenv:  ", env.as_list())

    # -- streaming pipelines (the frontend layer on the three constructs) --
    s = stream(range(12), max_in_flight=4)
    print("stream:   ", s.map(slow_fcn, chunk=3).collect(ordered=True))
    print("          peak in-flight:", s.stats["peak_in_flight"],
          "of cap", s.stats["max_in_flight"])

    # -- streaming reduce over a generator too large to materialize --------
    big = (i for i in range(10_000_000))
    total = (stream(big, max_in_flight=4)
             .batch(500_000)
             .map(lambda xs: sum(v * v for v in xs), chunk=1)
             .reduce(lambda a, b: a + b))
    print("streamed sum of 10M squares:", total)

    # -- eager map-reduce (future.apply analogue; sugar over stream) -------
    print("future_map:", future_map(slow_fcn, range(8)))

    # -- exception + condition relay (paper §Exception handling/§Relaying) -
    def noisy():
        print("Hello world")
        warnings.warn("Missing values were omitted")
        print("Bye bye")
        return 55

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        v = value(future(noisy))
    print(f"noisy future -> {v}; relayed warnings: "
          f"{[str(x.message) for x in w]}")

    try:
        value(future(lambda: [0][3]))
    except IndexError as e:
        print("relayed as-is:", type(e).__name__, "-", e)

    # -- backend-invariant parallel RNG (paper §parallel RNG) --------------
    rc.set_session_seed(42)

    def draw(x, key):
        return float(rng_mod.normal(key, ()))

    a = future_map(draw, [0, 0, 0], seed=True, chunks=1)
    rc.set_session_seed(42)
    b = stream([0, 0, 0], max_in_flight=1).map(draw, seed=True).collect()
    print("rng invariant to frontend/chunking/in-flight:", a == b, a)

    # -- EITHER construct (paper §Other uses) -------------------------------
    winner = future_either(
        lambda: (time.sleep(2.0), "shell sort")[1],
        lambda: (time.sleep(0.01), "radix sort")[1],
    )
    print("future_either winner:", winner)

    # -- retry on infrastructure errors (paper §Future work: retry) --------
    class Flaky:
        tries = 0

    def flaky():
        Flaky.tries += 1
        if Flaky.tries == 1:
            raise rc.FutureError("lost on the first try")
        return "ok"

    print("retry:", rc.retry(flaky, times=3), "after", Flaky.tries, "tries")

    # -- cooperative concurrency: await f / async for (asyncio frontend) ----
    plan("asyncio")

    async def fetch(i):
        await asyncio.sleep(0.02 * (3 - i % 3))    # stand-in for real I/O
        return i * 10

    async def cooperative_demo():
        fs = [future(fetch, i) for i in range(6)]
        one = await fs[0]
        done = [await f async for f in rc.as_completed_async(fs)]
        squares = await (stream(range(8))
                         .map(lambda v: v * v)
                         .collect_async())
        return one, done, squares

    one, done, squares = asyncio.run(cooperative_demo())
    print("await f:  ", one)
    print("async for:", done, "(completion order)")
    print("stream.collect_async:", squares)

    # -- worker processes + fault tolerance (the paper's multisession) -----
    plan("processes", workers=2)
    print("worker pid:", value(future(lambda: os.getpid()), timeout=120),
          "(parent:", str(os.getpid()) + ")")

    def die():
        os._exit(9)

    try:
        value(future(die), timeout=120)
    except rc.WorkerDiedError as e:
        print("node failure detected:", e)
    print("pool self-healed:", value(future(lambda: "alive"), timeout=120))

    # -- a TCP cluster (the paper's PSOCK cluster) -------------------------
    #
    # The driver launches two workers that dial back over loopback with a
    # token. A large result stays on the worker that made it; a chained
    # continuation runs there, and value() pulls the bytes.
    plan("cluster", workers=2, token=os.urandom(8).hex())
    big = future(lambda: torch.arange(1 << 16, dtype=torch.float32,
                                      device=device))
    where = big.then(lambda t: (os.getpid(), float(t.sum())))
    pid, total = value(where, timeout=120)
    print(f"cluster: the chain ran on worker {pid}, sum {total:.0f}; "
          f"value() pulled {tuple(value(big, timeout=120).shape)} "
          f"onto {device}")

    # -- futures over the card's stream: plan("cuda_async") ----------------
    #
    # The body runs on this thread and only enqueues kernels; a CUDA event
    # recorded after them resolves the future. Host work overlaps the card
    # until value() (device="cpu" is the synchronous form).
    plan("cuda_async", device=device)
    m = torch.randn(1024, 1024, device=device)
    t0 = time.perf_counter()
    f = future(lambda: torch.linalg.matrix_power(m / 32, 16).norm())
    submit_ms = (time.perf_counter() - t0) * 1e3
    print(f"cuda_async on {device}: submitted in {submit_ms:.2f} ms, "
          f"resolved at once? {resolved(f)}, value {float(value(f)):.4f}")
    sums = future_map(lambda t: t.sum(), [m[i::4] for i in range(4)])
    print("cuda_async future_map of 4 slices sums to the whole:",
          bool(torch.allclose(sum(sums), m.sum(), rtol=1e-4, atol=1e-2)))

    # -- an unbounded source with as_completed(): take five and move on ----
    plan("threads", workers=2)
    first_five = []
    for r in stream(itertools.count()).map(lambda v: v * 10, chunk=2) \
            .as_completed():
        first_five.append(r)
        if len(first_five) >= 5:
            break
    print("first five from an unbounded stream:", sorted(first_five))
    rc.shutdown()


if __name__ == "__main__":
    main()
