"""Future backends of the port: sequential | threads.

* ``sequential`` — eager, in-process; the conformance reference.
* ``threads`` — in-process thread pool (shared memory, zero-copy globals).

Both implement the push completion kernel (see ``base.py``):
``Backend.add_done_callback(handle, cb)`` fires exactly once from the
completing thread, which powers the continuation combinators (``then`` /
``map`` / ``recover`` / ``gather`` / ``first`` …) and the cross-backend
``Waiter`` under ``resolve()`` / ``as_completed()`` / ``wait_any()``.
The process, cluster, asyncio and CUDA-stream backends come in later
slices of the port.
"""
