"""Future backends of the port: sequential | threads | asyncio | cuda_async.

* ``sequential`` — eager, in-process; the conformance reference.
* ``threads`` — in-process thread pool (shared memory, zero-copy globals).
* ``asyncio`` — one event loop thread; ``async def`` bodies are cooperative
  tasks, so thousands of I/O-bound futures fit in flight without a thread
  each.
* ``cuda_async`` — PyTorch's asynchronous CUDA dispatch surfaced as
  futures: the body enqueues on the caller's thread, a CUDA event marks
  its device work, ``resolved`` is ``event.query()``.

All four implement the push completion kernel (see ``base.py``):
``Backend.add_done_callback(handle, cb)`` fires exactly once from the
completing thread (a worker, the event loop, a CUDA-event watcher), which
powers the continuation combinators (``then`` / ``map`` / ``recover`` /
``gather`` / ``first`` …) and the cross-backend ``Waiter`` under
``resolve()`` / ``as_completed()`` / ``wait_any()`` / ``future_map``.
The process and cluster backends come in a later slice of the port.
"""
