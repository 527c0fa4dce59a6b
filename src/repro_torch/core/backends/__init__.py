"""Future backends of the port: sequential | threads | processes | cluster |
asyncio | cuda_async.

* ``sequential`` — eager, in-process; the conformance reference.
* ``threads`` — in-process thread pool (shared memory, zero-copy globals).
* ``processes`` — spawned worker processes (the paper's multisession):
  functions and snapshotted globals shipped over pipes, large ones
  content-addressed (``blobstore.py``, ``transport.py``, ``worker.py``).
* ``cluster`` — real TCP sockets (the paper's PSOCK cluster): a
  select-driven driver plus connect-back workers (``cluster.py`` /
  ``cluster_worker.py``) that the driver bootstraps itself through the
  launcher subsystem (``launchers.py``: local subprocess, ssh, or a
  scheduler command template); large results stay on the worker that made
  them (``blobstore.RemoteValue``).
* ``asyncio`` — one event loop thread; ``async def`` bodies are cooperative
  tasks, so thousands of I/O-bound futures fit in flight without a thread
  each.
* ``cuda_async`` — PyTorch's asynchronous CUDA dispatch surfaced as
  futures: the body enqueues on the caller's thread, a CUDA event marks
  its device work, ``resolved`` is ``event.query()``.

All six implement the push completion kernel (see ``base.py``):
``Backend.add_done_callback(handle, cb)`` fires exactly once from the
completing thread (a worker, a pipe's I/O thread, the cluster driver's
select loop, the event loop, a CUDA-event watcher), which powers the
continuation combinators (``then`` / ``map`` / ``recover`` / ``gather`` /
``first`` …) and the cross-backend ``Waiter`` under ``resolve()`` /
``as_completed()`` / ``wait_any()`` / ``future_map``.
"""
