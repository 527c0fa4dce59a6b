"""plan(asyncio): cooperative futures on one event loop.

The serving-scale lane: every other backend parks an OS thread (or a whole
process) per in-flight future, which caps I/O-bound concurrency at
thousands per host. This backend dispatches task bodies onto a single
dedicated event loop — an ``async def`` body costs one asyncio task (~KBs,
no stack, no thread) while it waits, so tens of thousands of futures can be
in flight in one process.

Contract parity with the rest of the matrix:

* **sync bodies** run inline on the loop thread under the same
  ``capture_run`` harness as the threads backend — cooperative
  serialization, identical relay/RNG/nesting semantics;
* **async bodies** (a body returning an awaitable) are driven to completion
  by re-entering the capture context around every *synchronous segment*
  between awaits: stdout routing is keyed by thread ident
  (``conditions._StdoutRouter``), and interleaved tasks share the loop
  thread, so capture must be scoped to the running segment, not the whole
  coroutine. Captures of all segments are merged into one
  :class:`CapturedRun`, so ``value()`` relays exactly what a threads-backend
  future would have relayed;
* **admission** maps ``free_slots``/``try_submit`` to an in-flight *task
  count* cap (``tasks=``, default 1024 — cooperative tasks are cheap), so
  ``stream()`` backpressure works unchanged;
* **cancellation** is real and cooperative: ``cancel()`` throws
  ``CancelledError`` into the body at its next suspension point, resolving
  the future with :class:`FutureCancelledError`.

Blocking ``value()``/``wait()`` calls *from the loop thread itself* would
deadlock the loop; they raise a descriptive ``RuntimeError`` instead — use
``await f`` inside async bodies. Nested futures created inside a body take
the popped plan stack like every backend (sequential by default), so plain
``value()`` on a nested future keeps working.
"""

from __future__ import annotations

import asyncio
import inspect
import queue
import threading
import types

from ..conditions import CapturedRun, ImmediateCondition, capture_run
from ..errors import FutureCancelledError
from .. import planning as plan_mod
from ..rng import rng_scope
from .base import (Backend, CompletionHandle, EventWaitMixin,
                   SlotCounterMixin, TaskSpec, register_backend)


class _Handle(CompletionHandle):
    def __init__(self, task: TaskSpec):
        super().__init__()
        self.task = task
        self.run: CapturedRun | None = None
        self.immediate: queue.SimpleQueue[ImmediateCondition] = queue.SimpleQueue()
        self.cancelled = False
        self.aio_task: "asyncio.Task | None" = None      # set on the loop


@types.coroutine
def _forward(yielded):
    """Re-yield whatever the driven coroutine yielded out to the real event
    loop, and hand the loop's answer (value or thrown exception) back in —
    one suspension point of the segmented capture driver."""
    return (yield yielded)


@register_backend("asyncio")
class AsyncioBackend(SlotCounterMixin, EventWaitMixin, Backend):
    supports_immediate = True
    # dispatches_continuations stays False: try_submit would run the
    # continuation as a loop task; user code inside it may block (value()
    # on a foreign future), which must never happen on the loop thread.
    # Continuations take the slot-free continuation pool, as for threads.

    #: default in-flight task cap — an admission bound for stream()
    #: backpressure, not an OS-resource count (tasks are heap objects)
    DEFAULT_TASKS = 1024

    def __init__(self, tasks: "int | None" = None,
                 workers: "int | None" = None):
        # ``tasks=`` is the natural name for a coroutine cap; ``workers=``
        # is accepted as an alias so generic spec-tweak code works.
        self._cap = int(tasks or workers or self.DEFAULT_TASKS)
        self._init_slots(self._cap)
        self._nested = plan_mod.nested_stack()
        self._init_wait()
        self._open = True
        self._loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._loop_main,
                                        name="asyncio-backend-loop",
                                        daemon=True)
        self._thread.start()
        self._ready.wait()

    def _loop_main(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.call_soon(self._ready.set)
        try:
            self._loop.run_forever()
        finally:
            try:
                self._loop.close()
            except Exception:                            # noqa: BLE001
                pass

    # -- admission -----------------------------------------------------------

    def submit(self, task: TaskSpec) -> _Handle:
        self._acquire_slot()          # paper semantics at the cap edge
        return self._start(task)

    def try_submit(self, task: TaskSpec) -> "_Handle | None":
        if not self._acquire_slot(blocking=False):
            return None
        return self._start(task)

    def _start(self, task: TaskSpec) -> _Handle:
        handle = _Handle(task)
        try:
            if not self._open:
                raise RuntimeError("asyncio backend is shut down")
            self._loop.call_soon_threadsafe(self._begin, handle)
        except RuntimeError:
            self._release_slot()
            raise
        return handle

    def _begin(self, handle: _Handle) -> None:
        # loop thread: promote the submitted handle to a live task
        handle.aio_task = self._loop.create_task(self._run_task(handle))

    # -- evaluation (loop thread) ---------------------------------------------

    def _capture_seg(self, step, task: TaskSpec, handle: _Handle
                     ) -> CapturedRun:
        """One synchronous segment under the shared evaluation harness —
        the exact scope (nested plan, RNG declaration, capture) a threads
        worker wraps around the whole body."""
        with plan_mod.use_nested_stack(self._nested):
            with rng_scope(task.seed_declared):
                return capture_run(
                    step,
                    capture_stdout=task.capture_stdout,
                    capture_conditions=task.capture_conditions,
                    immediate_emit=handle.immediate.put,
                )

    async def _run_task(self, handle: _Handle) -> None:
        task = handle.task
        try:
            if handle.cancelled:
                run = CapturedRun(error=FutureCancelledError(
                    "future cancelled before it started",
                    future_label=task.label))
            else:
                run = self._capture_seg(
                    lambda: task.fn(*task.args, **task.kwargs), task, handle)
                if run.error is None and inspect.isawaitable(run.value):
                    run = await self._drive(run, task, handle)
            if run.error is not None and \
                    isinstance(run.error, asyncio.CancelledError):
                run = CapturedRun(
                    error=FutureCancelledError(
                        f"future {task.label!r} cancelled",
                        future_label=task.label),
                    stdout=run.stdout, conditions=run.conditions,
                    immediate=run.immediate, wall_time_s=run.wall_time_s)
            handle.run = run
        except asyncio.CancelledError:
            handle.run = CapturedRun(error=FutureCancelledError(
                f"future {task.label!r} cancelled", future_label=task.label))
        except BaseException as exc:                     # noqa: BLE001
            handle.run = CapturedRun(error=exc)
        finally:
            self._release_slot()
            self._complete(handle)   # done-callbacks fire from the loop

    async def _drive(self, head: CapturedRun, task: TaskSpec,
                     handle: _Handle) -> CapturedRun:
        """Drive an awaitable body to completion, re-entering the capture
        context around every synchronous segment and merging the segment
        captures (plus ``head``, the capture of the call that produced the
        awaitable) into one run."""
        aw = head.value
        it = aw if inspect.iscoroutine(aw) else aw.__await__()
        run = CapturedRun(stdout=head.stdout,
                          conditions=head.conditions,
                          immediate=head.immediate,
                          wall_time_s=head.wall_time_s,
                          rng_touched=head.rng_touched)
        if not hasattr(it, "send"):
            # a non-generator awaitable runs no user code per segment (e.g.
            # a plain asyncio.Future): await it without segmentation
            try:
                run.value = await aw
            except asyncio.CancelledError:
                raise
            except BaseException as exc:                 # noqa: BLE001
                import traceback
                run.error, run.error_tb = exc, traceback.format_exc()
            return run
        to_send, to_throw = None, None
        while True:
            def _step(_v=to_send, _e=to_throw):
                if _e is not None:
                    return it.throw(_e)
                return it.send(_v)

            seg = self._capture_seg(_step, task, handle)
            run.stdout += seg.stdout
            run.conditions += seg.conditions
            run.immediate += seg.immediate
            run.wall_time_s += seg.wall_time_s
            run.rng_touched |= seg.rng_touched
            if seg.error is not None:
                if isinstance(seg.error, StopIteration):
                    run.value = seg.error.value          # body returned
                else:
                    run.error, run.error_tb = seg.error, seg.error_tb
                return run
            # body suspended: hand its yield to the real loop; a
            # cancellation (or any wake-up exception) is thrown *into* the
            # body next segment so its except/finally blocks run captured
            try:
                to_send, to_throw = await _forward(seg.value), None
            except BaseException as exc:                 # noqa: BLE001
                to_send, to_throw = None, exc

    # -- resolution side -------------------------------------------------------

    def _guard_loop_thread(self) -> None:
        if threading.current_thread() is self._thread:
            raise RuntimeError(
                "blocking value()/wait() on an asyncio-backend future from "
                "the event-loop thread would deadlock the loop — use "
                "`await f` inside async task bodies")

    def poll(self, handle: _Handle) -> bool:
        return handle.done.is_set()

    def collect(self, handle: _Handle) -> CapturedRun:
        if not handle.done.is_set():
            self._guard_loop_thread()
        handle.done.wait()
        assert handle.run is not None
        return handle.run

    def wait(self, handles, timeout=None):
        if not all(h.done.is_set() for h in handles):
            self._guard_loop_thread()
        return super().wait(handles, timeout=timeout)

    def drain_immediate(self, handle: _Handle) -> list[ImmediateCondition]:
        out = []
        while True:
            try:
                out.append(handle.immediate.get_nowait())
            except queue.Empty:
                return out

    def cancel(self, handle: _Handle) -> bool:
        handle.cancelled = True          # not-yet-begun tasks never start
        if handle.done.is_set():
            return False

        def _kill():
            if handle.aio_task is not None and not handle.aio_task.done():
                handle.aio_task.cancel()

        try:
            self._loop.call_soon_threadsafe(_kill)
        except RuntimeError:
            pass                          # loop already stopped
        return not handle.done.is_set() and handle.run is None

    def shutdown(self) -> None:
        if not self._open:
            return
        self._open = False

        async def _drain_and_stop():
            me = asyncio.current_task()
            tasks = [t for t in asyncio.all_tasks() if t is not me]
            for t in tasks:
                t.cancel()
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
            self._loop.stop()

        try:
            asyncio.run_coroutine_threadsafe(_drain_and_stop(), self._loop)
        except RuntimeError:
            return                        # loop already gone
        self._thread.join(timeout=5)

    @property
    def workers(self) -> int:
        return self._cap
