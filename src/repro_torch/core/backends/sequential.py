"""plan(sequential): resolve futures synchronously in the current process.

Per the paper, under the sequential plan ``future()`` itself blocks until the
(previous) future is resolved — i.e. evaluation happens eagerly at creation,
and ``value()`` merely relays. This backend is also the default, and the
reference against which all other backends are conformance-tested.
"""

from __future__ import annotations

from ..conditions import CapturedRun, capture_run
from .. import planning as plan_mod
from ..rng import rng_scope
from .base import Backend, TaskSpec, register_backend


@register_backend("sequential")
class SequentialBackend(Backend):
    supports_immediate = True        # relayed, err, immediately
    # the caller's thread *is* the worker: submission never blocks waiting
    # for capacity, and a continuation dispatched here runs inline —
    # consistent with the plan's fully synchronous semantics. The
    # dispatcher additionally requires the firing thread to be outside any
    # worker's nested-plan context (see _spawn_continuation): a borrowed
    # thread that holds a bounded slot must never run continuations inline.
    dispatches_continuations = True

    def free_slots(self) -> int:
        # evaluation is synchronous at submit(): there is always exactly
        # one slot, and it is always free by the time anyone can ask —
        # the inherited try_submit therefore always forwards to submit()
        return 1

    def submit(self, task: TaskSpec) -> CapturedRun:
        with plan_mod.use_nested_stack():
            with rng_scope(task.seed_declared):
                run = capture_run(
                    lambda: task.fn(*task.args, **task.kwargs),
                    capture_stdout=task.capture_stdout,
                    capture_conditions=task.capture_conditions,
                )
        return run

    def poll(self, handle: CapturedRun) -> bool:
        return True

    def collect(self, handle: CapturedRun) -> CapturedRun:
        return handle

    def wait(self, handles, timeout=None):
        # Everything resolved eagerly at submit: wait() is immediate.
        return list(handles)

    def add_done_callback(self, handle, cb):
        # Everything resolved eagerly at submit: fire synchronously.
        cb(handle)
