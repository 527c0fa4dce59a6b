"""Capture and relay of output and conditions (paper §Relaying).

Futures capture the *standard output* and all *conditions* (warnings, log
records, user messages) produced while the future expression evaluates, and
relay them in the parent process when ``value()`` is called:

* all captured stdout is relayed first, then conditions in signal order —
  exactly the paper's ordering contract;
* conditions of class :class:`ImmediateCondition` (e.g. progress updates) are
  allowed to be relayed *as soon as possible* — out-of-band, before
  ``value()`` — on backends that support it; non-supporting backends relay
  them with everything else at the end.

The capture machinery is deliberately backend-independent: every backend runs
the future body under :func:`capture_run` and gets back a
:class:`CapturedRun` that the parent replays with :func:`relay`.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import sys
import threading
import time
import traceback
import warnings
from typing import Any, Callable


# --------------------------------------------------------------------------
# Condition types
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Condition:
    """A captured condition, relayed in order at value()."""
    kind: str                 # "warning" | "message" | "log"
    payload: Any
    timestamp: float = 0.0

    def replay(self) -> None:
        if self.kind == "warning":
            category, text = self.payload
            warnings.warn(text, category, stacklevel=2)
        elif self.kind == "message":
            print(self.payload, file=sys.stderr)
        elif self.kind == "log":
            logging.getLogger(self.payload["name"]).handle(
                logging.makeLogRecord(self.payload))


@dataclasses.dataclass
class ImmediateCondition:
    """A condition relayed as soon as possible (paper: progress updates).

    Backends that have a live channel (threads, processes) forward these
    while the future is still running; others deliver them at value().
    """
    payload: Any
    timestamp: float = 0.0


class _ImmediateSink(threading.local):
    """Thread-local sink wired up by the executing backend."""
    def __init__(self):
        self.emit: Callable[[ImmediateCondition], None] | None = None
        self.collected: list[ImmediateCondition] | None = None


_SINK = _ImmediateSink()


def signal_progress(payload: Any) -> None:
    """Signal an immediateCondition from inside a future (progressr analogue).

    Outside of a future this is a no-op print-through so the same code runs
    un-futurized (the paper's 'same code with and without futures' aim).
    """
    cond = ImmediateCondition(payload, timestamp=time.time())
    if _SINK.emit is not None:
        _SINK.emit(cond)
    elif _SINK.collected is not None:
        _SINK.collected.append(cond)
    else:
        print(f"[progress] {payload}", file=sys.stderr)


def message(text: str) -> None:
    """R's message(): a condition sent to stderr, captured & relayed as-is."""
    if _CAPTURE.active is not None:
        _CAPTURE.active.conditions.append(
            Condition("message", text, time.time()))
    else:
        print(text, file=sys.stderr)


# --------------------------------------------------------------------------
# Capture
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CapturedRun:
    """Everything produced by one future evaluation."""
    value: Any = None
    error: BaseException | None = None
    error_tb: str | None = None
    stdout: str = ""
    conditions: list[Condition] = dataclasses.field(default_factory=list)
    immediate: list[ImmediateCondition] = dataclasses.field(default_factory=list)
    wall_time_s: float = 0.0
    rng_touched: bool = False


class _ActiveCapture(threading.local):
    def __init__(self):
        self.active: CapturedRun | None = None


_CAPTURE = _ActiveCapture()


class _LogTap(logging.Handler):
    def __init__(self, run: CapturedRun):
        super().__init__(level=logging.DEBUG)
        self.run = run

    def emit(self, record: logging.LogRecord) -> None:
        payload = dict(record.__dict__)
        payload.pop("exc_info", None)       # not always picklable
        payload.pop("args", None)
        payload["msg"] = record.getMessage()
        self.run.conditions.append(Condition("log", payload, time.time()))


class _StdoutRouter(io.TextIOBase):
    """Thread-aware stdout: writes from a thread evaluating a future go to
    that future's buffer; every other thread (e.g. the main thread while a
    threads-backend future runs) keeps the real stdout. A plain
    ``sys.stdout = buffer`` swap would swallow concurrent prints."""

    def __init__(self, real):
        self.real = real
        self.routes: dict[int, io.StringIO] = {}
        self.refs = 0

    def write(self, s):
        return (self.routes.get(threading.get_ident()) or self.real).write(s)

    def flush(self):
        (self.routes.get(threading.get_ident()) or self.real).flush()

    def writable(self):
        return True


_router_lock = threading.Lock()
#: one router per real stream, never freed: CPython 3.12's print() holds
#: sys.stdout by a borrowed reference across its writes, so a router that
#: another thread's release dropped mid-print would be freed under it
_routers: dict[int, _StdoutRouter] = {}


def _acquire_router() -> _StdoutRouter:
    with _router_lock:
        if isinstance(sys.stdout, _StdoutRouter):
            router = sys.stdout
        else:
            router = _routers.get(id(sys.stdout))
            if router is None:
                router = _routers[id(sys.stdout)] = _StdoutRouter(sys.stdout)
            sys.stdout = router
        router.refs += 1
        return router


def _release_router(router: _StdoutRouter) -> None:
    with _router_lock:
        router.refs -= 1
        if router.refs == 0 and sys.stdout is router:
            sys.stdout = router.real


def capture_run(fn: Callable[[], Any], *,
                capture_stdout: bool = True,
                capture_conditions: bool = True,
                immediate_emit: Callable[[ImmediateCondition], None] | None = None,
                ) -> CapturedRun:
    """Run ``fn`` capturing stdout, warnings, log records and exceptions.

    This is the single evaluation harness shared by all backends, which is
    what makes the relay behaviour identical everywhere (the paper's backend
    conformance requirement).
    """
    run = CapturedRun()
    t0 = time.time()

    prev_sink_emit, prev_sink_coll = _SINK.emit, _SINK.collected
    if immediate_emit is not None:
        _SINK.emit, _SINK.collected = immediate_emit, None
    else:
        _SINK.emit, _SINK.collected = None, run.immediate

    prev_active = _CAPTURE.active
    _CAPTURE.active = run if capture_conditions else None

    out_buf = io.StringIO()
    router = prev_route = None
    if capture_stdout:
        router = _acquire_router()
        prev_route = router.routes.get(threading.get_ident())
        router.routes[threading.get_ident()] = out_buf

    tap = _LogTap(run)
    root = logging.getLogger()
    if capture_conditions:
        root.addHandler(tap)

    try:
        if capture_conditions:
            with warnings.catch_warnings(record=True) as wlist:
                warnings.simplefilter("always")
                try:
                    run.value = fn()
                except BaseException as exc:        # noqa: BLE001 — relayed as-is
                    run.error = exc
                    run.error_tb = traceback.format_exc()
            for w in wlist:
                run.conditions.append(
                    Condition("warning", (w.category, str(w.message)),
                              time.time()))
        else:
            try:
                run.value = fn()
            except BaseException as exc:            # noqa: BLE001
                run.error = exc
                run.error_tb = traceback.format_exc()
    finally:
        if capture_stdout and router is not None:
            if prev_route is not None:      # nested capture on this thread
                router.routes[threading.get_ident()] = prev_route
            else:
                router.routes.pop(threading.get_ident(), None)
            _release_router(router)
        if capture_conditions:
            root.removeHandler(tap)
        _CAPTURE.active = prev_active
        _SINK.emit, _SINK.collected = prev_sink_emit, prev_sink_coll

    run.stdout = out_buf.getvalue()
    run.wall_time_s = time.time() - t0
    return run


def relay(run: CapturedRun, *, include_immediate: bool = True) -> Any:
    """Replay a CapturedRun in the parent: stdout first, then conditions in
    order (paper's contract), then raise or return.
    """
    if run.stdout:
        sys.stdout.write(run.stdout)
        sys.stdout.flush()
    if include_immediate:
        for cond in run.immediate:
            print(f"[progress] {cond.payload}", file=sys.stderr)
    for cond in run.conditions:
        cond.replay()
    if run.error is not None:
        raise run.error
    return run.value
