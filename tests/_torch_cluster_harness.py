"""Deterministic fault injection for the port's TCP cluster stack.

The port's copy of ``tests/_cluster_harness.py``: it imports only
``repro_torch``. Not collected (leading underscore).

:class:`HarnessLauncher` wraps a real :class:`~repro_torch.core.backends.
launchers.Launcher` and records every :class:`WorkerProc` it hands to the
driver, so tests can kill / stall / partition a *chosen* worker at a
*chosen* moment — deterministic chaos instead of hoping a kill lands
mid-dispatch.

The synchronization idiom for "kill mid-task": the task body writes its own
pid into a marker file and then blocks; :meth:`HarnessLauncher.
kill_on_pidfile` arms a watcher thread that SIGKILLs exactly that worker
the moment the marker appears. The retry of the chunk sees the marker and
returns — so the kill is guaranteed to land mid-task, on the right worker,
on every run.

The harness is identity-hashable, so it can ride inside
``plan("cluster", hosts=2, launcher=harness)`` spec kwargs like any other
launcher.
"""

from __future__ import annotations

import os
import signal
import socket
import threading
import time

from repro_torch.core.backends.launchers import (Launcher, LocalLauncher,
                                                 WorkerProc)

_TLS_LOCK = threading.Lock()
_TLS_CFG = None


def ephemeral_tls():
    """Process-cached self-signed TLS material for tests: one openssl
    keygen per pytest run, shared by every TLS test (the cert is valid
    for days; generating per-test would dominate suite time)."""
    global _TLS_CFG
    with _TLS_LOCK:
        if _TLS_CFG is None:
            import tempfile

            from repro_torch.core.backends.transport import \
                generate_self_signed_cert
            _TLS_CFG = generate_self_signed_cert(
                tempfile.mkdtemp(prefix="repro-torch-test-tls-"))
        return _TLS_CFG


class HarnessLauncher(Launcher):
    """Launcher wrapper that remembers everything it launched and can hurt
    any of it on command."""

    def __init__(self, inner: "Launcher | None" = None):
        self.inner = inner or LocalLauncher()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        #: every WorkerProc ever launched, in launch order (incl. dead ones)
        self.procs: list[WorkerProc] = []

    # -- Launcher protocol --------------------------------------------------

    @property
    def local_only(self):
        return getattr(self.inner, "local_only", False)

    def launch(self, host, driver_addr, *, tag=None,
               extra_env=()) -> WorkerProc:
        wp = self.inner.launch(host, driver_addr, tag=tag,
                               extra_env=extra_env)
        with self._cv:
            self.procs.append(wp)
            self._cv.notify_all()
        return wp

    def describe(self) -> str:
        return f"harness({self.inner.describe()})"

    # -- introspection ------------------------------------------------------

    @property
    def launches(self) -> int:
        with self._lock:
            return len(self.procs)

    def alive(self) -> "list[WorkerProc]":
        with self._lock:
            return [wp for wp in self.procs if wp.poll() is None]

    def wait_launches(self, n: int, timeout: float = 30.0
                      ) -> "list[WorkerProc]":
        """Block until at least ``n`` workers have been launched."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while len(self.procs) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{len(self.procs)}/{n} launches within {timeout}s")
                self._cv.wait(left)
            return list(self.procs)

    def by_pid(self, pid: int) -> "WorkerProc | None":
        with self._lock:
            for wp in self.procs:
                if wp.pid == pid:
                    return wp
        return None

    # -- chaos --------------------------------------------------------------

    def kill(self, wp: WorkerProc) -> None:
        """SIGKILL: hard node failure."""
        wp.kill()

    def stall(self, wp: WorkerProc) -> None:
        """SIGSTOP: alive socket, wedged process — heartbeat loss without
        EOF (the driver must detect it via heartbeat_timeout)."""
        os.kill(wp.pid, signal.SIGSTOP)

    def resume(self, wp: WorkerProc) -> None:
        try:
            os.kill(wp.pid, signal.SIGCONT)
        except ProcessLookupError:
            pass

    def delay(self, wp: WorkerProc, seconds: float) -> threading.Thread:
        """Delayed delivery: freeze the worker (SIGSTOP) now and resume it
        (SIGCONT) after ``seconds`` — a *slow* peer rather than a dead
        one. With ``seconds`` past the driver's heartbeat timeout this
        pins the fetch-races-reconstruction window: the driver declares
        the holder dead and starts rebuilding while the process (and its
        peer server, with the original bytes) comes back mid-recovery.
        Returns the resume-timer thread (daemon; join to sync on it)."""
        os.kill(wp.pid, signal.SIGSTOP)
        timer = threading.Timer(seconds, self.resume, args=(wp,))
        timer.daemon = True
        timer.name = "harness-delay-resume"
        timer.start()
        return timer

    def partition(self, backend, wp: WorkerProc) -> bool:
        """Sever the driver<->worker TCP stream without touching the
        process: the driver sees EOF/heartbeat loss, the worker sees EOF —
        a network partition, as far as either end can tell."""
        w = self._sock_worker(backend, wp)
        if w is None or w.sock is None:
            return False
        try:
            w.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        return True

    def _sock_worker(self, backend, wp: WorkerProc):
        with backend._pool_cv:
            for w in backend._all:
                if w.proc is wp or w.meta.get("pid") == wp.pid:
                    return w
        return None

    # -- deterministic mid-task kill ----------------------------------------

    def busy_proc(self, backend, timeout: float = 10.0) -> WorkerProc:
        """Block until some launched worker is busy; return its proc."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with backend._pool_cv:
                for w in backend._all:
                    if w.busy is not None and w.proc is not None:
                        return w.proc
            time.sleep(0.01)
        raise TimeoutError("no launched worker went busy "
                           f"within {timeout}s")

    def kill_busy(self, backend, timeout: float = 10.0) -> WorkerProc:
        wp = self.busy_proc(backend, timeout)
        self.kill(wp)
        return wp

    def kill_on_pidfile(self, path: str, timeout: float = 30.0
                        ) -> threading.Thread:
        """Arm a watcher: the moment ``path`` exists and contains a pid
        (written by the task body right before it blocks), SIGKILL that
        worker. Returns the watcher thread; join it and check
        ``thread.killed`` (the WorkerProc) to assert the kill landed."""
        def _watch():
            deadline = time.monotonic() + timeout
            pid = None
            while time.monotonic() < deadline:
                try:
                    with open(path) as fh:
                        pid = int(fh.read().strip())
                    break
                except (OSError, ValueError):
                    time.sleep(0.005)
            if pid is None:
                return
            while time.monotonic() < deadline:
                wp = self.by_pid(pid)
                if wp is not None:
                    self.kill(wp)
                    thread.killed = wp
                    return
                time.sleep(0.005)

        thread = threading.Thread(target=_watch, daemon=True,
                                  name="harness-kill-on-pidfile")
        thread.killed = None
        thread.start()
        return thread
