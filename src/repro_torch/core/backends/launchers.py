"""Worker launchers: who bootstraps the ``cluster_worker`` processes.

The paper's ``makeClusterPSOCK`` *launches* its own workers: the end user
writes ``plan(cluster, workers = c("nodeA", "nodeB"))`` and the framework
does the bootstrap — ssh by default, any command template for schedulers.
This module is that half of the TCP cluster backend: a small
:class:`Launcher` protocol plus three implementations —

* :class:`LocalLauncher` — subprocess-spawn workers on this machine. The
  default for ``workers=N`` and ``hosts=N``: ``spec("cluster", hosts=2)``
  runs end-to-end with zero hand-launched processes.
* :class:`SSHLauncher`  — bootstrap over ``ssh`` (remote python path, env
  forwarding, optional reverse tunnel for NAT'd workers), mirroring
  ``makeClusterPSOCK``'s defaults. The default for named ``hosts=``.
* :class:`CommandLauncher` — an arbitrary ``{host}``/``{driver}`` command
  template, so SLURM ``srun`` / k8s ``kubectl run`` bootstrap is a config
  string, not a code change.

A launcher's :meth:`~Launcher.launch` returns a :class:`WorkerProc`: the
driver-side handle the :class:`~.cluster.ClusterBackend` *owns*. The driver
polls it for pre-hello death (its captured stderr is surfaced in the
startup error), kills it on ``cancel()``/``shutdown()``, and relaunches
through the same launcher — capped exponential backoff — when a launched
worker dies mid-task. For non-local launchers the ``WorkerProc`` wraps the
local bootstrap command (``ssh``/``srun``/…) whose lifetime tracks the
remote worker: killing the bootstrap severs the tunnel, the remote worker
sees EOF and exits (unless launched with ``--reconnect``).

The concrete launchers are frozen dataclasses: hashable (so a launcher
rides inside ``spec("cluster", hosts=..., launcher=...)`` kwargs — the
warm-pool key in ``planning.py`` hashes the whole spec, launcher included)
and picklable (shippable inside nested plan stacks). Matching
a ``hello`` to the ``WorkerProc`` that produced it uses a per-launch
``--tag`` token echoed in the worker's hello frame; launchers that cannot
forward the tag (a :class:`CommandLauncher` template without ``{tag}``)
fall back to pid and then first-come-first-served matching.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import re
import shlex
import subprocess
import sys
import threading
import time
from typing import Any

#: the worker entry point every launcher bootstraps
WORKER_MODULE = "repro_torch.core.backends.cluster_worker"

#: the only brace tokens CommandLauncher substitutes — anything else
#: (kubectl --overrides JSON, shell ${VAR}) passes through verbatim
_PLACEHOLDER = re.compile(
    r"\{(host|driver|driver_host|driver_port|python|tag)\}")

#: ``launcher=`` sentinel: spawn nothing, the operator hand-launches
#: workers (or a scheduler that was handed ``backend.address`` does)
EXTERNAL = "external"

#: stderr lines retained per launched worker (surfaced on pre-hello death)
_STDERR_KEEP_LINES = 50


def _src_root() -> str:
    """The ``src`` directory holding ``repro_torch``."""
    return os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..", "..", ".."))


class WorkerProc:
    """One launched worker bootstrap process, owned by the cluster driver.

    For :class:`LocalLauncher` this *is* the worker; for SSH/scheduler
    launchers it is the local bootstrap command whose lifetime tracks the
    remote worker. Stderr is drained into a bounded tail buffer so a worker
    that dies before its first hello can have its last words quoted in the
    error the driver raises.
    """

    def __init__(self, proc: subprocess.Popen, host: str,
                 tag: "str | None", cmd, *, tag_forwarded: bool = False):
        self.proc = proc
        self.host = host
        #: hello-matching token; ``None`` when the launcher could not
        #: forward it (matching falls back to pid, then FIFO)
        self.tag = tag
        #: True when the launcher is *certain* the worker's hello will echo
        #: the tag (it built the ``--tag`` argument itself). The driver's
        #: FIFO fallback only matches unforwarded records, so a tagless
        #: hand-launched hello can never steal a tag-forwarding bootstrap's
        #: pairing record.
        self.tag_forwarded = tag_forwarded
        self.cmd = tuple(cmd)
        self.launched_at = time.monotonic()
        self._tail: "collections.deque[bytes]" = collections.deque(
            maxlen=_STDERR_KEEP_LINES)
        if proc.stderr is not None:
            threading.Thread(target=self._drain_stderr, daemon=True,
                             name=f"worker-stderr-{proc.pid}").start()

    def _drain_stderr(self) -> None:
        stream = self.proc.stderr
        try:
            for line in stream:
                self._tail.append(line)
        except (ValueError, OSError):
            pass
        finally:
            try:
                stream.close()
            except (ValueError, OSError):
                pass

    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def returncode(self):
        return self.proc.returncode

    def poll(self):
        """``None`` while the bootstrap process is alive, else its exit
        code — the 'no orphans after shutdown()' assertion hook."""
        return self.proc.poll()

    def wait(self, timeout: "float | None" = None):
        return self.proc.wait(timeout)

    def terminate(self) -> None:
        try:
            self.proc.terminate()
        except OSError:
            pass

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass

    def stderr_tail(self) -> str:
        """The last captured stderr lines (empty when stderr was not
        piped, or the worker never wrote any)."""
        return b"".join(self._tail).decode("utf-8", "replace").strip()

    def describe(self) -> str:
        state = ("alive" if self.proc.poll() is None
                 else f"exited rc={self.proc.returncode}")
        return (f"launched worker (host={self.host!r} "
                f"bootstrap-pid={self.proc.pid} {state})")

    def __repr__(self):
        return f"<WorkerProc {self.describe()}>"


class Launcher:
    """Protocol for worker bootstrap strategies.

    ``launch(host, driver_addr, tag=...)`` starts one worker that will dial
    ``driver_addr`` (a ``(host, port)`` pair, already translated to what the
    *worker* can reach) and returns the :class:`WorkerProc` handle.
    Subclasses usually only build a command line; process ownership,
    pre-hello polling and relaunch policy live in the cluster driver.

    ``extra_env`` is the driver's per-cluster credential hand-off
    (``REPRO_CLUSTER_TOKEN`` and friends — see ``cluster_worker.py``):
    ``(("K", "V"), ...)`` pairs every launcher must deliver into the
    worker's environment, merged *after* its own ``env`` config. The
    driver only passes the kwarg when it is non-empty, so third-party
    launchers without the parameter keep working on unsecured clusters.
    """

    #: True when launched workers always dial the driver's loopback
    #: address (the driver hands such launchers its 127.0.0.1 connect-back
    #: instead of its advertised hostname)
    local_only = False

    def launch(self, host: str, driver_addr: "tuple[str, int]", *,
               tag: "str | None" = None,
               extra_env: "tuple[tuple[str, str], ...]" = ()
               ) -> WorkerProc:
        raise NotImplementedError

    def describe(self) -> str:
        return repr(self)

    def _worker_env(self, extra=()) -> dict:
        """Environment for a locally spawned bootstrap process: the
        checkout's ``src`` on PYTHONPATH and single-threaded numerics
        (several workers per machine must not each grab every core; the
        worker sets torch's intra-op pool to match)."""
        env = dict(os.environ)
        src_root = _src_root()
        env["PYTHONPATH"] = (src_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else src_root)
        env.setdefault("OMP_NUM_THREADS", "1")
        env.update(dict(extra))
        return env

    def _spawn(self, cmd, host: str, tag: "str | None", *,
               env: "dict | None" = None,
               capture_stderr: bool = True,
               tag_forwarded: bool = False) -> WorkerProc:
        proc = subprocess.Popen(
            cmd, env=env, stdin=subprocess.DEVNULL,
            stderr=subprocess.PIPE if capture_stderr else None)
        return WorkerProc(proc, host, tag, cmd, tag_forwarded=tag_forwarded)


@dataclasses.dataclass(frozen=True)
class LocalLauncher(Launcher):
    """Spawn ``python -m repro_torch.core.backends.cluster_worker`` on this
    machine (``host`` is informational; every worker dials 127.0.0.1).

    * ``python`` — interpreter to use (default: ``sys.executable``).
    * ``worker_args`` — extra ``cluster_worker`` flags, e.g.
      ``("--max-idle-s", "600")``.
    * ``env`` — extra environment entries as ``(("K", "V"), ...)``.
    * ``capture_stderr`` — pipe worker stderr into the bounded tail buffer
      the driver quotes in death errors (default). Set ``False`` to let
      workers write straight to the driver's terminal instead (live
      library warnings over post-mortem diagnosis).
    """

    python: str = ""
    worker_args: "tuple[str, ...]" = ()
    env: "tuple[tuple[str, str], ...]" = ()
    capture_stderr: bool = True

    local_only = True

    def launch(self, host, driver_addr, *, tag=None, extra_env=()):
        dhost, dport = driver_addr
        cmd = [self.python or sys.executable, "-m", WORKER_MODULE,
               f"{dhost}:{dport}"]
        if tag:
            cmd += ["--tag", tag]
        cmd += list(self.worker_args)
        return self._spawn(cmd, host or "127.0.0.1", tag,
                           env=self._worker_env(self.env + tuple(extra_env)),
                           capture_stderr=self.capture_stderr,
                           tag_forwarded=bool(tag))

    def describe(self) -> str:
        return f"local({self.python or sys.executable})"


@dataclasses.dataclass(frozen=True)
class SSHLauncher(Launcher):
    """``makeClusterPSOCK`` over ssh: run the worker module on a remote
    host, dialing back to the driver.

    * ``python`` / ``pythonpath`` — remote interpreter and the remote
      checkout's ``src`` dir (default: the driver's own src root, i.e. a
      mirrored filesystem — NFS home, baked image).
    * ``env`` — ``(("K", "V"), ...)`` forwarded onto the remote command
      line via ``env K=V …``.
    * ``reverse_tunnel`` — for NAT'd workers that cannot reach the driver:
      adds ``-R port:127.0.0.1:port`` so the worker dials 127.0.0.1 on its
      own side of the tunnel (``makeClusterPSOCK(revtunnel = TRUE)``).
      The remote bind port equals the driver port, so at most one
      reverse-tunnel worker per remote host per driver: a second tunnel to
      the same host would fail its bind and ride (and die with) the first
      one. Launch multiple workers on one NAT'd host via a single ssh +
      a remote process manager instead.
    * ``ssh_options`` — raw ssh flags; the default disables password
      prompts (a launcher must fail fast, not hang on interactive auth).
    """

    user: str = ""
    python: str = "python3"
    pythonpath: str = ""
    ssh: str = "ssh"
    ssh_options: "tuple[str, ...]" = (
        "-o", "BatchMode=yes", "-o", "StrictHostKeyChecking=accept-new")
    env: "tuple[tuple[str, str], ...]" = (("OMP_NUM_THREADS", "1"),)
    reverse_tunnel: bool = False
    worker_args: "tuple[str, ...]" = ()
    capture_stderr: bool = True

    def command(self, host, driver_addr, *, tag=None, extra_env=()) -> list:
        """The full local argv this launcher would run (exposed so tests
        and ``describe()`` can show the bootstrap without an sshd)."""
        dhost, dport = driver_addr
        dest = f"{self.user}@{host}" if self.user else host
        cmd = [self.ssh, *self.ssh_options]
        if self.reverse_tunnel:
            cmd += ["-R", f"{dport}:127.0.0.1:{dport}"]
            addr = f"127.0.0.1:{dport}"
        else:
            addr = f"{dhost}:{dport}"
        remote = ["env",
                  f"PYTHONPATH={shlex.quote(self.pythonpath or _src_root())}"]
        for k, v in self.env + tuple(extra_env):
            remote.append(f"{k}={shlex.quote(str(v))}")
        # the whole remote command is one space-joined string evaluated by
        # the remote shell: quote every word that could carry spaces
        remote += [shlex.quote(self.python), "-m", WORKER_MODULE, addr]
        if tag:
            remote += ["--tag", shlex.quote(tag)]
        remote += [shlex.quote(a) for a in self.worker_args]
        return cmd + [dest, " ".join(remote)]

    def launch(self, host, driver_addr, *, tag=None, extra_env=()):
        # NOTE: remote env (cluster token included) rides the ssh command
        # line (`env K=V ...`), so it is visible to `ps` on the remote host
        # for the bootstrap's lifetime — the standard makeClusterPSOCK
        # trade-off. Hosts needing stronger secrecy should pre-provision
        # REPRO_CLUSTER_TOKEN in the remote shell profile instead.
        return self._spawn(
            self.command(host, driver_addr, tag=tag, extra_env=extra_env),
            host, tag, capture_stderr=self.capture_stderr,
            tag_forwarded=bool(tag))

    def describe(self) -> str:
        tun = "+revtunnel" if self.reverse_tunnel else ""
        return f"ssh({self.ssh}{tun} -> {self.python})"


@dataclasses.dataclass(frozen=True)
class CommandLauncher(Launcher):
    """Arbitrary bootstrap command template — scheduler integration as a
    config string::

        CommandLauncher("srun -w {host} --ntasks=1 {python} -m "
                        "repro_torch.core.backends.cluster_worker {driver} "
                        "--tag {tag}")
        CommandLauncher("kubectl run repro-w{tag} --image=repro "
                        "--restart=Never -- python -m "
                        "repro_torch.core.backends.cluster_worker {driver}")

    Placeholders (substituted per shell word after ``shlex.split``):
    ``{host}``, ``{driver}`` (``HOST:PORT``), ``{driver_host}``,
    ``{driver_port}``, ``{python}`` (the driver's interpreter), ``{tag}``.
    Only these exact tokens are substituted — any other brace text
    (``--overrides={"spec":...}`` JSON, shell ``${VAR}``) passes through
    untouched. A template without ``{tag}`` still works — hellos then
    match first-come-first-served.
    """

    template: str = ""
    env: "tuple[tuple[str, str], ...]" = ()
    capture_stderr: bool = True

    def launch(self, host, driver_addr, *, tag=None, extra_env=()):
        dhost, dport = driver_addr
        subst = {"host": host or "127.0.0.1",
                 "driver": f"{dhost}:{dport}",
                 "driver_host": dhost, "driver_port": str(dport),
                 "python": sys.executable, "tag": tag or ""}
        cmd = [_PLACEHOLDER.sub(lambda m: subst[m.group(1)], word)
               for word in shlex.split(self.template)]
        if not cmd:
            raise ValueError("CommandLauncher template is empty")
        # a template may use {tag} without forwarding it as --tag (e.g. in
        # a pod name), so never claim the hello will echo it: the driver's
        # FIFO fallback handles the pairing either way
        return self._spawn(cmd, host, tag if "{tag}" in self.template
                           else None,
                           env=self._worker_env(self.env + tuple(extra_env)),
                           capture_stderr=self.capture_stderr,
                           tag_forwarded=False)

    def describe(self) -> str:
        words = self.template.split()
        return f"command({words[0] if words else '<empty>'})"


def resolve_launcher(launcher: Any, hosts: Any = None) -> "Launcher | None":
    """Normalize the ``launcher=`` spec kwarg to a :class:`Launcher`
    (or ``None`` for external/hand-launched workers).

    * ``None`` — pick the default for the ``hosts`` shape:
      :class:`LocalLauncher` for ``hosts=N``/``workers=N`` (zero
      hand-launched processes), :class:`SSHLauncher` for named hosts
      (the paper's ``makeClusterPSOCK`` default).
    * ``"local"`` / ``"ssh"`` — a default-configured launcher by name.
    * ``"external"`` — spawn nothing; the operator (or their scheduler)
      launches ``cluster_worker`` processes against ``backend.address``.
    * any string containing ``{driver}`` — sugar for
      ``CommandLauncher(template)``.
    * a :class:`Launcher` (anything with a ``launch`` method) — as is.
    """
    if launcher == EXTERNAL:
        return None
    if launcher is None:
        if hosts is None or isinstance(hosts, int):
            return LocalLauncher()
        return SSHLauncher()
    if isinstance(launcher, str):
        if launcher == "local":
            return LocalLauncher()
        if launcher == "ssh":
            return SSHLauncher()
        if "{driver" in launcher:      # {driver} or {driver_host}/{_port}
            return CommandLauncher(launcher)
        raise ValueError(
            f"unknown launcher {launcher!r}: expected 'local', 'ssh', "
            f"'external', a command template containing {{driver}} (or "
            f"{{driver_host}}/{{driver_port}}), or a Launcher instance")
    if callable(getattr(launcher, "launch", None)):
        return launcher
    raise TypeError(f"launcher must be a Launcher, a name, or a command "
                    f"template; got {type(launcher).__name__}")
