"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ctypes. The library
lands in ``<repo>/build/kernels/<name>-<hash>.so``, where the hash covers
the source, the flags and any extra ``-D`` defines, so a changed source is
rebuilt and an unchanged one is loaded as it is. Nothing is built when this module is imported: the
first call that needs a kernel builds it, and :func:`build_all` builds every
source at once, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[tuple[str, ...], ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _flags(defines: tuple[str, ...]) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def _target(name: str, defines: tuple[str, ...] = ()) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_flags(defines)).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str, defines: tuple[str, ...] = ()
           ) -> "tuple[Path, Path, subprocess.Popen] | None":
    out = _target(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return out, tmp, proc


def _finish(name: str, job) -> None:
    if job is None:
        return
    out, tmp, proc = job
    if proc.wait() != 0:
        log = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict[str, str]:
    """Build every kernel source in parallel; return each one's ptxas
    report (registers, shared memory, spills) from its build log."""
    with _lock:
        jobs = {name: _start(name) for name in sources()}
        for name, job in jobs.items():
            _finish(name, job)
    return {name: _target(name).with_suffix(".log").read_text()
            if _target(name).with_suffix(".log").exists() else ""
            for name in sources()}


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed;
    ``defines`` (macro names, passed as ``-D``) select an instrumented
    build, kept apart from the plain one."""
    key = (name, *defines)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            _finish(name, _start(name, defines))
            lib = _libs[key] = ctypes.CDLL(str(_target(name, defines)))
        return lib


def copy_target(src: "str | os.PathLike", tag: str,
                defines: tuple[str, ...] = ()) -> Path:
    """Where :func:`load_copy` builds ``src``: ``BUILD_DIR`` /
    ``<stem>-<tag>-<hash>.so``, the hash over the source and the flags."""
    src = Path(src).resolve()
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_flags(defines)).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{tag}-{digest}.so"


def load_copy(src: "str | os.PathLike", tag: str,
              defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Another copy of a kernel source (say, an older commit's, from a
    ``git archive``), built with the same flags and any extra ``defines``
    at :func:`copy_target` (nvcc's output, with ptxas's report, beside it
    as ``.log``) and loaded, to time one build against another; the caller
    declares its C interface."""
    src = Path(src).resolve()
    out = copy_target(src, tag, defines)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *_flags(defines), "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
