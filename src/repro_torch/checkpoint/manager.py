"""Async checkpointing via futures. Counterpart of
``repro/checkpoint/manager.py``, on the same files.

``save()`` snapshots the state to host memory (the device->host copy) and
dispatches the disk write as a *future*, so training continues while the
write completes; at most one write is in flight, and a ``FutureError`` from
a writer that died is swallowed at the next barrier, as in the reference.

Layout: ``<dir>/step_<N>/{manifest.json, arrays.npz}`` written to a tmp dir
and atomically renamed, so a torn write is never taken for a checkpoint.
The npz keys are the JAX manager's: the path of each leaf
(``repro_torch/tree.py``). So ``TrainState`` leaves are
``0/<param path>``, ``1/step``, ``1/m/<param path>`` and ``1/v/...``, and a
checkpoint restores across the two packages in both directions. bf16 is
written as fp32 (npz has no bf16); ``restore`` casts to the template's
dtype and device.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import time
from typing import Any

import numpy as np
import torch

from ..core import FutureError, future, resolved, value
from ..core.future import Future
from ..tree import map_with_path


def _to_host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()       # npz has no bf16; dtype restored
        return leaf.to("cpu", copy=True).numpy()    # from the template
    return np.array(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    map_with_path(lambda path, leaf: flat.__setitem__(path, _to_host(leaf)),
                   tree)
    return flat


def _unflatten_into(tree: Any, arrays: dict[str, np.ndarray]) -> Any:
    return map_with_path(
        lambda path, leaf: torch.from_numpy(np.asarray(arrays[path])).to(
            device=leaf.device, dtype=leaf.dtype), tree)


def _write(host: dict, step: int, directory: str, keep: int) -> int:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(host), "time": time.time()},
                  f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic publish
    # retention
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for old in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, old), ignore_errors=True)
    return step


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True, backend=None):
        """``backend``: where the write futures run (default: the active
        plan's backend)."""
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.backend = backend
        os.makedirs(directory, exist_ok=True)
        self._inflight: Future | None = None

    # -- save ------------------------------------------------------------------

    def save(self, step: int, state: Any, *, block: bool = False) -> None:
        """Snapshot now, write asynchronously (unless block=True)."""
        self.wait()                          # at most one in-flight write
        host = _flatten(state)               # device->host copy happens here
        write = functools.partial(_write, host, step, self.dir, self.keep)
        if self.async_save and not block:
            self._inflight = future(write, label=f"ckpt-{step}",
                                    backend=self.backend)
        else:
            write()

    def wait(self) -> None:
        """Barrier on the in-flight write (a writer that died is let go)."""
        if self._inflight is not None:
            f, self._inflight = self._inflight, None
            try:
                value(f)
            except FutureError:
                # writer died: its tmp dir is discarded by design; nothing
                # to clean, the caller keeps going
                pass

    def save_in_flight(self) -> bool:
        return self._inflight is not None and not resolved(self._inflight)

    # -- restore ---------------------------------------------------------------

    def latest_step(self) -> int | None:
        if not os.path.isdir(self.dir):
            return None
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir)
                 if d.startswith("step_") and not d.endswith(".tmp")]
        return max(steps) if steps else None

    def restore(self, template: Any,
                step: int | None = None) -> tuple[Any, int]:
        """Restore into the structure, dtypes and devices of
        ``template``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["step"] != step:
            raise ValueError(f"{path}: manifest says step "
                             f"{manifest['step']}")
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            arrays = dict(npz)
        return _unflatten_into(template, arrays), step
