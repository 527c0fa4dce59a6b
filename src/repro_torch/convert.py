"""Parameters from the JAX package into the port, leaf by leaf by path.

A JAX ``Model.init`` pytree, with its leaves as numpy arrays, maps onto the
port's parameter dict path for path (``stages/0/b3/cell/w_up``): both keep
JAX's names and ``(in, out)`` layouts, and a stage with repeat > 1 is
stacked on a leading axis in both, so its leaves map one to one too. Every leaf's shape is checked against
the port's own parameters for the same config, and a leaf that either side
lacks is an error, so nothing is silently dropped or left at random.
:func:`train_state_from_jax` maps a JAX ``TrainState`` (params and AdamW's
step, m and v) the same way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .models.model import Model
from .train.state import TrainState


def _to_tensor(leaf: Any) -> torch.Tensor:
    """A numpy view of a JAX leaf as a tensor. numpy has no bfloat16 of its
    own: JAX hands bf16 leaves over as ``ml_dtypes.bfloat16`` arrays, which
    ``torch.from_numpy`` refuses, so they cross as their uint16 bits."""
    arr = np.asarray(leaf)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _convert(tree: Any, want: Any, path: str, device: torch.device) -> Any:
    if isinstance(want, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{path or '/'}: expected a dict, got "
                             f"{type(tree).__name__}")
        missing = sorted(set(want) - set(tree))
        extra = sorted(set(tree) - set(want))
        if missing or extra:
            raise ValueError(f"{path or '/'}: missing leaves {missing}, "
                             f"unused leaves {extra}")
        return {k: _convert(tree[k], want[k], f"{path}/{k}".lstrip("/"),
                            device) for k in want}
    if isinstance(want, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(want):
            raise ValueError(f"{path}: expected a list of {len(want)}")
        return [_convert(t, w, f"{path}/{i}", device)
                for i, (t, w) in enumerate(zip(tree, want))]
    t = _to_tensor(tree)
    if tuple(t.shape) != tuple(want.shape):
        raise ValueError(f"{path}: shape {tuple(t.shape)} from JAX, "
                         f"expected {tuple(want.shape)}")
    return t.to(device)


def params_from_jax(tree: Any, cfg, *, device=None) -> dict:
    """The port's parameters for ``cfg`` from a JAX ``Model.init`` pytree
    of numpy arrays, placed on ``device`` (the GPU by default)."""
    dev = resolve_device(device)
    want = Model(cfg).init(torch.Generator(), device="meta")
    return _convert(tree, want, "", dev)


def train_state_from_jax(state_tree: Any, cfg, *, device=None) -> TrainState:
    """The port's ``TrainState`` for ``cfg`` from a JAX ``TrainState`` whose
    leaves are numpy arrays: params, ``opt["m"]`` and ``opt["v"]`` through
    the same checked walk as :func:`params_from_jax`, ``opt["step"]`` as an
    int32 scalar; all on ``device`` (the GPU by default)."""
    dev = resolve_device(device)
    want = Model(cfg).init(torch.Generator(), device="meta")
    opt = state_tree.opt
    return TrainState(
        params=_convert(state_tree.params, want, "params", dev),
        opt={"step": torch.tensor(int(np.asarray(opt["step"])),
                                  dtype=torch.int32, device=dev),
             "m": _convert(opt["m"], want, "opt/m", dev),
             "v": _convert(opt["v"], want, "opt/v", dev)})
