"""Parameter, batch and cache partition specs for every architecture.
Counterpart of ``repro/models/sharding.py``.

The scheme is the reference's:

* TP over the ``model`` axis: attention q/o projections sharded on the head
  dim, MLP on the FFN dim, embeddings on the vocab dim, MoE experts on their
  leading dim (expert parallelism).
* DP over the ``data`` axis (and ``pod`` when present): the batch dim of
  activations; ZeRO-style sharding adds ``data`` to optimizer-state specs.
* Stacked stages carry a leading layer axis: specs get a leading None.

Weight specs are keyed by leaf name (wq, w_up, table, ...), uniform across
architectures by construction of the layer libraries. A :class:`Spec` has
one entry per tensor dim: a mesh axis name, a tuple of names (the dim split
over several axes, the first outermost) or None. The spec functions walk the
port's own trees (``Model.init(..., device="meta")`` gives the shapes at no
memory cost); :func:`placements` turns a spec into DTensor placements on a
``DeviceMesh`` and :func:`shard_tree` cuts each rank's local shards.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import Replicate, Shard

from ..tree import map_with_path


class Spec:
    """A partition spec: ``Spec("model", None)`` shards dim 0 over
    ``model`` and keeps dim 1 whole. Iterating gives the entries; a spec is
    a leaf to the port's tree functions (``repro_torch.tree``)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __eq__(self, other) -> bool:
        return isinstance(other, Spec) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"Spec{self.entries!r}"


# leaf-name -> spec for the *unstacked* (per-layer) shape
_WEIGHT_RULES: dict[str, Spec] = {
    # embeddings: shard vocab over model (the unembed matmul is TP'd)
    "table": Spec("model", None),
    # attention
    "wq": Spec(None, "model"),
    "wk": Spec(None, "model"),
    "wv": Spec(None, "model"),
    "wo": Spec("model", None),
    # mlp
    "w_gate": Spec(None, "model"),
    "w_up": Spec(None, "model"),
    "w_down": Spec("model", None),
    # moe (leading expert dim -> expert parallelism)
    "router": Spec(None, None),
    # mla
    "wq_a": Spec(None, None),
    "wq_b": Spec(None, "model"),
    "wkv_a": Spec(None, None),
    "wkv_b": Spec(None, "model"),
    # rglru
    "w_in": Spec(None, "model"),
    "w_gate_in": Spec(None, "model"),
    "conv_w": Spec(None, "model"),
    "conv_b": Spec("model"),
    "lambda": Spec("model"),
    "w_a": Spec(None, "model"),
    "b_a": Spec("model"),
    "w_x": Spec(None, "model"),
    "b_x": Spec("model"),
    "w_out": Spec("model", None),
    # xlstm
    "w_i": Spec(None, None),
    "w_f": Spec(None, None),
    "b_i": Spec(None),
    "b_f": Spec(None),
    "w_ff_up": Spec(None, "model"),
    "w_ff_down": Spec("model", None),
    # frontend
    "proj": Spec(None, "model"),
}

_MOE_EXPERT_LEAVES = {"w_gate", "w_up", "w_down"}          # when ndim == 3


# the launcher passes the real mesh axis sizes so non-divisible dims fall
# back to replication
DEFAULT_AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


def _axis_len(ax, axis_sizes) -> int:
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= axis_sizes.get(a, 1)
        return n
    return axis_sizes.get(ax, 1)


def _map_named(fn: Callable, tree: Any) -> Any:
    """``fn(names, leaf)`` over the leaves, ``names`` the dict keys down to
    the leaf (list indices skipped, as the reference's ``p.key`` skips
    sequence keys; no dict key of the port's trees is a number)."""
    return map_with_path(
        lambda path, leaf: fn(tuple(k for k in path.split("/")
                                    if not k.isdigit()), leaf), tree)


def _spec_for(names: tuple, shape: tuple, axis_sizes=None) -> Spec:
    axis_sizes = axis_sizes or DEFAULT_AXIS_SIZES
    name = names[-1] if names else ""
    ndim = len(shape)
    in_moe = "moe" in names
    in_shared = "shared" in names

    if in_moe and not in_shared and name in _MOE_EXPERT_LEAVES and ndim >= 3:
        spec: tuple = ("model",) + (None,) * (ndim - 1)     # EP on experts
    elif name.startswith(("r_",)) and ndim == 3:            # slstm recurrent
        spec = (None, None, None)
    elif name in _WEIGHT_RULES:
        base = tuple(_WEIGHT_RULES[name])
        if len(base) < ndim:                                # stacked stage
            spec = (None,) * (ndim - len(base)) + base
        elif len(base) > ndim:
            spec = base[-ndim:]
        else:
            spec = base
    else:                                                   # norms, biases
        spec = (None,) * ndim

    # drop axes the dim cannot be divided over (replicate instead)
    fixed = []
    for size, ax in zip(shape, spec):
        if ax is not None and (size < 8 or size % _axis_len(ax, axis_sizes)):
            fixed.append(None)
        else:
            fixed.append(ax)
    return Spec(*fixed)


def param_specs(params_shape: Any, axis_sizes: dict | None = None) -> Any:
    """A :class:`Spec` tree matching a params (or ``meta``) tree."""
    return _map_named(
        lambda names, leaf: _spec_for(names, tuple(leaf.shape), axis_sizes),
        params_shape)


def zero_specs(params_shape: Any, *, data_axis: str = "data",
               min_size: int = 1024,
               axis_sizes: dict | None = None) -> Any:
    """Optimizer-state specs: param spec + ``data`` added to the first
    unsharded dim divisible enough (ZeRO-style state sharding)."""
    axis_sizes = axis_sizes or DEFAULT_AXIS_SIZES
    dlen = _axis_len(data_axis, axis_sizes)

    def add_data(names, leaf):
        spec = _spec_for(names, tuple(leaf.shape), axis_sizes)
        if leaf.numel() < min_size:
            return spec
        parts = list(spec) + [None] * (leaf.ndim - len(spec))
        for i, (size, ax) in enumerate(zip(leaf.shape, parts)):
            if ax is None and size >= dlen and size % dlen == 0:
                parts[i] = data_axis
                break
        return Spec(*parts)

    return _map_named(add_data, params_shape)


def batch_specs(batch_shape: Any, *, batch_axes: tuple = ("data",),
                axis_sizes: dict | None = None) -> Any:
    """Shard the leading (batch) dim of every input over the DP axes.
    Inputs whose batch dim cannot divide over DP are replicated (e.g.
    long_500k with global_batch=1)."""
    axis_sizes = axis_sizes or DEFAULT_AXIS_SIZES
    dp = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    dlen = _axis_len(dp, axis_sizes)

    def spec(names, leaf):
        name = names[-1] if names else ""
        shape = tuple(leaf.shape)
        if name == "positions" and len(shape) == 3:        # (3, B, S) mrope
            return Spec(None, dp if shape[1] % dlen == 0 else None, None)
        if not shape:
            return Spec()
        return Spec(dp if shape[0] % dlen == 0 else None,
                    *([None] * (len(shape) - 1)))

    return _map_named(spec, batch_shape)


def cache_specs(cache_shape: Any, *, batch_axes: tuple = ("data",),
                batch_replicated: bool = False,
                axis_sizes: dict | None = None) -> Any:
    """KV-cache/state specs: shard the batch dim over DP axes and, where a
    head dim exists, the heads over 'model'. Cache leaves are recognized
    structurally: k/v (.., S, KV, D), latents, recurrent states; a stacked
    stage's leading layer axis stays whole."""
    axis_sizes = axis_sizes or DEFAULT_AXIS_SIZES
    dp = None if batch_replicated else (
        batch_axes if len(batch_axes) > 1 else batch_axes[0])

    def spec(names, leaf):
        name = names[-1] if names else ""
        shape = tuple(leaf.shape)
        nd = len(shape)
        base = [None] * nd
        if name in ("k", "v"):      # (.., B, S, KV, D)
            if dp is not None and shape[-4] % _axis_len(dp, axis_sizes) == 0:
                base[-4] = dp
            tp = axis_sizes.get("model", 1)
            if shape[-2] >= 8 and shape[-2] % tp == 0:
                base[-2] = "model"
            elif shape[-1] % tp == 0:
                # GQA with kv_heads < TP: shard head_dim instead, so the
                # logits contraction partial-sums into a small all-reduce
                # instead of all-gathering the whole cache
                base[-1] = "model"
        elif name in ("c_kv", "k_rope"):        # MLA latents (.., B, S, r)
            base[-3] = dp
        elif name == "pos":
            base[-1] = dp
        elif name in ("h", "conv"):             # rglru state (.., B, W)
            base[-2 if name == "h" else -3] = dp
            if shape[-1] >= 1024:
                base[-1] = "model"
        elif name in ("C", "n", "m", "c", "hs"):    # xlstm states (batch is
            if dp is not None and \
                    shape[0] % _axis_len(dp, axis_sizes) == 0:  # dim 0)
                base[0] = dp
        return Spec(*base)

    return _map_named(spec, cache_shape)


# --------------------------------------------------------------------------
# Specs on a DeviceMesh
# --------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim named at tensor dim ``d``, ``Replicate()`` on the others. A
    dim over a tuple of axes is sharded on each of them, the first
    outermost, as the mesh's own dim order must have it. An axis the mesh
    lacks is replicated."""
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        dims = [names.index(a) for a in (ax if isinstance(ax, tuple)
                                         else (ax,)) if a in names]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: the axes of dim {d} must follow the "
                             f"mesh's order {names}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


def local_shard(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view): each sharded dim
    cut into as many equal blocks as its axes have ranks, taking the block
    at this rank's coordinate on those axes (the first axis outermost)."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    for d, ax in enumerate(spec):
        axes = [a for a in (ax if isinstance(ax, tuple) else (ax,))
                if a is not None and a in names]
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            size = mesh.size(names.index(a))
            idx = idx * size + coord[names.index(a)]
            n *= size
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {axes} ({n} ranks)")
        step = t.shape[d] // n
        t = t.narrow(d, idx * step, step)
    return t


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Each leaf of ``tree`` cut to this rank's shard under the matching
    leaf of ``specs`` (views of the full leaves; ``.clone()`` them to free
    the rest)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_tree(v, s, mesh) for v, s in zip(tree, specs)]
    return local_shard(tree, specs, mesh)
