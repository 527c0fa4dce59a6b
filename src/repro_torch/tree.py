"""Nested dicts and lists of tensors: the port's pytrees.

The counterpart of the few ``jax.tree_util`` calls the JAX package makes on
parameters, optimiser moments and checkpoints. A path is the ``/``-joined
dict keys and list indices down to a leaf, as the JAX checkpoint manager
names it (``stages/0/b3/cell/w_up``); a dataclass node (``TrainState``)
counts its fields by index, as a pytree node registered without keys does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator


def _children(tree: Any) -> "list[tuple[Any, Any]] | None":
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return list(enumerate(getattr(tree, f.name)
                              for f in dataclasses.fields(tree)))
    return None


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts, lists and tuples (lists
    come back as lists)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def map_with_path(fn: Callable, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves, keeping the structure."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    out = [map_with_path(fn, sub, f"{path}/{k}" if path else str(k))
           for k, sub in kids]
    if isinstance(tree, dict):
        return dict(zip(tree, out))
    if isinstance(tree, (list, tuple)):
        return type(tree)(out)
    return type(tree)(*out)


def leaves(tree: Any) -> Iterator[Any]:
    """The leaves in the order :func:`tree_map` visits them."""
    kids = _children(tree)
    if kids is None:
        yield tree
        return
    for _, sub in kids:
        yield from leaves(sub)
