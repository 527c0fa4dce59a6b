"""Automatic identification and snapshotting of globals (paper §Globals).

The R implementation walks the expression's AST (via ``globals`` /
``codetools``) to find free variables, records their *values at
future-creation time*, and ships them with the future. The defining
semantics (paper's example):

    x <- 1
    f <- future({ slow_fcn(x) })
    x <- 2
    value(f)        # uses x == 1

We reproduce this in Python by analysing the callable's code object:

* ``co_freevars``  -> closure cells (lexically captured variables);
* ``LOAD_GLOBAL``-referenced ``co_names`` -> the function's ``__globals__``;
* nested code objects (lambdas/comprehensions inside the body) are scanned
  recursively — the paper's "walking the AST in order".

Like the paper we use an *optimistic* strategy: names that resolve to
modules or builtins are recorded as *packages* (re-imported on the worker,
never serialized); unresolvable names are tolerated at creation (they may be
created at run time, e.g. ``get("k")``-style dynamic lookup) and produce the
ordinary NameError at evaluation — and, as in the paper, can be supplied
explicitly with ``globals={"k": 42}``.

Snapshot rules: immutable scalars/strings/tuples and torch/numpy arrays are
captured **by reference** (tensors are not copied: a future that needs a
frozen tensor clones it itself); mutable
containers (list/dict/set/bytearray) are **copied** at creation so later
mutation does not leak into the future, mirroring R's copy-on-assign.

Only in-process backends exist in this package, so nothing is shipped:
the snapshot is bound into the rebuilt function by ``future.py``.
"""

from __future__ import annotations

import builtins
import copy
import dis
import types
from typing import Any, Callable

import torch

from .errors import GlobalsError

_GLOBAL_OPS = {"LOAD_GLOBAL", "LOAD_NAME", "STORE_GLOBAL", "DELETE_GLOBAL"}


def _code_global_names(code: types.CodeType) -> set[str]:
    """Names referenced via global scope in ``code`` and nested code objects."""
    names: set[str] = set()
    stack = [code]
    while stack:
        co = stack.pop()
        for instr in dis.get_instructions(co):
            if instr.opname in _GLOBAL_OPS and isinstance(instr.argval, str):
                names.add(instr.argval)
        for const in co.co_consts:
            if isinstance(const, types.CodeType):
                stack.append(const)
    return names


def _tensor_memo(value: Any) -> dict:
    """``copy.deepcopy`` memo mapping every tensor inside the containers of
    ``value`` to itself, so the copy keeps them by reference."""
    memo: dict = {}
    seen: set = set()                     # containers may hold themselves
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            memo[id(v)] = v
        elif isinstance(v, (dict, list, tuple, set, frozenset)) \
                and id(v) not in seen:
            seen.add(id(v))
            stack.extend(v.values() if isinstance(v, dict) else v)
    return memo


def _snapshot_value(value: Any) -> Any:
    """Creation-time snapshot. Mutable python containers are copied; arrays,
    scalars, functions and modules are captured by reference (immutables).
    Tensors stay references inside a copied container too: a dict of CUDA
    parameters is a new dict of the same tensors, not a clone on the card."""
    if isinstance(value, (list, dict, set, bytearray)):
        return copy.deepcopy(value, _tensor_memo(value))
    return value


def identify_globals(fn: Callable, *,
                     explicit: dict[str, Any] | None = None,
                     ) -> tuple[dict[str, Any], set[str]]:
    """Return ``(globals_snapshot, packages)`` for a callable.

    ``globals_snapshot`` maps name -> snapshotted value for every free
    variable the future body needs; ``packages`` is the set of module names
    recorded (to be re-imported on the worker rather than serialized —
    the paper's package-namespace recording).
    """
    if not callable(fn):
        raise GlobalsError(f"future body must be callable, got {type(fn)!r}")
    snapshot: dict[str, Any] = {}
    packages: set[str] = set()

    code = getattr(fn, "__code__", None)
    if code is None:                      # builtins / partials: nothing to scan
        if explicit:
            snapshot.update({k: _snapshot_value(v) for k, v in explicit.items()})
        return snapshot, packages

    # Closure cells (lexical captures).
    if code.co_freevars and fn.__closure__:
        for name, cell in zip(code.co_freevars, fn.__closure__):
            try:
                snapshot[name] = _snapshot_value(cell.cell_contents)
            except ValueError:            # empty cell (recursive def)
                pass

    # Module-level globals referenced by the body.
    fn_globals = getattr(fn, "__globals__", {})
    for name in sorted(_code_global_names(code)):
        if explicit and name in explicit:
            continue                      # explicit overrides win
        if name in fn_globals:
            val = fn_globals[name]
            if isinstance(val, types.ModuleType):
                packages.add((name, val.__name__))   # (alias, module)
            else:
                snapshot[name] = _snapshot_value(val)
        elif hasattr(builtins, name):
            continue                      # builtins need no shipping
        # else: optimistic — may be defined at run time (paper's get("k")).

    if explicit:
        for k, v in explicit.items():
            snapshot[k] = _snapshot_value(v)
    return snapshot, packages
