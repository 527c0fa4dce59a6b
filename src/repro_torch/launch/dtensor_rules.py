"""How the port runs on DTensors: the layout choices the model makes when
its tensors are ``DTensor``\\ s, and the op rules the dry run adds to
DTensor's own. Only the dry run (``launch/dryrun.py``) gives the model
DTensors; on plain tensors every function here returns its input, or the
plain computation, unchanged.

The reference's GSPMD chooses a layout for every intermediate of a step;
DTensor keeps the placements each op's rule gives and chooses by
communication alone, so the model pins a few of them itself:

* :func:`pin`: the residual stream keeps the batch's layout
  (:func:`layout_of` the tokens), forward and backward;
* :func:`whole_heads` and :func:`whole_heads_grad`: the attention's
  products run on whole heads when the model has more than one KV head;
* :func:`lookup`: the embedding is ``F.embedding``, vocab-parallel;
* :func:`label_nll`: the loss picks the labels' log-probabilities by
  ``F.nll_loss``;
* :func:`microbatches`: each microbatch is sharded as the batch was;
* :func:`constrain`: the gradients take the reference's sharding
  constraint;
* :func:`moe_apply_manual`: the expert-parallel MoE runs on each rank's
  local shards, as the reference's ``shard_map`` does.

:func:`op_rules` is the dry run's context for the ops DTensor has no rule
for that the model runs (``aten.view`` where it would have to move a
split dim, ``log_sigmoid``); it puts DTensor back as it was on exit.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

aten = torch.ops.aten


def layout_of(t):
    """The placements of a DTensor batch leaf (the residual stream's
    layout), else None."""
    return t.placements if isinstance(t, DTensor) else None


def pin(x, layout):
    """A DTensor ``x`` redistributed to ``layout`` (its placements), and its
    gradient too; a plain tensor, or no layout, as it is. A row-parallel
    product's partial sums are reduced where its block adds them to the
    stream, and a column-parallel product's partial input gradients where
    the stream takes them back, not carried into the next product (where
    DTensor would gather the weights and repeat the work on every
    ``model`` rank). The gradient is the same tensor in any placement, so
    it is moved, not converted back to ``x``'s placements (which DTensor
    cannot do for the masked sum of a vocab-parallel lookup)."""
    if layout is None or not isinstance(x, DTensor):
        return x
    return _Pin.apply(x, layout)


class _Pin(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return x.redistribute(x.device_mesh, layout)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            g = g.redistribute(g.device_mesh, ctx.layout)
        return g, None


def whole_heads(t):
    """A DTensor with only its batch dim left sharded; any other tensor as
    it is. DTensor has no rule for a product whose batch dim folds a batch
    sharded over one mesh axis with KV heads sharded over another (a
    ``_StridedShard``), so with more than one KV head the attention's
    products would gather the heads anyway, once for every block of rows;
    this gathers them once. With one KV head the query heads stay
    sharded: they fold into the products' rows."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [
        p if isinstance(p, Shard) and p.dim == 0 else Replicate()
        for p in t.placements])


def whole_heads_grad(t):
    """The identity, whose gradient comes back with whole heads
    (:func:`whole_heads`): the attention's output, gathered in the
    forward, would otherwise take back the heads' sharding of the product
    after it."""
    if not isinstance(t, DTensor):
        return t
    return _WholeHeadsGrad.apply(t)


class _WholeHeadsGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return whole_heads(g)


def lookup(table, tokens):
    """``table[tokens]``. Over DTensors, ``F.embedding``: DTensor runs it
    vocab-parallel on a table sharded over its rows (a masked local
    lookup, then a sum), where its index rule gathers the table (and,
    before torch 2.13, refuses ids sharded over two mesh axes)."""
    if isinstance(tokens, DTensor):
        return F.embedding(tokens, table)
    return table[tokens]


def label_nll(logp, labels):
    """``-logp`` at each label (``labels`` >= 0 already). Over DTensors,
    ``F.nll_loss``: the gradient of a ``gather`` is a ``new_zeros`` of the
    whole of ``logp``, which DTensor makes replicated, at the global batch
    a rank; ``nll_loss``'s backward keeps ``logp``'s placements."""
    if not isinstance(logp, DTensor):
        return -logp.gather(-1, labels[..., None])[..., 0]
    return F.nll_loss(logp.flatten(0, -2), labels.flatten(),
                      reduction="none").view(labels.shape)


def microbatches(x, n: int, split) -> list:
    """The ``n`` slices ``split(x, n)`` of a batch leaf. A DTensor leaf is
    gathered first (the batch is small beside the step) and each slice
    takes the leaf's own placements again, so every microbatch is sharded
    over the data axes as the batch was."""
    if not isinstance(x, DTensor):
        return list(split(x, n))
    mesh, placements = x.device_mesh, x.placements
    whole = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    return [m.redistribute(mesh, placements) for m in split(whole, n)]


def constrain(grads, specs):
    """The gradient DTensors of ``grads`` redistributed to the
    :class:`~repro_torch.models.sharding.Spec` tree ``specs`` (the
    reference's sharding constraint); plain tensors, or no specs, as they
    are."""
    if specs is None:
        return grads
    from ..models.sharding import placements
    from ..tree import tree_map
    return tree_map(
        lambda g, s: g.redistribute(g.device_mesh,
                                    placements(s, g.device_mesh))
        if isinstance(g, DTensor) else g, grads, specs)


def moe_apply_manual(p, x, dims, mesh, *, dp_axis):
    """``moe.moe_apply_manual`` on DTensors (``x`` replicated over
    ``model``): the routed experts run on each rank's local tensors, an
    expert leaf cut to the rank's experts where its spec left it whole (a
    stacked stage's spec lands on the layer dim); ``y`` comes back with
    ``x``'s placements, ``aux`` replicated, and the shared MLP stays on
    DTensors."""
    from ..models import moe
    from ..models.layers import mlp_apply
    epp = moe.experts_per_rank(dims, mesh)
    r = mesh.get_local_rank("model")

    def mine(k, v):
        v = v.to_local() if isinstance(v, DTensor) else v
        if k in moe.EXPERT_LEAVES and v.shape[0] == dims.e_pad:
            v = v[r * epp:(r + 1) * epp]
        return v

    local = {k: mine(k, v) for k, v in p.items() if k != "shared"}
    y, aux = moe.moe_apply_manual(local, x.to_local(), dims, mesh,
                                  dp_axis=dp_axis)
    y = DTensor.from_local(y, mesh, x.placements, run_check=False)
    aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, "swiglu")
    return y, aux


def replicate_partials(t):
    """A DTensor with its pending sums (``Partial`` placements) resolved
    to ``Replicate``; anything else as it is."""
    if not isinstance(t, DTensor) or not any(
            isinstance(p, Partial) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in t.placements])


# -- op rules ---------------------------------------------------------------

@contextlib.contextmanager
def op_rules():
    """DTensor with the dry run's rules, for the body of the ``with``:

    * ``aten.view`` gets the rule DTensor gives ``aten.reshape``, which
      redistributes the input first where a split dim cannot stay split
      (Yi-9B's 4 KV heads over 16 ``model`` ranks); DTensor's own rule
      refuses such a view. The redistribution's collective is counted.
    * ``log_sigmoid``'s two ops run on the local tensors
      (:func:`_log_sigmoid_forward`).

    On exit DTensor's rule for ``aten.view``, its handlers and its cache of
    sharding decisions are as they were on entry, so no later DTensor
    code in the process sees these rules."""
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops._view_ops import \
        register_op_strategy_map
    dispatcher = DTensor._op_dispatcher
    prop = dispatcher.sharding_propagator
    handlers = dispatcher._custom_op_handlers
    ours = {aten.log_sigmoid_forward.default: _log_sigmoid_forward,
            aten.log_sigmoid_backward.default: _log_sigmoid_backward}
    view = aten.view.default
    saved = (prop.op_strategy_funcs.get(view),
             prop.op_to_schema_info.get(view),
             {op: handlers.get(op) for op in ours})
    register_op_strategy_map(view, torch.Tensor.view,
                             schema_info=RuntimeSchemaInfo(1))
    handlers.update(ours)
    _clear_cache(prop)
    try:
        yield
    finally:
        strategy, schema_info, old = saved
        for table, value in ((prop.op_strategy_funcs, strategy),
                             (prop.op_to_schema_info, schema_info)):
            if value is None:
                table.pop(view, None)
            else:
                table[view] = value
        for op, handler in old.items():
            if handler is None:
                handlers.pop(op, None)
            else:
                handlers[op] = handler
        _clear_cache(prop)


def _clear_cache(prop) -> None:
    """DTensor's caches of sharding decisions: the Python one and, where
    the torch build has it, the C++ dispatch fast path's."""
    for clear in (getattr(prop.propagate_op_sharding, "cache_clear", None),
                  getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None)):
        if clear is not None:
            clear()


# ``log_sigmoid``, elementwise, has no DTensor rule. Its forward returns a
# buffer that its backward reads, of the input's shape on the host and
# (0,) on a card (the mesh's device type, where DTensor infers shapes), so
# no placement DTensor infers for it holds: both ops run on the local
# tensors here, each result taking the input's placements (a pending sum
# resolved first, the function not being linear).

def _log_sigmoid_forward(op, args, kwargs):
    x = replicate_partials(args[0])
    out, buf = op(x.to_local())
    return tuple(DTensor.from_local(t, x.device_mesh, x.placements,
                                    run_check=False) for t in (out, buf))


def _log_sigmoid_backward(op, args, kwargs):
    grad, x, buf = args
    x = replicate_partials(x)
    grad = grad.redistribute(x.device_mesh, x.placements)
    out = op(grad.to_local(), x.to_local(), buf.to_local())
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False)
