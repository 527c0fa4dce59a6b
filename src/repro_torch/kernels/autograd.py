"""Autograd for the CUDA kernels: the forward is the kernel, the backward
recomputes the plain PyTorch version from the saved inputs and
differentiates that.

No TPU kernel of the repo has a backward: ``jax.grad`` differentiates the
JAX model's jnp path, which never calls a kernel. Autograd through the
plain version is the port's counterpart of that, so a gradient through a
kernel equals the plain path's gradient at the same inputs. The forward
saves only its inputs; what the caller gets is always the kernel's output.
A hand-written backward kernel would replace :meth:`_Recompute.backward`.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["recompute"]


class _Recompute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, *inputs):
        ctx.plain = plain
        ctx.absent = [x is None for x in inputs]
        ctx.save_for_backward(*(x for x in inputs if x is not None))
        ctx.set_materialize_grads(False)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grad_outputs):
        needs = ctx.needs_input_grad[2:]
        saved = iter(ctx.saved_tensors)
        inputs = [None if absent else next(saved).detach().requires_grad_(need)
                  for absent, need in zip(ctx.absent, needs)]
        with torch.enable_grad():
            outputs = ctx.plain(*inputs)
        if isinstance(outputs, torch.Tensor):
            outputs = (outputs,)
        pairs = [(o, g) for o, g in zip(outputs, grad_outputs)
                 if g is not None and o.requires_grad]
        wanted = [x for x, need in zip(inputs, needs) if need]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(wanted))
        return (None, None, *(next(grads) if need else None
                              for need in needs))


def recompute(kernel: Callable, plain: Callable, *inputs):
    """``kernel(*inputs)``, differentiable: the backward runs
    ``plain(*inputs)`` again under grad from the saved inputs and returns
    autograd's gradients of it for the incoming gradients of the outputs.
    ``inputs`` are tensors or None; a non-tensor argument is bound into
    both callables. ``kernel`` and ``plain`` return a tensor or a tuple of
    tensors of the same shapes."""
    return _Recompute.apply(kernel, plain, *inputs)
