"""Collectives on a mesh axis, with the backward passes SPMD code needs.
The port's counterparts of ``jax.lax.psum``, ``pmean`` and ``ppermute``
inside ``shard_map``.

Every rank of a group runs the same program, and a value that a collective
made equal on every rank of the group counts once: its cotangent is the
cotangent of that one value, not a sum over ranks. So :func:`psum`'s
backward is the identity on each rank, :func:`pmean`'s scales by 1/n, and
:func:`pcopy` (the identity forward, a sum over the group backward) marks
where a replicated value enters per-rank partial work, so that its
cotangent gathers every rank's share.

On a gloo group a CUDA tensor crosses through the host: copied out,
reduced or sent, copied back (gloo's send and recv take host tensors only,
and its reductions are staged the same way). The arithmetic stays on the
tensor's own device. NCCL groups take CUDA tensors as they are; NCCL
refuses two ranks on one GPU, so ranks that share a card use gloo.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _host_staged(group, device: torch.device) -> bool:
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed in place over ``group``."""
    if _host_staged(group, t.device):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        return t.copy_(h)
    dist.all_reduce(t, group=group)
    return t


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_reduce_(x.clone(), group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank."""
    return _PSum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group`` on every rank."""
    return _PMean.apply(x, group)


def pcopy(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group``."""
    return _PCopy.apply(x, group)


class HandOff:
    """Point-to-point hand-off of activations between pipeline stages. A
    send is posted without waiting (``isend``) and kept until :meth:`wait`;
    a receive blocks. Messages are matched by tag, so sends and receives may
    run in any order. Counts the messages (``sent``, ``received``) and the
    bytes and seconds of the copies through the host (``host_bytes``,
    ``copy_s``)."""

    def __init__(self):
        self.pending: list = []
        self.sent = self.received = 0
        self.host_bytes = 0
        self.copy_s = 0.0

    def send(self, t: torch.Tensor, dst: int, tag: int, group) -> None:
        """Post ``t`` to global rank ``dst``."""
        buf = t.detach().contiguous()
        if _host_staged(group, t.device):
            torch.cuda.synchronize(t.device)       # time the copy alone
            t0 = time.perf_counter()
            buf = buf.to("cpu")
            self.copy_s += time.perf_counter() - t0
            self.host_bytes += buf.numel() * buf.element_size()
        self.pending.append((dist.isend(buf, dst=dst, group=group, tag=tag),
                             buf))
        self.sent += 1

    def recv(self, shape, dtype, device: torch.device, src: int, tag: int,
             group) -> torch.Tensor:
        """The tensor global rank ``src`` sent with ``tag``, on
        ``device``."""
        staged = _host_staged(group, device)
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if staged else device)
        dist.recv(buf, src=src, group=group, tag=tag)
        self.received += 1
        if not staged:
            return buf
        t0 = time.perf_counter()
        out = buf.to(device)
        torch.cuda.synchronize(device)
        self.copy_s += time.perf_counter() - t0
        self.host_bytes += buf.numel() * buf.element_size()
        return out

    def wait(self) -> None:
        for work, _ in self.pending:
            work.wait()
        self.pending.clear()
