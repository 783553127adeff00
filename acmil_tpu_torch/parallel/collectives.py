"""Collectives over a process group, differentiable where a step needs them.

The JAX package writes its sequence-sharded ops with ``lax.psum``,
``lax.pmax`` and ``lax.all_gather`` inside ``shard_map``. These are their
``torch.distributed`` counterparts. Each takes a group, and a group of None
(an axis of size 1) makes each of them the identity, at no cost.

Gradients follow one convention: the loss is computed whole on every rank
that holds a replicated value, so the gradient of a replicated tensor is
the same on each of those ranks.

- :func:`psum` (per-rank partials to a replicated sum): the backward is the
  identity.
- :func:`all_gather` (per-rank slices to a replicated whole): the backward
  keeps this rank's slice.
- :func:`fan_out` marks where a replicated tensor (a parameter, a gathered
  landmark) enters per-rank work. The forward is the identity, and the
  backward sums the per-rank gradients over the group.
- :func:`pmax` has no gradient, as ``lax.pmax`` under ``stop_gradient``.

Both ``nccl`` and ``gloo`` take CUDA tensors for every collective used here
(``chip_smoke.py`` phase 21 checks ``gloo``'s on the card); ``gloo`` moves
them through host memory itself, so the computation stays on the card.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

ReduceOp = dist.ReduceOp


def all_reduce_(t: torch.Tensor, group, op=ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over ``group`` (nothing when it is None)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def gather_list(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (all of one shape), in the group's rank order."""
    if group is None:
        return [t]
    src = t.contiguous()
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, src, group=group)
    return outs


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` overwritten in place with global rank ``src``'s, over ``group``
    (nothing when it is None)."""
    if group is not None:
        dist.broadcast(t, src=src, group=group)
    return t


def group_rank(group) -> int:
    """This process's rank within ``group``."""
    return dist.get_rank(group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return torch.cat(gather_list(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        start = group_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (``lax.psum``); the backward passes
    the replicated gradient through unchanged."""
    if group is None:
        return x
    return _PSum.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, with no gradient."""
    x = x.detach()
    if group is None:
        return x
    return all_reduce_(x.clone(), group, ReduceOp.MAX)


def fan_out(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient is summed over ``group``. Put it where a
    replicated tensor enters work that each rank does on its own slice."""
    if group is None:
        return x
    return _FanOut.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order (tiled
    ``lax.all_gather``); the backward keeps this rank's slice."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim % x.dim())


def group_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim`` (the inverse of
    :func:`all_gather`), a view: its gradient lands in this rank's slice, so
    a replicated ``x`` goes through :func:`fan_out` first."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * size, size)


def group_size(group: Optional[object]) -> int:
    """The number of ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)
