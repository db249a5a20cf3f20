"""The collectives of a tensor-parallel forward, over one model group, and
of data-parallel / fsdp training, over one data group.

Every function takes the group as its last argument and is the identity when
it is None (no tensor or data parallelism), so a single-process forward runs
no collective and needs no `torch.distributed` world.  What each rank gets back
is the same on every rank of the group: a reduction is computed once per
element and handed to all ranks, so the replicated residual stream stays
bitwise identical across ranks and so do the tokens read from it.

`reduce_sum` and `copy_in` are the two conjugate operators of Megatron-style
layers under autograd: after a row-parallel layer `reduce_sum` all-reduces
the partial products (its backward passes the gradient through), and before
a column-parallel layer `copy_in` is the identity (its backward all-reduces
the input's gradient).  Outside autograd `copy_in` does nothing and
`reduce_sum` reduces in place (the trainers sum gradients, metrics and mask
counts over the data group that way).

`gather_data` is the weight gather of fsdp (ZeRO-3): its forward all-gathers
a rank's block of a weight along the sharded axis, its backward
reduce-scatters (sums) the full gradient back to the rank's block.
`gather_last` gathers a vocab-parallel head's logits; under autograd its
backward hands each rank its own columns of the gradient, which is the whole
gradient there because every rank computes the same loss from the same
gathered logits.

gloo runs every one of these calls on CUDA tensors as well as on CPU tensors
(all_reduce SUM / MAX / MIN, all_gather and broadcast in bf16, f32, f64,
int32 and int64, and reduce_scatter in bf16 and f32, checked on an H100
with torch 2.11), which lets two ranks share one card; a gloo group cannot
be captured in a CUDA graph (`engine/graphs.py` refuses it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum of every rank's `x` (a row-parallel layer's partial product).
    Outside autograd `x` is reduced in place and returned."""
    if group is None:
        return x
    if _grad(x):
        return _ReduceSum.apply(x, group)
    dist.all_reduce(x, group=group)
    return x


def copy_in(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The replicated input of a column-parallel layer: `x` itself; under
    autograd its gradient is summed over the group."""
    if group is None or not _grad(x):
        return x
    return _CopyIn.apply(x, group)


def reduce_max(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Elementwise maximum over the group, in place (no gradient)."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def reduce_min(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Elementwise minimum over the group, in place (no gradient)."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


def gather_stack(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[n, *x.shape]: every rank's `x`, in rank order (no gradient)."""
    if group is None:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def gather_cat(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in rank order (no
    gradient)."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def scatter_sum(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """This rank's block along `dim` of the sum of every rank's `x` (a
    reduce-scatter)."""
    if group is None:
        return x
    n, r = group_size(group), group_rank(group)
    parts = [p.contiguous() for p in x.chunk(n, dim)]
    out = torch.empty_like(parts[r])
    dist.reduce_scatter(out, parts, group=group)
    return out


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return scatter_sum(g, ctx.dim, ctx.group), None, None


def gather_data(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """The whole weight of which `x` is this rank's block along `dim` (fsdp):
    an all-gather whose backward reduce-scatters the gradient (SUM) to the
    rank's block, so each rank's block gradient sums every rank's use."""
    if group is None:
        return x
    if _grad(x):
        return _GatherData.apply(x, dim, group)
    return gather_cat(x, dim, group)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return gather_cat(x, -1, group)

    @staticmethod
    def backward(ctx, g):
        r, w = group_rank(ctx.group), ctx.width
        return g[..., r * w:(r + 1) * w], None


def gather_last(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's `x` concatenated along the last axis, in rank order: a
    vocab-parallel head's logits in vocab order.  Under autograd each rank's
    gradient is its own columns of the gathered logits' gradient."""
    if group is None:
        return x
    if _grad(x):
        return _GatherLast.apply(x, group)
    return gather_cat(x, -1, group)


def broadcast_first(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The group's first rank's `x` on every rank, in place."""
    if group is not None:
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x
