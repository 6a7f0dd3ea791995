"""Autograd-aware collectives of the tensor-parallel model (Megatron's
conjugate operators), written out where ``crs_tpu`` leaves them to GSPMD.

- :func:`copy_to_group` (Megatron's f): identity forward, all-reduce of the
  gradient backward — the input of a column-parallel product;
- :func:`reduce_from_group` (g): all-reduce (sum) forward, identity
  backward — the output of a row-parallel product, the vocab-split lookup;
- :func:`gather_last_dim`: all-gather along the last dim forward, this
  rank's slice of the gradient backward — the vocab-split logits, which
  every rank of the group then uses alike.

Each calls its collective whatever the group's size (a one-rank group
included).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["copy_to_group", "reduce_from_group", "gather_last_dim"]


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.size = dist.get_rank(group), dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(ctx.size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def gather_last_dim(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherLastDim.apply(x, group)
