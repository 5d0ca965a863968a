"""The collectives of the sharded step, over torch.distributed groups.

Counterparts of the JAX package's shard_map collectives, with the
gradients JAX's transposes give:

  * `all_gather_tiled` (jax.lax.all_gather(..., tiled=True)): the ranks'
    blocks concatenated along dim 0 in group order; its backward is the
    sum-scatter (psum_scatter): the cotangents summed over the group, each
    rank keeping its block's rows;
  * `all_gather_stack` (the untiled all_gather): the blocks stacked on a
    new leading axis; backward likewise;
  * `all_reduce_mean` (pmean), whose backward is a pmean too;
  * `all_reduce_sum` and `broadcast` for values that take no gradient
    (counts, masks, state).

A group is a torch.distributed process group; None stands for a group of
one rank, where every collective is the identity. The sum-scatter is an
all_reduce and a slice: gloo has no reduce_scatter.

Transport. Each collective goes through the group's own backend. On a
gloo group a CUDA tensor is copied to the host, reduced or gathered
there and copied back: gloo is the backend that can hold several ranks
on one card, which NCCL refuses. That path is taken by the group's
backend alone, never as a fallback, and `STATS["host_staged"]` counts
its calls (`STATS["calls"]` counts all).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

STATS = {"calls": 0, "host_staged": 0}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(x, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _reduce(x, group, op):
    STATS["calls"] += 1
    if _staged(x, group):
        STATS["host_staged"] += 1
        y = x.detach().cpu()
        dist.all_reduce(y, op=op, group=group)
        return y.to(x.device)
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _gather(x, group):
    STATS["calls"] += 1
    x = x.detach().contiguous()
    staged = _staged(x, group)
    if staged:
        STATS["host_staged"] += 1
    src = x.cpu() if staged else x
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts] if staged else parts


def all_reduce_sum(x, group):
    return x if group is None else _reduce(x, group, dist.ReduceOp.SUM)


def broadcast(x, src: int, group):
    """x from the group's rank `src` on every rank of the group."""
    if group is None:
        return x
    STATS["calls"] += 1
    root = dist.get_global_rank(group, src)
    if _staged(x, group):
        STATS["host_staged"] += 1
        y = x.detach().cpu().contiguous()
        dist.broadcast(y, root, group=group)
        return y.to(x.device)
    y = x.detach().clone().contiguous()
    dist.broadcast(y, root, group=group)
    return y


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group, dist.ReduceOp.SUM) / group_size(group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group, dist.ReduceOp.SUM) / group_size(
            ctx.group), None


def all_reduce_mean(x, group):
    return x if group is None else _Mean.apply(x, group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tiled: bool):
        ctx.group, ctx.tiled, ctx.rows = group, tiled, x.shape[0]
        parts = _gather(x, group)
        return torch.cat(parts, 0) if tiled else torch.stack(parts, 0)

    @staticmethod
    def backward(ctx, g):
        total = _reduce(g.contiguous(), ctx.group, dist.ReduceOp.SUM)
        r = group_rank(ctx.group)
        mine = total[r * ctx.rows:(r + 1) * ctx.rows] if ctx.tiled else total[r]
        return mine, None, None


def all_gather_tiled(x, group):
    """[n, ...] on each rank -> [size * n, ...], rank blocks in order."""
    return x if group is None else _Gather.apply(x, group, True)


def all_gather_stack(x, group):
    """[...] on each rank -> [size, ...]."""
    return x[None] if group is None else _Gather.apply(x, group, False)
