"""The mesh's collectives as differentiable functions — what `jax.lax.psum`,
`pmean` and `all_gather` are to the JAX package's shard_map code, with the
transposes that the port's SPMD semantics need written out:

* `psum_model(x)`: the sum over the `model` group (the sharded lookup's
  partial rows). Its backward is the identity: every rank of a `model`
  group computes the same thing from the summed rows, so the cotangent
  arriving there is already the same on each of them, and each shard takes
  it as its own (summing it again would scale the table's and the encoders'
  gradients by `model_shards`, as `torch.distributed.nn.functional.
  all_reduce`'s backward does).
* `all_gather_data(x)`: this rank's rows [b, ...] to the global [d * b, ...]
  in data-rank order. Its backward sums the cotangent over the `data` group
  and keeps this rank's rows: each rank's rows take the gradient of every
  rank's loss.
* `pmean_data(x)`: the mean over the `data` group; its backward divides by
  `data_shards` and sums nothing (the gradients are summed over `data` once,
  after the backward: `sum_data_`).

Every collective is one form that both backends take (all-reduce, all-gather
into a list), with no per-backend branch, and is issued on a group of one
rank as well: on the one card of a world of one, the NCCL calls still run.
The groups are read from the `SpmdAxes` at the forward and kept for the
backward, which may run on another thread.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from amid_tpu_torch.parallel.context import SpmdAxes


def _all_gather(x: torch.Tensor, group, shards: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shards)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0)


class _PsumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shards, rank):
        ctx.group, ctx.rows, ctx.rank = group, x.shape[0], rank
        return _all_gather(x.detach(), group, shards)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None, None, None


class _PmeanData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shards):
        ctx.shards = shards
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y / shards

    @staticmethod
    def backward(ctx, g):
        return g / ctx.shards, None, None


def psum_model(x: torch.Tensor, axes: SpmdAxes) -> torch.Tensor:
    """Sum over the `model` group; identity backward."""
    return _PsumModel.apply(x, axes.model_group)


def all_gather_data(x: torch.Tensor, axes: SpmdAxes) -> torch.Tensor:
    """[b, ...] -> [data_shards * b, ...] in data-rank order; the backward
    sums over `data` and keeps this rank's rows. Without a gradient to take,
    a plain all-gather."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGatherData.apply(x, axes.data_group, axes.data_shards, axes.data_rank)
    return _all_gather(x, axes.data_group, axes.data_shards)


def gather_rows(x: torch.Tensor, group, shards: int) -> torch.Tensor:
    """The row shards of `group`'s ranks joined in rank order, no gradient
    (a checkpoint's table from its `model` shards)."""
    with torch.no_grad():
        return _all_gather(x.detach(), group, shards)


def pmean_data(x: torch.Tensor, axes: SpmdAxes) -> torch.Tensor:
    """Mean over the `data` group; the backward divides by `data_shards`."""
    return _PmeanData.apply(x, axes.data_group, axes.data_shards)


def mean_data(values: dict[str, torch.Tensor], axes: SpmdAxes) -> dict[str, torch.Tensor]:
    """Every scalar of `values` averaged over `data` in one all-reduce, no
    gradient."""
    names = list(values)
    flat = torch.stack([values[k].detach().reshape(()).float() for k in names])
    dist.all_reduce(flat, group=axes.data_group)
    flat = flat / axes.data_shards
    return {k: flat[i] for i, k in enumerate(names)}


def sum_data_(tensors: list[torch.Tensor], axes: SpmdAxes) -> None:
    """Sums each tensor over the `data` group in place, in one all-reduce of
    their concatenation (one tensor: in place, no copy)."""
    if not tensors:
        return
    if len(tensors) == 1 and tensors[0].is_contiguous():
        dist.all_reduce(tensors[0], group=axes.data_group)
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=axes.data_group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))
