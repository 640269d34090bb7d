"""Embedding lookup — replicated and row-sharded paths; the counterpart of
`amid_tpu/parallel/embedding.py`.

Reference semantics: a plain table gather (model_seq.py:25-29) on one GPU.
On a mesh the item table's rows are sharded over the `model` group, each
rank holding rows [lo, lo + V_local) (`parallel/mesh.py::param_layout`).

Row-sharded lookup (mask-and-all-reduce formulation): each rank gathers
`table_local[clip(id - lo)]` (the model's gather: K4 under kernels='cuda'),
zeroes the rows it does not own and sums the partial results over the
`model` group. Exactly one shard contributes a non-zero row per id, so the
sum is the gather. The backward is the masked gather's own: the rows'
gradient, masked, scatter-added into the owning shard's rows (K4's
backward), with no collective over `model` (`collectives.psum_model`).

`embedding_lookup` is the model's dispatch point: lazy rows (the model has
already turned the ids into positions of the step's gathered rows,
`AMIDModel.lookup`), then, inside `parallel.context.spmd`, the sharded
lookup, then the plain gather.
"""

from __future__ import annotations

from typing import Callable

import torch

from amid_tpu_torch.parallel import context
from amid_tpu_torch.parallel.collectives import psum_model


def embedding_lookup(table: torch.Tensor, ids_list, gather: Callable, concat: bool = False,
                     lazy: bool = False):
    """`gather(table, ids_list, concat=concat)` (a group of lookups, see
    `ops.embedding.embedding_gather_many`), through the mesh's sharded lookup
    inside an SPMD region unless `lazy` (then `table` is the step's
    replicated rows)."""
    axes = context.current()
    if axes is None or lazy:
        return gather(table, ids_list, concat=concat)
    return sharded_lookup(table, ids_list, axes, gather, concat)


def sharded_lookup(local_table: torch.Tensor, ids_list, axes: context.SpmdAxes,
                   gather: Callable, concat: bool = False):
    """Row-sharded lookup: `local_table` [V_local, D] is this rank's rows,
    `ids_list` global row ids. Returns what `gather` returns on the whole
    table, the same on every rank of the `model` group."""
    v_local = local_table.shape[0]
    lo = axes.model_rank * v_local
    local = [ids - lo for ids in ids_list]
    mine = [(i >= 0) & (i < v_local) for i in local]
    got = gather(local_table, [i.clamp(0, v_local - 1) for i in local], concat=concat)
    if concat:
        users = mine[0].shape[0]
        keep = torch.cat([m.reshape(users, -1) for m in mine], dim=1)
        return psum_model(got * keep[..., None], axes)
    return tuple(psum_model(rows * m[..., None], axes) for rows, m in zip(got, mine))
