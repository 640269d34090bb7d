"""The `data x model` mesh of ranks and the layout of the trainer's state
on it — the counterpart of `amid_tpu/parallel/mesh.py`.

The reference is single-process single-GPU (SURVEY.md §2.5). Axes:

* ``data`` — batch-parallel. Each rank holds every row of a step's global
  batch on the host and computes with its own rows; the loss is averaged
  and the gradients summed over the `data` group. InnerComp/InterComp
  contract over the global batch, so the peer banks are all-gathered over
  it (`models/comp.py`).
* ``model`` — the item table's rows are sharded over it
  (`parallel/embedding.py`), with the table's optimizer moments.

A JAX device is a torch rank here, and a JAX process a node (the ranks that
share `LOCAL_WORLD_SIZE`): ranks are laid out data-major, rank = data_rank *
model_shards + model_rank, so a `model` group is consecutive ranks, within a
node when `model_shards` divides the ranks a node holds
(`parallel/distributed.py::make_host_aligned_mesh`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import torch.distributed as dist

from amid_tpu_torch.config import MeshConfig
from amid_tpu_torch.parallel.context import SpmdAxes

DATA_AXIS = "data"
MODEL_AXIS = "model"
ROWS = "model"  # a leaf's layout: its rows sharded over `model`
REPLICATED = "replicated"
TABLE_KEY = "item_embedding"

_groups: dict = {}  # (the default group, ranks) -> the group made for them


@dataclass(frozen=True, eq=False)
class Mesh:
    data_shards: int
    model_shards: int
    data_rank: int
    model_rank: int
    rank: int
    nodes: int  # JAX's processes: world // ranks a node
    data_group: Any
    model_group: Any

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data_shards, MODEL_AXIS: self.model_shards}

    def axes(self, impl: str = "gspmd") -> SpmdAxes:
        return SpmdAxes(self.data_group, self.model_group, self.data_shards,
                        self.model_shards, self.data_rank, self.model_rank, impl)


def local_world_size() -> int:
    """Ranks of this node: torchrun's `LOCAL_WORLD_SIZE`, else the world."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def _group(ranks: list[int]):
    """A group of `ranks`, made once per default group (every rank makes
    every group, in one order)."""
    key = (dist.group.WORLD, tuple(ranks))
    if key not in _groups:
        _groups[key] = dist.new_group(ranks)
    return _groups[key]


def make_mesh(cfg: MeshConfig | None = None) -> Mesh:
    """The mesh over every rank of the default process group. Fully explicit
    axes must cover the world: a rank outside the mesh would hold no place
    in its collectives (as a multi-process JAX mesh that leaves devices out
    is refused)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process group "
                           "(parallel/distributed.py::initialize_distributed)")
    cfg = cfg or MeshConfig()
    world, rank = dist.get_world_size(), dist.get_rank()
    if cfg.data_axis > 0 and cfg.model_axis > 0:
        need = cfg.data_axis * cfg.model_axis
        if need != world:
            raise ValueError(
                f"explicit mesh {cfg.data_axis}x{cfg.model_axis} covers {need} of "
                f"{world} ranks; every rank must hold a place on the mesh")
    data, model = cfg.axis_sizes(world)
    data_group = model_group = None
    for j in range(model):  # the data groups: one rank of each model shard
        g = _group([i * model + j for i in range(data)])
        if rank % model == j:
            data_group = g
    for i in range(data):
        g = _group([i * model + j for j in range(model)])
        if rank // model == i:
            model_group = g
    local = local_world_size()
    return Mesh(data, model, rank // model, rank % model, rank, max(1, world // local),
                data_group, model_group)


def forget_groups() -> None:
    """Drops the groups made for a default group that is being destroyed."""
    _groups.clear()


def _leaf_layout(name: str, x) -> str:
    if TABLE_KEY in name and getattr(x, "ndim", 0) == 2:
        return ROWS
    return REPLICATED


def param_layout(params: dict) -> dict[str, str]:
    """Layout of a parameter (or moment) dictionary by name: the item table
    — any 2-D leaf named `item_embedding`, the Adam mu/nu that mirror it
    included — row-sharded over `model`, everything else replicated."""
    return {k: _leaf_layout(k, v) for k, v in params.items()}


def state_layout(state) -> dict[str, str]:
    """Layout of a `TrainState`'s leaves by their checkpoint names
    (`train.checkpoint.state_leaves`): parameters and dense moments by
    `param_layout`'s rule; a `LazyTableState`'s per-row mu/nu follow the
    table (rows over `model`), its step count and dense moments replicated."""
    from amid_tpu_torch.train.checkpoint import state_leaves
    from amid_tpu_torch.train.lazy import LazyTableState

    layout = {k: _leaf_layout(k, v) for k, v in state_leaves(state).items()}
    for slot in ("opt_state", "opt_state2"):
        if isinstance(getattr(state, slot), LazyTableState):
            layout[f"{slot}/mu"] = layout[f"{slot}/nu"] = ROWS
    return layout
