"""Multi-node initialization — the counterpart of
`amid_tpu/parallel/distributed.py` (the reference is single-process,
SURVEY.md §2.5).

Each rank runs the same program. `initialize_distributed()` joins them into
one `torch.distributed` world: from torchrun's environment (`RANK`,
`WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`), or from explicit arguments
(`tcp://<coordinator>`, the world size, this rank). The backend follows the
run's device: NCCL on `cuda` (the default device), gloo on the CPU. A JAX
process is a node here: the ranks that share `LOCAL_WORLD_SIZE`;
`make_host_aligned_mesh` keeps the `model` group within a node, and
`host_local_slice` gives a node its rows.

Per-rank data: every rank loads the same (seed-deterministic) dataset and
iterates the same global batch order, and builds the same initial weights;
`shard_global` cuts this rank's part from that identical host copy — its
rows of a batch, its row shard of the table, or the whole of a replicated
leaf — as `put_global` hands each JAX process its addressable shards. The
trainer (`train.loop.run_seed`) runs unchanged across ranks and nodes
(tests/test_torch_distributed.py).

For the fast loops' CUDA graphs, the NCCL calls are captured with the steps:
`TORCH_NCCL_ASYNC_ERROR_HANDLING=0` is set (unless given) before the group
is made, and every step kind runs once eagerly on the graphs' side stream
before its capture (`train/graphs.py`).
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from amid_tpu_torch.parallel import mesh as mesh_lib
from amid_tpu_torch.parallel.mesh import REPLICATED, ROWS, Mesh


def backend_for(device) -> str:
    """NCCL for a run on `cuda` (the default device), gloo on the CPU."""
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def _prepare(backend: str) -> None:
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")


def _bind_card(backend: str) -> None:
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % mesh_lib.local_world_size()))
        torch.cuda.set_device(local)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """Idempotent join of the world (`dist.is_initialized()`): from the
    explicit arguments when any is given (all three are then needed, and a
    failure raises), else from torchrun's environment when it is set, else
    nothing (a single process)."""
    if dist.is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    backend = backend_for(device)
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            # ANY explicit argument must take effect: a half-given world would
            # leave the ranks each training alone into one model_dir
            raise ValueError(
                "a multi-process run needs --coordinator, --num_processes and "
                f"--process_id together; got {explicit}")
        _prepare(backend)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        _prepare(backend)
        dist.init_process_group(backend, init_method="env://")
    else:
        return
    _bind_card(backend)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_world(device) -> bool:
    """The process group of a mesh run: the one that exists, the one
    torchrun's environment describes (joined and kept), or a world of one
    on a free local port. Returns whether it made the last (the caller then
    destroys it, `destroy_world`)."""
    initialize_distributed(device=device)
    if dist.is_initialized():
        return False
    backend = backend_for(device)
    _prepare(backend)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    _bind_card(backend)
    return True


def destroy_world() -> None:
    mesh_lib.forget_groups()
    dist.destroy_process_group()


def make_host_aligned_mesh(model_axis: int = 1) -> Mesh:
    """A mesh whose `model` groups stay within a node and whose `data`
    groups span the nodes."""
    local = mesh_lib.local_world_size()
    if model_axis > local or local % model_axis != 0:
        raise ValueError(f"model_axis={model_axis} must divide local device count {local}")
    from amid_tpu_torch.config import MeshConfig

    return mesh_lib.make_mesh(MeshConfig(data_axis=-1, model_axis=model_axis))


def host_local_slice(n_rows: int) -> tuple[int, int]:
    """This node's contiguous [start, end) rows of a global batch."""
    local = mesh_lib.local_world_size()
    nodes = max(1, dist.get_world_size() // local)
    per = n_rows // nodes
    start = (dist.get_rank() // local) * per
    return start, start + per


def _cut(x: torch.Tensor, layout: str, mesh: Mesh) -> torch.Tensor:
    if layout == REPLICATED:
        return x
    if layout == ROWS:
        shards, rank, what = mesh.model_shards, mesh.model_rank, "model"
    elif layout == "data":
        shards, rank, what = mesh.data_shards, mesh.data_rank, "data"
    else:
        raise ValueError(f"unknown layout {layout!r}")
    if shards == 1:
        return x
    if x.shape[0] % shards:
        raise ValueError(f"{x.shape[0]} rows do not split evenly over the {what} axis "
                         f"of {shards}")
    per = x.shape[0] // shards
    return x[rank * per:(rank + 1) * per]


def shard_params_(model, mesh: Mesh):
    """Cuts `model`'s parameters to this rank's part in place (each row-
    sharded one to a copy of its rows, `mesh.param_layout`'s rule): every
    rank built the same weights from the seed. Returns `model`."""
    params = dict(model.named_parameters())
    for name, part in shard_global(params, mesh_lib.param_layout(params), mesh).items():
        if part is not params[name]:
            params[name].data = part.clone()
    return model


def shard_global(tree, layout, mesh: Mesh):
    """This rank's part of an identical host copy: `tree` a tensor or a
    dictionary of tensors, `layout` one layout for all or a dictionary by
    name — "model" (rows over the `model` group: the table and its moments),
    "data" (rows over the `data` group: a batch), "replicated" (the whole).
    A cut is a view of the rows; the caller copies it where it keeps it."""
    if isinstance(tree, torch.Tensor):
        return _cut(tree, layout, mesh)
    get = layout.get if isinstance(layout, dict) else (lambda _: layout)
    return {k: _cut(v, get(k), mesh) for k, v in tree.items()}
