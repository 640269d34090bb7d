"""Embedding row gather — the counterpart of `amid_tpu/ops/pallas_embedding.py`.

    embedding_gather(table, ids) -> table[ids]      # [..., D]

table: [V, D] float32 with unit stride along D (the item table, or the lazy
step's gathered `[U, D]` rows); ids: any shape, int32 or int64.

What the caller owes. Nothing on the device's side checks the ids (that would
cost a synchronisation): an id outside [0, V) is clamped to the nearest valid
row, in the kernel and in the plain version alike, as a JAX gather clamps an
out-of-bounds index. Callers pass real rows: `pad_id` is a row of the table,
and the lazy step's `searchsorted` positions lie in [0, U) for every id that
is in its unique list (a position of U could only come from an id above the
sentinel V, which no batch holds).

The forward is the kernel of `csrc/gather_rows.cu`. The backward is the
gather's transpose, a scatter-add into a zero `[V, D]` table (duplicated ids
add up), done with `index_add_` as the TPU package leaves it to XLA.

On CUDA tensors `embedding_gather` launches the kernel (counting the launch in
`.launches`) or raises; on CPU tensors its forward is `embedding_gather_plain`
and its backward the same `index_add_`, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes

import torch


def embedding_gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, differentiable by autograd."""
    flat = ids.reshape(-1).clamp(0, table.shape[0] - 1)
    return torch.index_select(table, 0, flat).view(*ids.shape, table.shape[1])


def _check(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"embedding_gather: the table must be [V, D] with V >= 1; "
                         f"got {tuple(table.shape)}")
    if table.dtype != torch.float32:
        raise TypeError(f"embedding_gather takes a float32 table; got {table.dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"embedding_gather takes int32 or int64 ids; got {ids.dtype}")
    if ids.device != table.device:
        raise ValueError(f"embedding_gather: table on {table.device}, ids on {ids.device}")


def _kernel_lib():
    from amid_tpu_torch.ops import _build

    lib = _build.load("gather_rows")
    if not getattr(lib, "_amid_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        # table, table_stride, ids, ids64, out, n, V, width, vec, stream
        lib.gather_rows.argtypes = [p, ll, p, i, p, ll, ll, i, i, p]
        lib.gather_rows.restype = i
        lib._amid_typed = True
    return lib


def _launch(table: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    v, width = table.shape
    if table.stride(1) != 1:
        raise ValueError("embedding_gather: the table must have unit stride along D")
    if not flat.is_contiguous():
        flat = flat.contiguous()
    n = flat.shape[0]
    out = torch.empty((n, width), dtype=torch.float32, device=table.device)
    vec = (width % 4 == 0 and table.stride(0) % 4 == 0
           and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    err = _kernel_lib().gather_rows(
        table.data_ptr(), table.stride(0), flat.data_ptr(),
        int(flat.dtype == torch.int64), out.data_ptr(), n, v, width, int(vec),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: cudaError {err}")
    embedding_gather.launches += 1
    return out


class _Gather(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU) on flat ids.
    Backward: scatter-add of the output gradient into a zero [V, D]."""

    @staticmethod
    def forward(ctx, table, flat):
        if table.device.type == "cuda":
            out = _launch(table.detach(), flat)
        else:
            out = embedding_gather_plain(table.detach(), flat)
        ctx.save_for_backward(flat)
        ctx.table_rows = table.shape[0]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        dtable = torch.zeros((ctx.table_rows, g.shape[1]), dtype=g.dtype, device=g.device)
        dtable.index_add_(0, flat.clamp(0, ctx.table_rows - 1), g)
        return dtable, None


def embedding_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` as [..., D], differentiable in the table (see the module
    docstring for what the caller owes). CUDA tensors launch the kernel (or
    raise); CPU tensors take `embedding_gather_plain` in the forward."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"embedding_gather runs on cuda or cpu, not {table.device}")
    _check(table, ids)
    out = _Gather.apply(table, ids.reshape(-1))
    return out.view(*ids.shape, table.shape[1])


embedding_gather.launches = 0  # kernel launches since the last reset
