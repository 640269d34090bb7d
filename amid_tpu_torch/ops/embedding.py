"""Embedding row gather — the counterpart of `amid_tpu/ops/pallas_embedding.py`.

    embedding_gather(table, ids) -> table[ids]                    # [..., D]
    embedding_gather_many(table, [ids_0, ids_1, ...]) -> (table[ids_0], ...)
    embedding_gather_many(table, [ids_0, ...], concat=True)
        -> cat([table[ids_k].view(B, -1, D) for k], dim=1)        # [B, P, D]

table: [V, D] float32 with unit stride along D (the item table, or the lazy
step's gathered `[U, D]` rows); ids: any shape, int32 or int64.

`embedding_gather_many` takes up to four lookups into one table in one kernel
launch; `embedding_gather` is the same call with one lookup. Each id array is
[B, ...]: its first axis is the user, and a user's rows form one contiguous
block of the destination. With `concat=True` the blocks of all lookups stand
side by side in one [B, P, D] tensor (every id array then shares B), written
in place by the kernel through strided destinations: the model's
[target ; negatives] candidates need no `torch.cat`.

What the caller owes. Nothing on the device's side checks the ids (that would
cost a synchronisation): an id outside [0, V) is clamped to the nearest valid
row, in the kernel and in the plain versions alike, as a JAX gather clamps an
out-of-bounds index. Callers pass real rows: `pad_id` is a row of the table,
and the lazy step's `searchsorted` positions lie in [0, U) for every id that
is in its unique list (a position of U could only come from an id above the
sentinel V, which no batch holds).

The forward is the kernel of `csrc/gather_rows.cu`. The backward is the
gather's transpose, a scatter-add into a zero `[V, D]` table (duplicated ids
add up, across lookups too), which the TPU package leaves to XLA: here
`embedding_gather_grad`, the second entry point of that file (one launch up
to 1,024 gradient rows, two beyond; no sort, no memset). It sums each row's
gradients in an order the ids alone fix (`embedding_gather_grad_ordered`
computes the same sums in plain PyTorch, bit for bit), so two calls give
bit-equal tables, and a replayed training step equals the eager one.
`index_add_`'s atomics add in no fixed order; Adam's normalised first
update turns the last-bit differences of a gradient that is zero but for
rounding (an attention key bias) into updates of full size, and the two
steps then part by far more than rounding. The `autograd.Function` is
entered only when a gradient is wanted (grad mode on and a table that
requires it); otherwise the wrapper launches directly. Its backward hands
the kernel each lookup's ids and output gradient as they are: no
concatenation.

On CUDA tensors the wrappers launch the kernel (counting each launch in
`embedding_gather.launches`, whichever wrapper made it) or raise; on CPU
tensors the forward is `embedding_gather_many_plain` and the backward
`embedding_gather_grad_plain` (`index_add_`), so the CPU tests reach them. Types, devices and the grouping are
checked here, once for both routes (`_check`); strides and counts by the C
entry point, whose refusals come back as the exceptions of `_REFUSALS`.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from amid_tpu_torch.ops import _build

MAX_SEGMENTS = 4  # lookups one launch takes (csrc/gather_rows.cu)
_ID_TYPES = (torch.int32, torch.int64)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def embedding_gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, differentiable by autograd."""
    flat = ids.reshape(-1).clamp(0, table.shape[0] - 1)
    return torch.index_select(table, 0, flat).view(*ids.shape, table.shape[1])


def embedding_gather_grad_plain(ids: torch.Tensor, grad: torch.Tensor,
                                rows: int) -> torch.Tensor:
    """The gather's backward in plain PyTorch: a zero [rows, D] table with
    grad[i] added at row ids[i] (clamped to [0, rows)) for every i; ids [N],
    grad [N, D]."""
    dtable = torch.zeros((rows, grad.shape[1]), dtype=grad.dtype, device=grad.device)
    return dtable.index_add_(0, ids.clamp(0, rows - 1), grad)


GRAD_TILE = 128  # positions a tile: the first level of the kernel's order (csrc/gather_rows.cu)


def _fold_runs(x: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Each run of `counts` consecutive rows of x summed from 0 in row order,
    one add after another: [len(counts), D]."""
    starts = torch.cumsum(counts, 0) - counts
    acc = x.new_zeros((counts.numel(), x.shape[1]))
    for k in range(int(counts.max()) if counts.numel() else 0):
        live = counts > k
        acc[live] = acc[live] + x[starts[live] + k]
    return acc


def embedding_gather_grad_ordered(ids: torch.Tensor, grad: torch.Tensor, rows: int,
                                  tile: int = GRAD_TILE) -> torch.Tensor:
    """`embedding_gather_grad_plain`'s table, summed in the kernel's order:
    positions are cut into tiles of `tile`; a row's gradients in one tile
    are added in position order from 0, then the row's tile sums in tile
    order from 0. The CUDA kernel gives these bits exactly; for the tests
    (and `chip_smoke.py`), not for the model. ids [N], grad [N, D]."""
    keys = ids.reshape(-1).clamp(0, rows - 1).long()
    n, width = grad.shape
    n_tiles = max(1, -(-n // tile))
    group = keys * n_tiles + torch.arange(n, device=keys.device) // tile
    order = torch.sort(group, stable=True).indices
    groups, per_group = torch.unique_consecutive(group[order], return_counts=True)
    partial = _fold_runs(grad[order], per_group)  # a row's sum in one tile
    keys_of, per_key = torch.unique_consecutive(groups // n_tiles, return_counts=True)
    table = grad.new_zeros((rows, width))
    table[keys_of] = _fold_runs(partial, per_key)
    return table


def _side_by_side(ids_list) -> torch.Tensor:
    """[B, P] ids of a `concat=True` call: each lookup's ids per user, in order."""
    users = ids_list[0].shape[0]
    if len(ids_list) == 1:
        return ids_list[0].reshape(users, -1)
    return torch.cat([i.reshape(users, -1) for i in ids_list], dim=1)


def embedding_gather_many_plain(table, ids_list, concat: bool = False):
    """`embedding_gather_many` in plain PyTorch, differentiable by autograd
    (one `index_select` per lookup, or one in all with `concat=True`)."""
    ids_list = tuple(ids_list)
    _check(table, ids_list, concat)
    return _plain(table, ids_list, concat)


def _plain(table, ids_list, concat):
    if concat:
        return embedding_gather_plain(table, _side_by_side(ids_list))
    return tuple(embedding_gather_plain(table, ids) for ids in ids_list)


def _check(table, ids_list, concat) -> None:
    """Every check that needs the tensors, for the kernel and the plain route
    alike: compares on the way in, the texts on the failure path only."""
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"embedding_gather: the table must be [V, D] with V >= 1; "
                         f"got {tuple(table.shape)}")
    if table.dtype is not torch.float32:
        raise TypeError(f"embedding_gather takes a float32 table; got {table.dtype}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"embedding_gather runs on cuda or cpu, not {table.device}")
    if not 1 <= len(ids_list) <= MAX_SEGMENTS:
        raise ValueError(f"embedding_gather_many takes 1 to {MAX_SEGMENTS} id arrays; "
                         f"got {len(ids_list)}")
    for ids in ids_list:
        if ids.dtype not in _ID_TYPES:
            raise TypeError(f"embedding_gather takes int32 or int64 ids; got {ids.dtype}")
        if ids.device != table.device:
            raise ValueError(f"embedding_gather: table on {table.device}, ids on {ids.device}")
    if concat:
        users = ids_list[0].shape[0] if ids_list[0].dim() else None
        for ids in ids_list:
            if not ids.dim() or ids.shape[0] != users:
                raise ValueError("embedding_gather_many: concat=True takes id arrays that "
                                 "share their first axis; got "
                                 f"{[tuple(i.shape) for i in ids_list]}")


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------

_REFUSALS = {  # the C entry point's codes (csrc/gather_rows.cu)
    -1: (ValueError, "embedding_gather: the table must be [V, D] with V >= 1 and D >= 1"),
    -2: (ValueError, "embedding_gather: the table must have unit stride along D"),
    -3: (ValueError, "embedding_gather_many: 1 to 4 id arrays, each a whole number of "
                     "ids per user"),
    -4: (ValueError, "embedding_gather: more than 2**31 - 1 rows in one launch"),
    -5: (RuntimeError, "embedding_gather_grad: the scratch is smaller than the kernel's plan"),
}

_gather_rows = _gather_rows_grad = _grad_scratch = None  # the bound C entry points
# each takes one array of 64-bit integers (csrc/gather_rows.cu has the layouts);
# packing it is one call, where ctypes converts argument by argument
_PACK = [None] + [struct.Struct(f"{9 + 5 * k}q").pack for k in range(1, MAX_SEGMENTS + 1)]
_PACK_GRAD = [None] + [struct.Struct(f"{9 + 4 * k}q").pack for k in range(1, MAX_SEGMENTS + 1)]
_scratch_bytes: dict = {}  # (n, V, D, device) -> the backward's scratch in bytes


def _bind() -> None:
    global _gather_rows, _gather_rows_grad, _grad_scratch
    lib = _build.load("gather_rows")
    _gather_rows = _build.bind(lib.gather_rows, [ctypes.c_char_p])
    _gather_rows_grad = _build.bind(lib.gather_rows_grad, [ctypes.c_char_p])
    _grad_scratch = _build.bind(lib.gather_rows_grad_scratch, [ctypes.c_longlong] * 3 + [
        ctypes.c_int], ctypes.c_longlong)
    tile = _build.bind(lib.gather_rows_grad_chunk, [])()
    if tile != GRAD_TILE:
        raise RuntimeError(f"gather_rows.cu's tile is {tile} positions, GRAD_TILE {GRAD_TILE}")


def _raise(err: int, name: str):
    if err in _REFUSALS:
        exc, text = _REFUSALS[err]
        raise exc(text)
    raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _launch(table, ids_list, concat):
    """One launch for all lookups, on checked CUDA tensors."""
    if _gather_rows is None:
        _bind()
    rows, width = table.shape
    kind = ids_list[0].dtype
    for ids in ids_list:
        if ids.dtype is not kind:  # one integer type per launch
            ids_list = [i.long() for i in ids_list]
            kind = torch.int64
            break
    # contiguous copies stay referenced until the launch is in the stream
    ids_list = [i if i.is_contiguous() else i.contiguous() for i in ids_list]
    # per lookup: ids pointer, number of ids, ids per user, destination pointer,
    # destination stride between users in floats
    segments = []
    if concat:  # one [B, P, D] block; lookup k owns columns [first_k, first_k + per_k)
        users = ids_list[0].shape[0]
        pers = [ids.numel() // users if users else 0 for ids in ids_list]
        total = sum(pers)
        out = table.new_empty((users, total, width))
        ptr = out.data_ptr()
        for ids, per in zip(ids_list, pers):
            segments += (ids.data_ptr(), per * users, per, ptr, total * width)
            ptr += 4 * per * width
    else:  # one contiguous tensor per lookup: a single block, whoever the users are
        out = []
        for ids in ids_list:
            dst = table.new_empty((*ids.shape, width))
            n = ids.numel()
            segments += (ids.data_ptr(), n, n or 1, dst.data_ptr(), 0)
            out.append(dst)
        out = tuple(out)
    index = table.device.index
    stride0, stride1 = table.stride()
    err = _gather_rows(_PACK[len(ids_list)](
        table.data_ptr(), stride0, stride1, rows, width, kind is torch.int64, len(ids_list),
        index, _build.raw_stream(index), *segments))
    if err:
        _raise(err, "gather_rows")
    embedding_gather.launches += 1
    return out


def embedding_gather_grad(ids: torch.Tensor, grad: torch.Tensor, rows: int) -> torch.Tensor:
    """The gather's backward, `embedding_gather_grad_plain`'s function: on
    CUDA tensors `csrc/gather_rows.cu`'s `gather_rows_grad` (counted in
    `embedding_gather_grad.launches`), summing each row's gradients in the
    order of `embedding_gather_grad_ordered` (two calls are bit-equal); on
    CPU tensors the plain version. ids [N] int32 or int64, grad [N, D] fp32
    with unit stride along D."""
    if grad.device.type != "cuda":
        return embedding_gather_grad_plain(ids, grad, rows)
    return _launch_grad(((ids, grad),), rows)


def _launch_grad(pairs, rows: int) -> torch.Tensor:
    """One backward for up to four (ids [n_k], grad [n_k, D]) pairs taken one
    after another, on CUDA tensors: a [rows, D] table, every row written."""
    if _gather_rows_grad is None:
        _bind()
    pairs = [(i.reshape(-1), g if g.stride(-1) == 1 else g.contiguous()) for i, g in pairs]
    if len({i.dtype for i, _ in pairs}) > 1:  # one integer type per launch
        pairs = [(i.long(), g) for i, g in pairs]
    pairs = [(i if i.is_contiguous() else i.contiguous(), g) for i, g in pairs]
    width = pairs[0][1].shape[1]
    n = sum(i.numel() for i, _ in pairs)
    index = pairs[0][1].device.index
    key = (n, rows, width, index)
    nbytes = _scratch_bytes.get(key)
    if nbytes is None:
        nbytes = _scratch_bytes[key] = _grad_scratch(n, rows, width, index)
        if nbytes < 0:
            _raise(-nbytes, "gather_rows_grad")
    dtable = pairs[0][1].new_empty((rows, width))
    scratch = torch.empty(max(nbytes, 16), dtype=torch.uint8, device=dtable.device)
    segments = []
    for i, g in pairs:
        segments += (i.data_ptr(), i.numel(), g.data_ptr(), g.stride(0))
    err = _gather_rows_grad(_PACK_GRAD[len(pairs)](
        len(pairs), rows, width, pairs[0][0].dtype is torch.int64, dtable.data_ptr(),
        scratch.data_ptr(), nbytes, index, _build.raw_stream(index), *segments))
    if err:
        _raise(err, "gather_rows_grad")
    embedding_gather_grad.launches += 1
    return dtable


def _forward(table, ids_list, concat):
    """The forward of both wrappers on checked tensors, without autograd."""
    if table.device.type == "cuda":
        return _launch(table, ids_list, concat)
    with torch.no_grad():
        return _plain(table, ids_list, concat)


class _GatherMany(torch.autograd.Function):
    """Forward: one kernel launch (CUDA) or the plain version (CPU) for all
    lookups. Backward: the gather's backward of the output gradients, each
    lookup's ids and gradient handed to the kernel as they are (CUDA), or
    `embedding_gather_grad_plain` over the concatenated ids (CPU)."""

    @staticmethod
    def forward(ctx, table, concat, *ids_list):
        got = _forward(table, ids_list, concat)
        if concat:  # one [B, P, D] gradient: its rows are the ids side by side
            ctx.save_for_backward(_side_by_side(ids_list))
            got = (got,)
        else:
            ctx.save_for_backward(*ids_list)
        ctx.table_rows = table.shape[0]
        return got

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        ids = ctx.saved_tensors
        width = grads[0].shape[-1]
        pairs = [(i.reshape(-1), g.reshape(-1, width)) for i, g in zip(ids, grads)]
        if grads[0].device.type == "cuda":
            dtable = _launch_grad(pairs, ctx.table_rows)
        elif len(pairs) == 1:
            dtable = embedding_gather_grad_plain(*pairs[0], ctx.table_rows)
        else:
            dtable = embedding_gather_grad_plain(torch.cat([i for i, _ in pairs]),
                                                 torch.cat([g for _, g in pairs]),
                                                 ctx.table_rows)
        return (dtable, None) + (None,) * (len(ctx.needs_input_grad) - 2)


def embedding_gather_many(table: torch.Tensor, ids_list, concat: bool = False):
    """Up to four lookups into `table` in one kernel launch; see the module
    docstring. Returns a tuple of tensors shaped `ids_k.shape + (D,)`, or with
    `concat=True` one [B, P, D] tensor. Differentiable in the table. CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain version
    in the forward."""
    ids_list = tuple(ids_list)
    _check(table, ids_list, concat)
    if torch.is_grad_enabled() and table.requires_grad:
        got = _GatherMany.apply(table, concat, *ids_list)
        return got[0] if concat else got
    return _forward(table, ids_list, concat)


def embedding_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` as [..., D], differentiable in the table: one lookup of
    `embedding_gather_many`."""
    return embedding_gather_many(table, (ids,))[0]


embedding_gather.launches = 0  # kernel launches since the last reset, of both wrappers
embedding_gather_grad.launches = 0  # backward calls (one or two kernels each) since the last reset
