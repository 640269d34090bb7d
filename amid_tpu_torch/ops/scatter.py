"""Unique-row scatter — the counterpart of `amid_tpu/ops/pallas_scatter.py`.

`scatter_set_unique(table, ids, rows)` writes `table[ids[n]] = rows[n]` in
place and `scatter_set_unique3(table, mu, nu, ids, t_rows, m_rows, n_rows)`
does the same for the three arrays of the lazy table Adam in one launch
(`train/lazy.py`). Both return the arrays they wrote into.

Contract, as in the JAX package: `ids` is [U] int32 or int64 and its in-range
entries are duplicate free (the caller's duty — a sorted-unique list with a
sentinel tail in the lazy step); an id outside [0, V) is dropped, not clamped.
Tables are contiguous float32 `[V, D]` or `[V, K, D]`; the update rows match
the table's row shape and may be any row-contiguous view.

The write is in place, under `torch.no_grad()`, into the storage the tensors
already own (the semantics of `index_copy_`), so an `nn.Parameter`, an
optimizer moment and a `state_dict` entry keep pointing at the same memory.

On CUDA tensors the wrappers launch the kernel of `csrc/scatter_rows.cu`
(counting the launch in `.launches`) or raise; on CPU tensors they take the
plain versions `scatter_set_unique_plain` / `scatter_set_unique3_plain`.
"""

from __future__ import annotations

import ctypes
import math

import torch


def _check(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor, name: str) -> None:
    if table.dim() not in (2, 3):
        raise ValueError(f"{name}: the table must be [V, D] or [V, K, D]; got {tuple(table.shape)}")
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: ids must be [U] int32 or int64; got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if tuple(rows.shape) != (ids.shape[0], *table.shape[1:]):
        raise ValueError(
            f"{name}: rows must be {(ids.shape[0], *table.shape[1:])}; got {tuple(rows.shape)}"
        )
    if table.dtype != torch.float32 or rows.dtype != torch.float32:
        raise TypeError(f"{name}: the scatter takes float32; got {table.dtype}, {rows.dtype}")
    if not table.is_contiguous():
        raise ValueError(f"{name}: the table must be contiguous")
    if rows.device != table.device or ids.device != table.device:
        raise ValueError(f"{name}: table on {table.device}, rows on {rows.device}, "
                         f"ids on {ids.device}")


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def scatter_set_unique_plain(table: torch.Tensor, ids: torch.Tensor,
                             rows: torch.Tensor) -> torch.Tensor:
    """`table[ids] = rows` in place for duplicate-free ids, dropping ids
    outside [0, V)."""
    _check(table, ids, rows, "scatter_set_unique")
    with torch.no_grad():
        keep = (ids >= 0) & (ids < table.shape[0])
        table.index_copy_(0, ids[keep].long(), rows[keep])
    return table


def scatter_set_unique3_plain(table, mu, nu, ids, t_rows, m_rows, n_rows):
    """The three-array form: one id list, three in-place row writes."""
    for dst, src in ((table, t_rows), (mu, m_rows), (nu, n_rows)):
        scatter_set_unique_plain(dst, ids, src)
    return table, mu, nu


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _kernel_lib():
    from amid_tpu_torch.ops import _build

    lib = _build.load("scatter_rows")
    if not getattr(lib, "_amid_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.scatter_rows.argtypes = [
            i, p, p, p, p, p, p, ll, ll, ll,  # n_pairs, 3 dst, 3 src, 3 strides
            p, i, i, ll, i, i, p,  # ids, ids64, U, V, width, vec, stream
        ]
        lib.scatter_rows.restype = ctypes.c_int
        lib._amid_typed = True
    return lib


def _launch(pairs, ids: torch.Tensor) -> None:
    """pairs: 1 or 3 (table, rows) couples sharing `ids`, already checked."""
    table0 = pairs[0][0]
    v = table0.shape[0]
    width = math.prod(table0.shape[1:])
    u = ids.shape[0]
    if not ids.is_contiguous():
        ids = ids.contiguous()
    dsts, srcs, strides = [], [], []
    for table, rows in pairs:
        if tuple(table.shape) != tuple(table0.shape):
            raise ValueError("the three tables must share one shape; got "
                             f"{tuple(table.shape)} and {tuple(table0.shape)}")
        rows2 = rows.reshape(u, width) if rows.dim() != 2 else rows
        if u and rows2.stride(1) != 1:
            raise ValueError("update rows must have unit stride along the row")
        dsts.append(table)
        srcs.append(rows2)
        strides.append(rows2.stride(0) if u else width)
    vec = width % 4 == 0 and all(s % 4 == 0 for s in strides) and all(
        x.data_ptr() % 16 == 0 for x in (*dsts, *srcs))
    pad = 3 - len(pairs)
    err = _kernel_lib().scatter_rows(
        len(pairs),
        *[t.data_ptr() for t in dsts], *([None] * pad),
        *[r.data_ptr() for r in srcs], *([None] * pad),
        *strides, *([0] * pad),
        ids.data_ptr(), int(ids.dtype == torch.int64), u, v, width, int(vec),
        torch.cuda.current_stream(table0.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"scatter_rows kernel launch failed: cudaError {err}")


def scatter_set_unique(table: torch.Tensor, ids: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """`table[ids] = rows` in place (see the module docstring for the
    contract). CUDA tensors launch the kernel (or raise); CPU tensors take
    `scatter_set_unique_plain`."""
    if table.device.type == "cpu":
        return scatter_set_unique_plain(table, ids, rows)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_set_unique runs on cuda or cpu, not {table.device}")
    _check(table, ids, rows, "scatter_set_unique")
    _launch([(table, rows.detach())], ids)
    scatter_set_unique.launches += 1
    return table


def scatter_set_unique3(table, mu, nu, ids, t_rows, m_rows, n_rows):
    """`table[ids] = t_rows; mu[ids] = m_rows; nu[ids] = n_rows` in place, in
    one launch. CUDA tensors launch the kernel (or raise); CPU tensors take
    `scatter_set_unique3_plain`."""
    if table.device.type == "cpu":
        return scatter_set_unique3_plain(table, mu, nu, ids, t_rows, m_rows, n_rows)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_set_unique3 runs on cuda or cpu, not {table.device}")
    pairs = [(table, t_rows), (mu, m_rows), (nu, n_rows)]
    for i, (dst, src) in enumerate(pairs):
        _check(dst, ids, src, f"scatter_set_unique3[{i}]")
    _launch([(dst, src.detach()) for dst, src in pairs], ids)
    scatter_set_unique3.launches += 1
    return table, mu, nu


scatter_set_unique.launches = 0  # kernel launches since the last reset
scatter_set_unique3.launches = 0
