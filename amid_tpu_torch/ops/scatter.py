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
Types, devices and shapes are checked here, once for both routes (`_check`);
strides and alignment by the C entry point, whose refusals come back as the
exceptions of `_REFUSALS`.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from amid_tpu_torch.ops import _build


_ID_TYPES = (torch.int32, torch.int64)


def _check(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor, name: str) -> None:
    """Every check that needs the tensors, for the kernel and the plain route
    alike: compares on the way in, the texts on the failure path only."""
    if table.dim() not in (2, 3):
        raise ValueError(f"{name}: the table must be [V, D] or [V, K, D]; got {tuple(table.shape)}")
    if ids.dim() != 1 or ids.dtype not in _ID_TYPES:
        raise ValueError(f"{name}: ids must be [U] int32 or int64; got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if rows.shape[0] != ids.shape[0] or rows.shape[1:] != table.shape[1:]:
        raise ValueError(
            f"{name}: rows must be {(ids.shape[0], *table.shape[1:])}; got {tuple(rows.shape)}"
        )
    if table.dtype is not torch.float32 or rows.dtype is not torch.float32:
        raise TypeError(f"{name}: the scatter takes float32; got {table.dtype}, {rows.dtype}")
    if not table.is_contiguous():
        raise ValueError(f"{name}: the table must be contiguous")
    if rows.device != table.device or ids.device != table.device:
        raise ValueError(f"{name}: table on {table.device}, rows on {rows.device}, "
                         f"ids on {ids.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {table.device}")


def _check3(table, mu, nu, ids, t_rows, m_rows, n_rows) -> None:
    for i, (dst, src) in enumerate(((table, t_rows), (mu, m_rows), (nu, n_rows))):
        _check(dst, ids, src, f"scatter_set_unique3[{i}]")
    if mu.shape != table.shape or nu.shape != table.shape:
        raise ValueError("scatter_set_unique3: the three tables must share one shape; got "
                         f"{tuple(table.shape)}, {tuple(mu.shape)} and {tuple(nu.shape)}")


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def scatter_set_unique_plain(table: torch.Tensor, ids: torch.Tensor,
                             rows: torch.Tensor) -> torch.Tensor:
    """`table[ids] = rows` in place for duplicate-free ids, dropping ids
    outside [0, V)."""
    _check(table, ids, rows, "scatter_set_unique")
    return _plain(table, ids, rows)


def _plain(table, ids, rows):
    with torch.no_grad():
        keep = (ids >= 0) & (ids < table.shape[0])
        table.index_copy_(0, ids[keep].long(), rows[keep])
    return table


def scatter_set_unique3_plain(table, mu, nu, ids, t_rows, m_rows, n_rows):
    """The three-array form: one id list, three in-place row writes."""
    _check3(table, mu, nu, ids, t_rows, m_rows, n_rows)
    return _plain3(table, mu, nu, ids, t_rows, m_rows, n_rows)


def _plain3(table, mu, nu, ids, t_rows, m_rows, n_rows):
    for dst, src in ((table, t_rows), (mu, m_rows), (nu, n_rows)):
        _plain(dst, ids, src)
    return table, mu, nu


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_REFUSALS = {  # the C entry point's codes (csrc/scatter_rows.cu)
    -1: (ValueError, "scatter_rows: 1 to 3 pairs, U >= 0, V >= 0 and a row width >= 1"),
    -2: (ValueError, "update rows must have unit stride along the row"),
}

_scatter_rows = None  # the bound C entry point, resolved at the first launch
# it takes one array of 64-bit integers (csrc/scatter_rows.cu has the layout);
# packing it is one call, where ctypes converts argument by argument
_PACK1 = struct.Struct("12q").pack
_PACK3 = struct.Struct("20q").pack


def _bind() -> None:
    global _scatter_rows
    _scatter_rows = _build.bind(_build.load("scatter_rows").scatter_rows, [ctypes.c_char_p])


def _rows2d(rows: torch.Tensor) -> torch.Tensor:
    return rows if rows.dim() == 2 else rows.reshape(rows.shape[0], -1)


def _launch(ids: torch.Tensor, t0, r0, t1=None, r1=None, t2=None, r2=None) -> None:
    """1 or 3 (table, rows) couples sharing `ids`, already checked."""
    if _scatter_rows is None:
        _bind()
    if not ids.is_contiguous():
        ids = ids.contiguous()
    r0 = _rows2d(r0)
    index = t0.device.index
    head = (ids.data_ptr(), ids.dtype is torch.int64, ids.shape[0], t0.shape[0], r0.shape[1],
            index, _build.raw_stream(index),
            t0.data_ptr(), r0.data_ptr(), r0.stride(0), r0.stride(1))
    if t1 is None:
        err = _scatter_rows(_PACK1(1, *head))
    else:
        r1, r2 = _rows2d(r1), _rows2d(r2)
        err = _scatter_rows(_PACK3(
            3, *head, t1.data_ptr(), r1.data_ptr(), r1.stride(0), r1.stride(1),
            t2.data_ptr(), r2.data_ptr(), r2.stride(0), r2.stride(1)))
    if err:
        if err in _REFUSALS:
            kind, text = _REFUSALS[err]
            raise kind(text)
        raise RuntimeError(f"scatter_rows kernel launch failed: cudaError {err}")


def scatter_set_unique(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """`table[ids] = rows` in place (see the module docstring for the
    contract). CUDA tensors launch the kernel (or raise); CPU tensors take
    the plain version."""
    _check(table, ids, rows, "scatter_set_unique")
    if table.device.type == "cpu":
        return _plain(table, ids, rows)
    _launch(ids, table, rows)
    scatter_set_unique.launches += 1
    return table


def scatter_set_unique3(table, mu, nu, ids, t_rows, m_rows, n_rows):
    """`table[ids] = t_rows; mu[ids] = m_rows; nu[ids] = n_rows` in place, in
    one launch. CUDA tensors launch the kernel (or raise); CPU tensors take
    the plain version."""
    _check3(table, mu, nu, ids, t_rows, m_rows, n_rows)
    if table.device.type == "cpu":
        return _plain3(table, mu, nu, ids, t_rows, m_rows, n_rows)
    _launch(ids, table, t_rows, mu, m_rows, nu, n_rows)
    scatter_set_unique3.launches += 1
    return table, mu, nu


scatter_set_unique.launches = 0  # kernel launches since the last reset
scatter_set_unique3.launches = 0
