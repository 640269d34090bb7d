"""Batch-affinity contractions for InnerComp / InterComp — the counterpart of
`amid_tpu/ops/affinity.py` and `amid_tpu/ops/pallas_affinity.py`.

* `diag_max_affinity`: a[j] = max_{i,k} seq_a[j, i] . seq_b[j, k], the
  per-user diagonal the reference's broadcast actually computes
  (model_seq.py:462-465, 487-490). No TPU kernel; plain PyTorch.
* `max_affinity_xla`: A[b, c] = max_{i,j} seq_a[b, i] . seq_b[c, j] in fp32,
  blocked over b so peak memory stays at chunk * C * N * M floats (the
  idealized pairwise mode). The name is the JAX function's, for the reader;
  it is what `kernels='torch'` computes.
* `max_affinity_blocked` and `max_affinity_smalln`: the same function by the
  two hand-written kernels of `csrc/affinity.cu` (the counterparts of
  `max_affinity_pallas` and `max_affinity_pallas_smalln`). Their contract is
  the TPU kernels': inputs rounded to bf16 (round to nearest even), products
  exact, sums in fp32; forward only (the hard gate built from A passes no
  gradient). `max_affinity_plain` is that contract in plain PyTorch: it
  differs from the kernels only by the order of the fp32 sums.
* `max_affinity(seq_a, seq_b, kernels)`: the dispatch point. `'cuda'` takes
  the small-N kernel when `smalln_fits`, else the blocked kernel; anything
  else takes `max_affinity_xla`.

On CUDA tensors the two kernel wrappers launch their kernel (counting the
launch in `.launches`) or raise; on CPU tensors they take `max_affinity_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from amid_tpu_torch.ops import _build
from amid_tpu_torch.ops._build import SMEM_LIMIT

KERNEL_WIDTHS = (16, 32, 64, 128)  # D values the kernels are compiled for
_ROW_PAD = 8  # bf16 values of padding per shared-memory row (csrc/affinity.cu)
_SMALLN_PEERS = 16  # peers resident per block of the small-N kernel
_WARPS = 8


def diag_max_affinity(seq_a: torch.Tensor, seq_b: torch.Tensor) -> torch.Tensor:
    """seq_a: [B, N, D], seq_b: [B, M, D] -> [B]."""
    s = torch.bmm(seq_a, seq_b.transpose(1, 2))  # [B, N, M]
    return s.amax(dim=(1, 2))


def max_affinity_xla(
    seq_a: torch.Tensor, seq_b: torch.Tensor, chunk: int = 8
) -> torch.Tensor:
    """seq_a: [B, N, D], seq_b: [C, M, D] -> [B, C]."""
    _, n, d = seq_a.shape
    c, m, _ = seq_b.shape
    y = seq_b.reshape(c * m, d)
    out = [
        torch.matmul(a, y.T).view(a.shape[0], n, c, m).amax(dim=(1, 3))
        for a in seq_a.split(chunk)
    ]
    return torch.cat(out)


def max_affinity_plain(
    seq_a: torch.Tensor, seq_b: torch.Tensor, chunk: int = 8
) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch: inputs rounded to bf16,
    products and sums in fp32. [B, N, D], [C, M, D] -> [B, C] float32."""
    return max_affinity_xla(seq_a.to(torch.bfloat16).float(),
                            seq_b.to(torch.bfloat16).float(), chunk)


def _ceil_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


# The blocked kernel (csrc/affinity.cu, affinity_wgmma_kernel): the bank's
# [C*M, D] rows, as bf16 padded with zeros to 128 columns, stream through in
# 64-row tiles; four query slots of W rows (W a multiple of 8 up to 160, one
# slot a user or 2 or 4 chunks of one) stay resident; the grid is (groups of
# four slots) x (slices of the peers).
TILE_ROWS = 64
K_WIDTH = 128  # operand columns
SLOTS = 4
MAX_WIDTH = 160
CHUNKS = (1, 2, 4)  # slots one user's query may take
MAX_PEERS = 256  # peers per slice: the block's [users, peers] table of maxima
MAX_STAGES = 8
SM_COUNT = 132  # the H100 SXM's; one block of the large shapes fills an SM


class BlockedPlan(NamedTuple):
    """How the blocked kernel takes one shape: slot width and chunks per user,
    the grid (groups x slices), peers per slice, ring buffers, shared memory
    per block in bytes."""
    width: int
    chunks: int
    groups: int
    slices: int
    peers: int
    stages: int
    smem: int


def blocked_smem_bytes(width: int, stages: int, peers: int) -> int:
    """Shared memory of one block of the blocked kernel: four query slots of
    `width` bf16 rows, `stages` 64-row bank tiles (rows of 128 columns), a
    float per (slot, peer), two mbarriers per tile buffer and one for the
    query."""
    return (SLOTS * width * K_WIDTH * 2 + stages * TILE_ROWS * K_WIDTH * 2
            + SLOTS * peers * 4 + (2 * stages + 1) * 8)


def slice_tiles(c: int, m: int, peers: int) -> int:
    """An upper bound on the bank tiles one block streams: a slice's
    peers * m rows, plus the tile it shares with the slice before it."""
    return -(-peers * m // TILE_ROWS) + (peers < c)


@functools.lru_cache(maxsize=512)
def blocked_plan(b: int, c: int, n: int, m: int, d: int) -> BlockedPlan:
    """The blocked kernel's plan for [B, N, D] against [C, M, D]; raises
    naming the limit where the kernel cannot take the shape.

    The query takes the fewest chunks (1, 2 or 4 slots a user) whose width
    ceil8(N / chunks) is at most 160 (N <= 640). The peers are cut into the
    number of slices that minimises waves x tiles per block (blocks of all
    slices run on SM_COUNT SMs, one at a time at the large shapes), fewest
    slices on a tie, at most MAX_PEERS peers a slice. What shared memory
    is left takes up to MAX_STAGES ring buffers of 64 bank rows (no more
    than a block streams tiles; at least 3 fit at every width)."""
    name = "max_affinity_blocked"
    if d not in KERNEL_WIDTHS:
        raise ValueError(f"{name}: the affinity kernels take D in {KERNEL_WIDTHS}; got D={d}")
    for chunks in CHUNKS:
        width = _ceil_to(-(-n // chunks), 8)
        if width <= MAX_WIDTH:
            break
    else:
        raise ValueError(
            f"{name}: N={n} is longer than the blocked kernel takes: at most "
            f"{CHUNKS[-1]} slots of {MAX_WIDTH} query rows, N <= {CHUNKS[-1] * MAX_WIDTH}")
    groups = -(-b * chunks // SLOTS)
    best = None
    for s in range(-(-c // MAX_PEERS), min(c, 65535) + 1):
        peers = -(-c // s)
        slices = -(-c // peers)
        cost = -(-groups * slices // SM_COUNT) * slice_tiles(c, m, peers)
        if best is None or cost < best[0]:
            best = (cost, slices, peers)
    _, slices, peers = best
    fixed = blocked_smem_bytes(width, 0, peers)
    stages = min(MAX_STAGES, max(2, slice_tiles(c, m, peers)),
                 (SMEM_LIMIT - fixed) // (TILE_ROWS * K_WIDTH * 2 + 16))
    return BlockedPlan(width, chunks, groups, slices, peers, stages,
                       blocked_smem_bytes(width, stages, peers))


def smalln_smem_bytes(m: int, d: int) -> int:
    """Shared memory one block of the small-N kernel needs: 16 peers' rows
    resident as bf16, padded, plus the [8, 16] fp32 output tile."""
    return (_SMALLN_PEERS * _ceil_to(m, 8) * (d + _ROW_PAD) * 2
            + _WARPS * _SMALLN_PEERS * 4)


def smalln_fits(m: int, d: int) -> bool:
    """Whether the small-N kernel takes peer sequences of length m and width
    d: its resident set must leave room for a second block on the same SM
    (half of the 232,448 bytes a block may use). The query length does not
    enter: query rows live in registers, 16 at a time."""
    return d in KERNEL_WIDTHS and smalln_smem_bytes(m, d) <= SMEM_LIMIT // 2


def _check(seq_a: torch.Tensor, seq_b: torch.Tensor, name: str) -> None:
    if seq_a.dim() != 3 or seq_b.dim() != 3 or seq_a.shape[2] != seq_b.shape[2]:
        raise ValueError(f"{name}: want [B, N, D] and [C, M, D]; got "
                         f"{tuple(seq_a.shape)} and {tuple(seq_b.shape)}")
    if 0 in seq_a.shape or 0 in seq_b.shape:
        raise ValueError(f"{name}: empty input {tuple(seq_a.shape)}, {tuple(seq_b.shape)}")
    if seq_a.dtype != torch.float32 or seq_b.dtype != torch.float32:
        raise TypeError(f"{name} takes float32; got {seq_a.dtype}, {seq_b.dtype}")
    if seq_a.device != seq_b.device:
        raise ValueError(f"{name}: seq_a on {seq_a.device}, seq_b on {seq_b.device}")


# Each entry point takes one array of 64-bit integers (csrc/affinity.cu has
# the layout), packed in one call: ctypes converts argument by argument.
_PACK_BLOCKED = struct.Struct("<15q").pack
_PACK_SMALLN = struct.Struct("<10q").pack
_REFUSALS = {-1: "a shape the kernel does not take", -2: "a plan the kernel does not take"}
_blocked = _smalln = None  # the bound entry points, resolved at the first launch


def _bind() -> None:
    global _blocked, _smalln
    lib = _build.load("affinity")
    _blocked = _build.bind(lib.max_affinity_blocked, [ctypes.c_char_p])
    _smalln = _build.bind(lib.max_affinity_smalln, [ctypes.c_char_p])


def smem_bytes_of_the_kernels():
    """(affinity_smem_bytes, affinity_smalln_smem_bytes) of the C library,
    typed: the kernels' own shared-memory arithmetic, for the tests."""
    lib = _build.load("affinity")
    i = ctypes.c_int
    return (_build.bind(lib.affinity_smem_bytes, [i, i, i], ctypes.c_size_t),
            _build.bind(lib.affinity_smalln_smem_bytes, [i, i], ctypes.c_size_t))


def _launch(seq_a, seq_b, smalln: bool) -> torch.Tensor:
    name = "max_affinity_smalln" if smalln else "max_affinity_blocked"
    _check(seq_a, seq_b, name)
    (bsz, n, d), (c, m, _) = seq_a.shape, seq_b.shape
    if d not in KERNEL_WIDTHS:
        raise ValueError(f"{name}: the affinity kernels take D in {KERNEL_WIDTHS}; got D={d}")
    if smalln and not smalln_fits(m, d):
        largest = max((x for x in range(1, m) if smalln_fits(x, d)), default=0)
        raise ValueError(
            f"{name}: M={m}, D={d} needs {smalln_smem_bytes(m, d)} bytes of shared memory "
            f"per block; the small-N kernel takes at most {SMEM_LIMIT // 2} (largest M at "
            f"this width: {largest}); use max_affinity_blocked")
    if _blocked is None:
        _bind()
    a = seq_a if seq_a.is_contiguous() else seq_a.contiguous()
    b = seq_b if seq_b.is_contiguous() else seq_b.contiguous()
    # one allocation: the [B, C] result, then the kernels' bf16 copies of the
    # inputs from a 16-byte boundary
    if smalln:
        halves = (bsz * n + c * m) * d
    else:
        plan = blocked_plan(bsz, c, n, m, d)
        halves = (_ceil_to(c * m, TILE_ROWS) + plan.groups * SLOTS * plan.width) * K_WIDTH
    at = _ceil_to(bsz * c, 4)
    buf = a.new_empty(at + -(-halves // 2))
    ptr = buf.data_ptr()
    head = (a.data_ptr(), b.data_ptr(), ptr + 4 * at, ptr, _build.raw_stream(a.device.index))
    if smalln:
        err = _smalln(_PACK_SMALLN(*head, bsz, c, n, m, d))
    else:
        err = _blocked(_PACK_BLOCKED(*head, bsz, c, n, m, d, plan.width, plan.chunks,
                                     plan.slices, plan.peers, plan.stages))
    if err:
        if err in _REFUSALS:
            raise ValueError(f"{name}: {_REFUSALS[err]} ({tuple(seq_a.shape)}, "
                             f"{tuple(seq_b.shape)})")
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return buf.as_strided((bsz, c), (c, 1))


def _wrapper(seq_a, seq_b, smalln: bool, fn) -> torch.Tensor:
    if seq_a.device.type == "cpu":
        _check(seq_a, seq_b, fn.__name__)
        return max_affinity_plain(seq_a, seq_b)
    if seq_a.device.type != "cuda":
        raise ValueError(f"{fn.__name__} runs on cuda or cpu, not {seq_a.device}")
    out = _launch(seq_a, seq_b, smalln)
    fn.launches += 1
    return out


def max_affinity_blocked(seq_a: torch.Tensor, seq_b: torch.Tensor) -> torch.Tensor:
    """A[b, c] = max_{i,j} bf16(seq_a[b, i]) . bf16(seq_b[c, j]) by the blocked
    kernel: [B, N, D], [C, M, D] float32 -> [B, C] float32, no gradient. Any
    B, C, M, N up to 640 (it raises naming the limit), D in `KERNEL_WIDTHS`;
    `blocked_plan` says how it takes a shape. CUDA tensors launch the kernel
    (or raise); CPU tensors take `max_affinity_plain`."""
    return _wrapper(seq_a, seq_b, False, max_affinity_blocked)


def max_affinity_smalln(seq_a: torch.Tensor, seq_b: torch.Tensor) -> torch.Tensor:
    """The same function by the small-N kernel, for peer sequences short
    enough that `smalln_fits(M, D)`; raises otherwise."""
    return _wrapper(seq_a, seq_b, True, max_affinity_smalln)


max_affinity_blocked.launches = 0  # kernel launches since the last reset
max_affinity_smalln.launches = 0


def max_affinity(seq_a: torch.Tensor, seq_b: torch.Tensor,
                 kernels: str = "torch") -> torch.Tensor:
    """Dispatch point of the pairwise affinity. `kernels='cuda'`: the small-N
    kernel when the peers' tiles fit resident, else the blocked kernel (bf16
    inputs, a numerics change against fp32 that can flip a gate at the
    threshold); any other value: `max_affinity_xla` in fp32."""
    if kernels == "cuda":
        if smalln_fits(seq_b.shape[1], seq_b.shape[2]):
            return max_affinity_smalln(seq_a, seq_b)
        return max_affinity_blocked(seq_a, seq_b)
    return max_affinity_xla(seq_a, seq_b)
