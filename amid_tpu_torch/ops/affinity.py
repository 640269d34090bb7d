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
  the small-N kernel where `smalln_faster(N)` (a crossover measured on the
  H100), else the blocked kernel; anything else takes `max_affinity_xla`.

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
from amid_tpu_torch.ops.precision import bf16_round

# Operand columns of a plane: the pre-pass pads a row with zeros to a whole
# number of 128-column planes, so the kernels take any D from 1 to MAX_D
PLANE = 128
MAX_D = 65536

def diag_max_affinity(seq_a: torch.Tensor, seq_b: torch.Tensor,
                      bf16: bool = False) -> torch.Tensor:
    """seq_a: [B, N, D], seq_b: [B, M, D] -> [B]; with `bf16` both inputs
    rounded to bf16 first (the JAX einsum under the bfloat16 context)."""
    if bf16:
        seq_a, seq_b = bf16_round(seq_a), bf16_round(seq_b)
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
    return max_affinity_xla(bf16_round(seq_a), bf16_round(seq_b), chunk)


def _ceil_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


# Both kernels are one __global__ template (csrc/affinity.cu,
# affinity_wgmma_kernel): the bank's [C*M, D] rows, as bf16 padded with zeros
# to planes of 128 columns, stream through in 64-row tiles; four query slots
# of W rows (W a multiple of 8 up to 160) stay resident; the grid is (groups
# of four slots) x (slices of the peers). The blocked kernel (K6) gives a slot
# one user or KC chunks of one (KC in 1, 2 or a multiple of 4: from 8 on a
# user's slots span KC / 4 blocks, which fold into its outputs by an atomic
# max); the small-N kernel (K7) packs U = 8, 4 or 2 users into each slot.
# Above D = 128 (more than one plane: the chunked instances) each ring
# buffer holds a plane of a bank tile and the same plane of the four slots,
# the planes of a tile in turn, and slots are at most 80 rows wide.
TILE_ROWS = 64
K_WIDTH = PLANE  # operand columns of a plane
TILE_BYTES = TILE_ROWS * K_WIDTH * 2
SLOTS = 4
MAX_WIDTH = 160
CHUNKED_MAX_WIDTH = 80  # slot rows above D = 128
SMALLN_USERS = (8, 4, 2)  # users a slot may hold (K7), most first
SMALLN_MAX_N = MAX_WIDTH // SMALLN_USERS[-1]  # 80: two users a slot
MAX_PEERS = 256  # peers per slice: the block's [users, peers] table of maxima
MAX_STAGES = 8
SM_COUNT = 132  # the H100 SXM's; one block of the large shapes fills an SM


class AffinityPlan(NamedTuple):
    """How a kernel takes one shape: slot width, chunks per user (K6), users
    per slot (K7; 1 for K6), the grid (groups x slices), peers per slice,
    ring buffers, shared memory per block in bytes, 128-column planes."""
    width: int
    chunks: int
    users: int
    groups: int
    slices: int
    peers: int
    stages: int
    smem: int
    planes: int = 1


def planes(d: int) -> int:
    """The 128-column planes of a row of D columns."""
    return -(-d // PLANE)


def max_width(d: int) -> int:
    """The widest query slot at D: 160 rows in one plane, 80 above."""
    return MAX_WIDTH if planes(d) == 1 else CHUNKED_MAX_WIDTH


def smalln_max_n(d: int) -> int:
    """The longest query the small-N kernel takes at D (two users a slot):
    80 up to D = 128, 40 above."""
    return max_width(d) // SMALLN_USERS[-1]


def affinity_smem_bytes(width: int, stages: int, peers: int, users: int = 1,
                        dc: int = 1) -> int:
    """Shared memory of one block of either kernel: four query slots of
    `width` bf16 rows of one plane and `stages` 64-row bank tiles of one
    plane (with `dc` > 1 planes, each of the `stages` buffers holds a tile's
    plane and the four slots' plane), a float per (user, peer) for the 4 *
    `users` users of the block's slots, two mbarriers per buffer and one for
    the query."""
    slots = SLOTS * width * K_WIDTH * 2
    ring = stages * (TILE_BYTES + slots) if dc > 1 else slots + stages * TILE_BYTES
    return ring + SLOTS * users * peers * 4 + (2 * stages + 1) * 8


def slice_tiles(c: int, m: int, peers: int) -> int:
    """An upper bound on the bank tiles one block streams: a slice's
    peers * m rows, plus the tile it shares with the slice before it."""
    return -(-peers * m // TILE_ROWS) + (peers < c)


def _check_width(name: str, d: int) -> None:
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{name}: the affinity kernels take D from 1 to {MAX_D}; got D={d}")


def _plan(b: int, c: int, m: int, width: int, chunks: int, users: int, dc: int) -> AffinityPlan:
    """The grid and the ring for a slot layout. The peers are cut into the
    number of slices that minimises waves x tiles per block (blocks of all
    slices run on SM_COUNT SMs, one at a time at the large shapes), fewest
    slices on a tie, at most MAX_PEERS peers a slice. What shared memory is
    left takes up to MAX_STAGES ring buffers (no more than a block streams
    items, a tile's planes each; at least 2 fit at every width)."""
    groups = -(-b * chunks // (SLOTS * users))
    best = None
    for s in range(-(-c // MAX_PEERS), min(c, 65535) + 1):
        peers = -(-c // s)
        slices = -(-c // peers)
        cost = -(-groups * slices // SM_COUNT) * slice_tiles(c, m, peers)
        if best is None or cost < best[0]:
            best = (cost, slices, peers)
    _, slices, peers = best
    fixed = affinity_smem_bytes(width, 0, peers, users, dc)
    per_stage = affinity_smem_bytes(width, 1, 0, users, dc) - affinity_smem_bytes(
        width, 0, 0, users, dc)
    stages = min(MAX_STAGES, max(2, slice_tiles(c, m, peers) * dc),
                 (SMEM_LIMIT - fixed) // per_stage)
    return AffinityPlan(width, chunks, users, groups, slices, peers, stages,
                        affinity_smem_bytes(width, stages, peers, users, dc), dc)


def query_chunks(n: int, d: int) -> int:
    """The slots a user's query of n rows takes in the blocked kernel: the
    fewest KC in 1, 2 or a multiple of 4 whose slots of ceil8(N / KC) rows
    fit `max_width(d)`."""
    k = -(-n // max_width(d))
    return k if k <= 2 else -(-k // SLOTS) * SLOTS


@functools.lru_cache(maxsize=512)
def blocked_plan(b: int, c: int, n: int, m: int, d: int) -> AffinityPlan:
    """The blocked kernel's plan for [B, N, D] against [C, M, D]; any B, C,
    N, M and D up to MAX_D (it raises naming the limit beyond). The query
    takes `query_chunks(n, d)` slots a user of width ceil8(N / KC); the grid
    and ring are `_plan`'s."""
    _check_width("max_affinity_blocked", d)
    chunks = query_chunks(n, d)
    return _plan(b, c, m, _ceil_to(-(-n // chunks), 8), chunks, 1, planes(d))


@functools.lru_cache(maxsize=512)
def smalln_plan(b: int, c: int, n: int, m: int, d: int) -> AffinityPlan:
    """The small-N kernel's plan; raises naming the limit (N <= 80, 40 above
    D = 128: `smalln_max_n`) where the kernel cannot take the shape. A slot
    holds the most users U in (8, 4, 2) whose columns, N a user rounded up
    to a multiple of 8 / U, fit in `max_width(d)` (160; 80 above D = 128):
    U = 8 for N <= 20, 4 up to 40, 2 up to 80 (above D = 128: 10, 20, 40);
    the width is 8 * ceil(N * U / 8). Any B, C and M; the grid and ring are
    `_plan`'s."""
    name = "max_affinity_smalln"
    _check_width(name, d)
    for users in SMALLN_USERS:
        width = _ceil_to(n * users, 8)
        if width <= max_width(d):
            break
    else:
        raise ValueError(
            f"{name}: N={n} is longer than the small-N kernel takes at D={d}: at least "
            f"{SMALLN_USERS[-1]} users in a slot of {max_width(d)} query columns, "
            f"N <= {smalln_max_n(d)}; use max_affinity_blocked")
    return _plan(b, c, m, width, 1, users, planes(d))


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
_PACK = struct.Struct("<15q").pack
_REFUSALS = {-1: "a shape the kernel does not take", -2: "a plan the kernel does not take",
             -3: f"a query longer than the small-N kernel takes (N <= {SMALLN_MAX_N})"}
_blocked = _smalln = None  # the bound entry points, resolved at the first launch


def _bind() -> None:
    global _blocked, _smalln
    lib = _build.load("affinity")
    _blocked = _build.bind(lib.max_affinity_blocked, [ctypes.c_char_p])
    _smalln = _build.bind(lib.max_affinity_smalln, [ctypes.c_char_p])


def smem_bytes_of_the_kernels():
    """`affinity_smem_bytes(W, U, stages, peers, dc)` of the C library, typed:
    the kernels' own shared-memory arithmetic, for the tests."""
    lib = _build.load("affinity")
    i = ctypes.c_int
    return _build.bind(lib.affinity_smem_bytes, [i, i, i, i, i], ctypes.c_size_t)


def _launch(seq_a, seq_b, smalln: bool) -> torch.Tensor:
    _check(seq_a, seq_b, "max_affinity_smalln" if smalln else "max_affinity_blocked")
    (bsz, n, d), (c, m, _) = seq_a.shape, seq_b.shape
    # raises naming the limit on a shape the kernel does not take
    plan = (smalln_plan if smalln else blocked_plan)(bsz, c, n, m, d)
    if _blocked is None:
        _bind()
    a = seq_a if seq_a.is_contiguous() else seq_a.contiguous()
    b = seq_b if seq_b.is_contiguous() else seq_b.contiguous()
    # one allocation: the [B, C] result, then the kernels' bf16 operands (the
    # bank's planes, then the query slots') from a 16-byte boundary
    halves = (_ceil_to(c * m, TILE_ROWS) + plan.groups * SLOTS * plan.width) * K_WIDTH * plan.planes
    at = _ceil_to(bsz * c, 4)
    buf = a.new_empty(at + halves // 2)
    ptr = buf.data_ptr()
    args = _PACK(a.data_ptr(), b.data_ptr(), ptr + 4 * at, ptr,
                 _build.raw_stream(a.device.index), bsz, c, n, m, d, plan.width,
                 plan.users if smalln else plan.chunks, plan.slices, plan.peers, plan.stages)
    err = _smalln(args) if smalln else _blocked(args)
    if err:
        name = "max_affinity_smalln" if smalln else "max_affinity_blocked"
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
    B, C, M, N and D up to MAX_D (it raises naming the limit beyond);
    `blocked_plan` says how it takes a shape. CUDA tensors launch the kernel
    (or raise); CPU tensors take `max_affinity_plain`."""
    return _wrapper(seq_a, seq_b, False, max_affinity_blocked)


def max_affinity_smalln(seq_a: torch.Tensor, seq_b: torch.Tensor) -> torch.Tensor:
    """The same function by the small-N kernel: several query users in each
    slot. Any B, C, M, N up to `smalln_max_n(D)` (80, 40 above D = 128; it
    raises naming the limit), D up to MAX_D; `smalln_plan` says how it takes
    a shape.
    Bit-equal to `max_affinity_blocked` wherever both take a shape."""
    return _wrapper(seq_a, seq_b, True, max_affinity_smalln)


max_affinity_blocked.launches = 0  # kernel launches since the last reset
max_affinity_smalln.launches = 0


def smalln_faster(n: int, d: int = PLANE) -> bool:
    """Whether `max_affinity(..., 'cuda')` sends a query of length n at width
    d to the small-N kernel: where it was faster than the blocked kernel on
    the card, which is everywhere it takes a shape (`smalln_max_n(d)`; above
    D = 128 no crossover was swept, and the same rule holds). `chip_smoke.py`'s crossover sweep
    (`affinity_crossover` records; NVIDIA H100 80GB HBM3, 700.00 W), device
    ms of one call at B=C=256, D=128, N=M, small-N / blocked:
    N=8 0.0088 / 0.0255, 16 0.0144 / 0.0457, 20 0.0188 / 0.0571,
    24 0.0271 / 0.0659, 32 0.0389 / 0.0895, 40 0.0534 / 0.1142,
    48 0.0857 / 0.1355, 64 0.1379 / 0.1923, 80 0.1864 / 0.2403. Beyond
    N=80 only the blocked kernel takes the shape."""
    return n <= smalln_max_n(d)


def max_affinity(seq_a: torch.Tensor, seq_b: torch.Tensor,
                 kernels: str = "torch", bf16: bool = False) -> torch.Tensor:
    """Dispatch point of the pairwise affinity. `kernels='cuda'`: the small-N
    kernel where `smalln_faster(N)`, else the blocked kernel (bf16 inputs, a
    numerics change against fp32 that can flip a gate at the threshold; the
    two kernels are bit-equal); any other value: `max_affinity_xla` in fp32,
    or with `bf16` (the model's bf16 mode) `max_affinity_plain`, the kernels'
    bf16 inputs, so that both routes compute the same gates."""
    if kernels == "cuda":
        if smalln_faster(seq_a.shape[1], seq_a.shape[2]):
            return max_affinity_smalln(seq_a, seq_b)
        return max_affinity_blocked(seq_a, seq_b)
    return max_affinity_plain(seq_a, seq_b) if bf16 else max_affinity_xla(seq_a, seq_b)
