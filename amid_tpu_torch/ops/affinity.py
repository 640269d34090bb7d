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

import torch

from amid_tpu_torch.ops import _build
from amid_tpu_torch.ops._build import SMEM_LIMIT

KERNEL_WIDTHS = (16, 32, 64, 128)  # D values the kernels are compiled for
_ROW_PAD = 8  # bf16 values of padding per shared-memory row (csrc/affinity.cu)
_SMALLN_PEERS = 16  # peers resident per block of the small-N kernel
_WARPS = 8
_TARGET_BLOCKS = 264  # two resident blocks on each of the card's 132 SMs


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


def blocked_smem_bytes(n: int, m: int, d: int) -> int:
    """Shared memory one block of the blocked kernel needs: the query's rows
    and one peer's rows as bf16, padded, plus one float per warp."""
    return (_ceil_to(n, 16) + _ceil_to(m, 8)) * (d + _ROW_PAD) * 2 + _WARPS * 4


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


_fns = None  # the bound C entry points, resolved at the first launch


def _kernel_fns():
    """(max_affinity_blocked, max_affinity_smalln, affinity_smem_bytes,
    affinity_smalln_smem_bytes) of `csrc/affinity.cu`, typed once."""
    global _fns
    if _fns is None:
        lib = _build.load("affinity")
        p, i = ctypes.c_void_p, ctypes.c_int
        _fns = (
            _build.bind(lib.max_affinity_blocked, [p, p, p, p, i, i, i, i, i, i, p]),
            _build.bind(lib.max_affinity_smalln, [p, p, p, p, i, i, i, i, i, p]),
            _build.bind(lib.affinity_smem_bytes, [i, i, i], ctypes.c_size_t),
            _build.bind(lib.affinity_smalln_smem_bytes, [i, i], ctypes.c_size_t),
        )
    return _fns


def blocked_grid_y(bsz: int, c: int) -> int:
    """How many blocks share one query user's peers in the blocked kernel:
    1 when the batch alone fills the card, more for a small batch."""
    return max(1, min(c, -(-_TARGET_BLOCKS // bsz), 65535))


def _launch(seq_a, seq_b, smalln: bool) -> torch.Tensor:
    name = "max_affinity_smalln" if smalln else "max_affinity_blocked"
    _check(seq_a, seq_b, name)
    (bsz, n, d), (c, m, _) = seq_a.shape, seq_b.shape
    if d not in KERNEL_WIDTHS:
        raise ValueError(f"{name}: the affinity kernels take D in {KERNEL_WIDTHS}; got D={d}")
    blocked, small, smem_bytes, smalln_bytes = _fns or _kernel_fns()
    if smalln:
        need = smalln_bytes(m, d)
        if need > SMEM_LIMIT // 2:
            largest = max((x for x in range(1, m) if smalln_fits(x, d)), default=0)
            raise ValueError(
                f"{name}: M={m}, D={d} needs {need} bytes of shared memory per block; "
                f"the small-N kernel takes at most {SMEM_LIMIT // 2} (largest M at this "
                f"width: {largest}); use max_affinity_blocked")
    else:
        need = smem_bytes(n, m, d)
        if need > SMEM_LIMIT:
            raise ValueError(
                f"{name}: N={n}, M={m}, D={d} needs {need} bytes of shared memory per "
                f"block; the limit is {SMEM_LIMIT} (ceil16(N) + ceil8(M) <= "
                f"{(SMEM_LIMIT - _WARPS * 4) // ((d + _ROW_PAD) * 2)} at this width)")
    a, b = seq_a.detach().contiguous(), seq_b.detach().contiguous()
    dev = a.device
    scratch = torch.empty((bsz * n + c * m) * d, dtype=torch.bfloat16, device=dev)
    out = torch.empty((bsz, c), dtype=torch.float32, device=dev)
    stream = _build.raw_stream(dev.index)
    if smalln:
        err = small(a.data_ptr(), b.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                    bsz, c, n, m, d, stream)
    else:
        err = blocked(a.data_ptr(), b.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                      bsz, c, n, m, d, blocked_grid_y(bsz, c), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


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
    B, C, N, M that fit its shared-memory tile (it raises naming the limit),
    D in `KERNEL_WIDTHS`. CUDA tensors launch the kernel (or raise); CPU
    tensors take `max_affinity_plain`."""
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
