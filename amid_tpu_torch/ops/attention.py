"""Fused multi-head attention — the counterpart of
`amid_tpu/ops/pallas_attention.py::fused_attention`.

Layout is the JAX package's: q, k, v are [B, T, D] with the h heads packed in
D; `bias` is additive, [1|B, 1, 1|T, T] (causal -1e9 for SASRec, key-padding
for BERT4Rec); the per-head scale is 1/sqrt(dh); dropout with `rate` drops
attention probabilities and scales the kept ones by 1/(1 - rate).

* `fused_attention` is the wrapper of the CUDA kernels
  `csrc/attention_fwd.cu` and `csrc/attention_bwd.cu`, joined by one
  `torch.autograd.Function`. On CUDA tensors the forward launches the forward
  kernel (counted in `fused_attention.launches`) and a gradient launches the
  backward kernel (counted in `fused_attention.backward_launches`), or they
  raise; on CPU tensors it computes `attention_plain`. `bias` and `seed` get
  no gradient.
* `attention_plain` is the same function in plain PyTorch (with autograd),
  the version the CPU tests hold against JAX and the kernel is held against
  on the card.
* `attention_bwd_plain` repeats the backward kernel's arithmetic in plain
  PyTorch: dq, dk, dv from q, k, v, bias and the output's gradient, with the
  probabilities recomputed and the dropout mask regenerated.
* `dropout_keep_mask` is the counter-based dropout mask both versions use:
  a pure function of (seed, b, h, i, j), so kernel and plain agree bit for
  bit. The TPU's own random bits cannot be reproduced; against JAX only
  rate 0 compares.
"""

from __future__ import annotations

import ctypes
import math

import torch

from amid_tpu_torch.ops import _build
from amid_tpu_torch.ops._build import SMEM_LIMIT

_BIAS_SHAPES = "[1|B, 1, 1|T, T]"
_M32 = 0xFFFFFFFF
_MIX_KEY0 = 0x9E3779B9
KERNEL_HEAD_DIMS = (8, 16, 32, 64)


def check_bias(bias: torch.Tensor, bsz: int, t: int) -> None:
    """Validates an additive bias as `pallas_attention.py::_check_bias` does."""
    ok = (
        bias.dim() == 4
        and bias.shape[0] in (1, bsz)
        and bias.shape[1] == 1
        and bias.shape[2] in (1, t)
        and bias.shape[3] == t
    )
    if not ok:
        raise ValueError(
            f"bias must be {_BIAS_SHAPES}; got {tuple(bias.shape)} for T={t}, B={bsz}"
        )


def _check_inputs(q, k, v, heads: int, rate: float) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one [B, T, D] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[2] % heads:
        raise ValueError(f"D={q.shape[2]} is not divisible by heads={heads}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1); got {rate}")


# ---------------------------------------------------------------------------
# counter-based dropout mask (shared with the kernel)
# ---------------------------------------------------------------------------

def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32), without overflowing int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _mix(x, v):
    """mix(x, v) = fmix32(x ^ (v * 0x9E3779B1 + 0x7F4A7C15)) mod 2^32; works
    on Python ints and on int64 tensors alike."""
    return _fmix32(x ^ ((_mul32(v, 0x9E3779B1) + 0x7F4A7C15) & _M32))


def keep_threshold(rate: float) -> int:
    """Integer form of `u >= rate` for u = (bits >> 8) / 2^24."""
    return math.ceil(rate * (1 << 24))


def dropout_keep_mask(
    seed: int, bsz: int, heads: int, t: int, rate: float, device=None
) -> torch.Tensor:
    """Boolean keep mask [B, heads, T, T] of the kernel's dropout.

    bits(b, h, i, j) = mix(mix(mix(mix(K0, seed), b*heads + h), i), j) and the
    element is kept iff bits >> 8 >= ceil(rate * 2^24)."""
    stream = _mix(_MIX_KEY0, seed & _M32)
    bh = torch.arange(bsz * heads, dtype=torch.int64, device=device)
    idx = torch.arange(t, dtype=torch.int64, device=device)
    key_bh = _mix(stream, bh)  # [BH]
    key_i = _mix(key_bh[:, None], idx[None, :])  # [BH, T]
    bits = _mix(key_i[:, :, None], idx[None, None, :])  # [BH, T, T]
    return ((bits >> 8) >= keep_threshold(rate)).view(bsz, heads, t, t)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    seed: int,
    heads: int,
    rate: float,
) -> torch.Tensor:
    """softmax(Q K^T / sqrt(dh) + bias) [dropout] V per head, in plain
    PyTorch. Same arguments and result as `fused_attention`."""
    _check_inputs(q, k, v, heads, rate)
    bsz, t, d = q.shape
    check_bias(bias, bsz, t)
    dh = d // heads

    def split(x):  # [B, T, D] -> [B, h, T, dh]
        return x.reshape(bsz, t, heads, dh).transpose(1, 2)

    s = torch.matmul(split(q), split(k).transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    p = torch.softmax(s + bias, dim=-1)
    if rate > 0.0:
        keep = dropout_keep_mask(seed, bsz, heads, t, rate, q.device)
        p = p * keep * (1.0 / (1.0 - rate))
    o = torch.matmul(p, split(v))
    return o.transpose(1, 2).reshape(bsz, t, d)


def attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    dout: torch.Tensor,
    seed: int,
    heads: int,
    rate: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `attention_plain` for the output gradient `dout`
    [B, T, D], by the backward kernel's arithmetic:

        dV = Pd^T dO;  dP = (dO V^T) * keep / (1 - rate)
        dS = P * (dP - rowsum(dP * P));  dQ = dS K / sqrt(dh);  dK = dS^T Q / sqrt(dh)

    with P = softmax(S) recomputed and Pd = P * keep / (1 - rate)."""
    _check_inputs(q, k, v, heads, rate)
    bsz, t, d = q.shape
    check_bias(bias, bsz, t)
    dh = d // heads
    scale = 1.0 / math.sqrt(dh)

    def split(x):  # [B, T, D] -> [B, h, T, dh]
        return x.reshape(bsz, t, heads, dh).transpose(1, 2)

    def merge(x):  # [B, h, T, dh] -> [B, T, D]
        return x.transpose(1, 2).reshape(bsz, t, d)

    with torch.no_grad():
        qh, kh, vh, gh = split(q), split(k), split(v), split(dout)
        p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale + bias, dim=-1)
        dp = torch.matmul(gh, vh.transpose(-1, -2))
        pd = p
        if rate > 0.0:
            keep = dropout_keep_mask(seed, bsz, heads, t, rate, q.device)
            keep = keep * (1.0 / (1.0 - rate))
            pd, dp = p * keep, dp * keep
        dv = torch.matmul(pd.transpose(-1, -2), gh)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq = torch.matmul(ds, kh) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
        return merge(dq), merge(dk), merge(dv)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_STRIDES = [ctypes.c_longlong] * 2
_DROPOUT_ARGS = [ctypes.c_float, ctypes.c_int, ctypes.c_uint32, ctypes.c_float,
                 ctypes.c_uint32]  # scale, dropout, keep_threshold, inv_keep, seed


_fwd = None  # (kernel, its shared-memory function) of each source, bound at first use
_bwd = None


def _bind(name: str):
    """The entry point of `csrc/attention_fwd.cu` or `csrc/attention_bwd.cu`
    and its `_smem_bytes`, typed once."""
    lib = _build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    n_arrays = 3 if name == "attention_fwd" else 4  # strided inputs
    n_out = 1 if name == "attention_fwd" else 3
    kernel = _build.bind(getattr(lib, name), (
        [p] * (n_arrays + 1 + n_out)  # inputs, bias, outputs
        + [i, i, i, i]  # B T D H
        + _STRIDES * n_arrays  # batch and time strides of each input
        + _STRIDES  # bias batch and query strides
        + _DROPOUT_ARGS
        + [p]  # stream
    ))
    return kernel, _build.bind(getattr(lib, name + "_smem_bytes"), [i, i], ctypes.c_size_t)


def _forward_fns():
    global _fwd
    if _fwd is None:
        _fwd = _bind("attention_fwd")
    return _fwd


def _backward_fns():
    global _bwd
    if _bwd is None:
        _bwd = _bind("attention_bwd")
    return _bwd


def _check_kernel_inputs(named, dev, heads: int, d: int) -> None:
    for name, x in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"the attention kernel takes float32; {name} is {x.dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along its last dim")
    dh = d // heads
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the attention kernel takes head widths {KERNEL_HEAD_DIMS}; got "
            f"dh={dh} (D={d}, heads={heads})"
        )


def _check_smem(smem_bytes, name: str, t: int, dh: int) -> None:
    smem = smem_bytes(t, dh)
    if smem > SMEM_LIMIT:
        largest = max((n for n in range(1, t) if smem_bytes(n, dh) <= SMEM_LIMIT),
                      default=0)
        raise ValueError(
            f"{name}: T={t}, dh={dh} needs {smem} bytes of shared memory per "
            f"block; the limit is {SMEM_LIMIT} (largest T at this head width: "
            f"{largest})"
        )


def _bias_strides(bias):
    return (bias.stride(0) if bias.shape[0] > 1 else 0,
            bias.stride(2) if bias.shape[2] > 1 else 0)


def _dropout_args(dh: int, seed: int, rate: float):
    dropout = rate > 0.0
    return (1.0 / math.sqrt(dh), int(dropout),
            keep_threshold(rate) if dropout else 0, 1.0 / (1.0 - rate), seed & _M32)


def _launch_forward(q, k, v, bias, seed: int, heads: int, rate: float):
    bsz, t, d = q.shape
    dh = d // heads
    dev = q.device
    _check_kernel_inputs((("q", q), ("k", k), ("v", v), ("bias", bias)), dev, heads, d)
    kernel, smem_bytes = _fwd or _forward_fns()
    _check_smem(smem_bytes, "attention_fwd", t, dh)
    out = torch.empty((bsz, t, d), dtype=torch.float32, device=dev)
    err = kernel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        bsz, t, d, heads,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), *_bias_strides(bias),
        *_dropout_args(dh, seed, rate),
        _build.raw_stream(dev.index),
    )
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: cudaError {err}")
    fused_attention.launches += 1
    return out


def _launch_backward(q, k, v, bias, dout, seed: int, heads: int, rate: float):
    bsz, t, d = q.shape
    dh = d // heads
    dev = q.device
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    _check_kernel_inputs(
        (("q", q), ("k", k), ("v", v), ("bias", bias), ("dout", dout)), dev, heads, d)
    if dout.shape != q.shape:
        raise ValueError(f"dout must be {tuple(q.shape)}; got {tuple(dout.shape)}")
    kernel, smem_bytes = _bwd or _backward_fns()
    _check_smem(smem_bytes, "attention_bwd", t, dh)
    dq, dk, dv = (torch.empty((bsz, t, d), dtype=torch.float32, device=dev)
                  for _ in range(3))
    err = kernel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bsz, t, d, heads,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
        *_bias_strides(bias), *_dropout_args(dh, seed, rate),
        _build.raw_stream(dev.index),
    )
    if err != 0:
        raise RuntimeError(f"attention_bwd kernel launch failed: cudaError {err}")
    fused_attention.backward_launches += 1
    return dq, dk, dv


def attention_backward(q, k, v, bias, dout, seed: int, heads: int, rate: float):
    """(dq, dk, dv) for the output gradient `dout`: the backward kernel on
    CUDA tensors (or an error), `attention_bwd_plain` on CPU tensors."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, bias, dout, seed, heads, rate)
    if q.device.type != "cuda":
        raise ValueError(f"attention_backward runs on cuda or cpu, not {q.device}")
    _check_inputs(q, k, v, heads, rate)
    check_bias(bias, q.shape[0], q.shape[1])
    return _launch_backward(q, k, v, bias, dout, seed, heads, rate)


class _FusedAttention(torch.autograd.Function):
    """Forward kernel and backward kernel as one differentiable function.
    The residuals are the inputs (q, k, v, bias) and the seed: the backward
    recomputes the probabilities and regenerates the dropout mask."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, heads, rate):
        out = _launch_forward(q, k, v, bias, seed, heads, rate)
        ctx.save_for_backward(q, k, v, bias)
        ctx.attn_args = (seed, heads, rate)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = _launch_backward(q, k, v, bias, dout, *ctx.attn_args)
        return dq, dk, dv, None, None, None, None


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    seed: int,
    heads: int,
    rate: float,
) -> torch.Tensor:
    """q, k, v: [B, T, D] float32; bias: additive [1|B, 1, 1|T, T]; seed: int
    keying the dropout mask (read only when rate > 0); heads, rate: Python
    numbers. Returns [B, T, D], differentiable in q, k and v.

    CUDA tensors launch the kernels (or raise); CPU tensors take
    `attention_plain`."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, seed, heads, rate)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, not {q.device}")
    _check_inputs(q, k, v, heads, rate)
    check_bias(bias, q.shape[0], q.shape[1])
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        # a gradient will be asked for: fail now if the backward kernel cannot
        # take this shape, not in the middle of a backward pass
        _check_smem((_bwd or _backward_fns())[1], "attention_bwd",
                    q.shape[1], q.shape[2] // heads)
    return _FusedAttention.apply(q, k, v, bias, seed, heads, rate)


fused_attention.launches = 0  # forward kernel launches since the last reset
fused_attention.backward_launches = 0  # backward kernel launches
