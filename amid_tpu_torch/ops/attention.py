"""Fused multi-head attention — the counterpart of
`amid_tpu/ops/pallas_attention.py::fused_attention`.

Layout is the JAX package's: q, k, v are [B, T, D] with the h heads packed in
D; `bias` is additive, [1|B, 1, 1|T, T] (causal -1e9 for SASRec, key-padding
for BERT4Rec); the per-head scale is 1/sqrt(dh); dropout with `rate` drops
attention probabilities and scales the kept ones by 1/(1 - rate).

* `fused_attention` is the wrapper of the CUDA kernels
  `csrc/attention_fwd.cu`, `csrc/attention_fwd_long.cu`,
  `csrc/attention_bwd.cu` and `csrc/attention_bwd_long.cu`. On CUDA tensors
  the forward launches a forward path and a gradient launches a backward
  path (see below), or they raise; on CPU tensors it
  computes `attention_plain`. The `torch.autograd.Function` that joins the
  two is entered only when a gradient is wanted (grad mode on and q, k or v
  requiring one); then the forward also writes the row statistics the
  backward reads. `bias` and `seed` get no gradient.
* `attention_plain` is the same function in plain PyTorch (with autograd),
  the version the CPU tests hold against JAX and the kernel is held against
  on the card.
* `attention_fwd_stats_plain` is the forward with its row statistics
  (`row_max` m_i and `row_inv_sum` 1/l_i, each [B, h, T]), the plain version
  of the forward kernels under autograd; `attention_fwd_stats_streamed_plain`
  computes the same in the long forward's order (an online softmax over key
  tiles), holding [B, h, T, block_k] at a time.
* The forward has two CUDA paths (`forward_route`): the one-head kernel
  `csrc/attention_fwd.cu` (`mma.sync` in 3xTF32), one block a (b, h) with
  the head's whole K and V in shared memory (at dh=32 up to T=800,
  `forward_max_t`), counted in `fused_attention.launches`; and the
  long-sequence kernel `csrc/attention_fwd_long.cu`, which takes any T up
  to `long_forward_max_t()` at every kernel head width: a block owns 128
  queries of a (b, h) and streams K, V and the bias row through the same
  ring of staged, split tiles as the long backward's, the products on
  `wgmma` in 3xTF32, counted in `fused_attention.long_forward_launches`.
  `forward_route` sends a shape to the long kernel where the one-head kernel
  cannot hold it, or from `LONG_FWD_FASTER_FROM`'s T on, the crossovers
  `chip_smoke.py`'s `fwd_crossover` records measured. Both write the same
  row statistics, which either backward path reads.
* `attention_bwd_plain` repeats the backward kernel's one-sweep arithmetic in
  plain PyTorch: dq, dk, dv from q, k, v, bias, the forward's output and row
  statistics and the output's gradient, with P rebuilt from the statistics
  and the dropout mask regenerated. `attention_backward` is the kernel on
  CUDA tensors and this on CPU tensors.
* The backward has two CUDA paths (`backward_route`): the one-sweep kernel
  `csrc/attention_bwd.cu` (`mma.sync` in 3xTF32), which keeps a whole head
  in one block's shared memory (at dh=32 up to T=368), and the long-sequence
  path `csrc/attention_bwd_long.cu`, which takes any T up to
  `long_backward_max_t()` at every kernel head width: a dQ kernel, then a
  dK/dV kernel, each block owning 128 rows and streaming the other side
  through a two-stage ring of asynchronous copies, each stage split into
  TF32 halves once, the products on `wgmma` in 3xTF32. Its bound and what
  still holds it back are in its header. `backward_route` sends a shape to
  the long path where it was the faster on the H100 (`long_faster`, a table
  of the crossovers `chip_smoke.py`'s `bwd_crossover` records measured,
  `LONG_FASTER_FROM`) or where the one-sweep kernel cannot hold it
  (`sweep_fits`). The long path's copies read 16-byte chunks of q, k, v and
  dout rows: a view whose rows do not start on 16 bytes is copied first. A
  call of the long path counts in `fused_attention.long_backward_launches`
  (one per call: it launches its two kernels together), one of the
  one-sweep kernel in `backward_launches`.
* `dropout_keep_mask` is the counter-based dropout mask both versions use:
  a pure function of (seed, b, h, i, j), so kernel and plain agree bit for
  bit. The TPU's own random bits cannot be reproduced; against JAX only
  rate 0 compares. `row_offset` (every version and wrapper takes it, 0 by
  default) is the global row of the call's row 0: the mask keys row b as
  row_offset + b, so a data-parallel rank holding rows [b0, b0 + B) of a
  global batch (`parallel/`, gspmd) draws, with row_offset=b0, the rows a
  call on the whole batch at offset 0 draws for them.
* Head widths: the kernels take any dh = D / heads from 1 to MAX_HEAD_DIM
  (128), each at the smallest of KERNEL_HEAD_DIMS that holds it
  (`kernel_head_dim`; csrc/attention_common.cuh): columns from dh on are
  zero inside the kernel and never written, so a padded width computes the
  function of its own width, the scale 1/sqrt(dh) included. The long paths
  of both modes also take dh from 129 to MAX_LONG_HEAD_DIM (256) at
  template width 256 (`long_head_dim`), and both routes send such a head
  there at every T; the one-head kernels refuse it. The bf16 long paths'
  instances at that width are builds of their own (`<source>_dh256`,
  `-DAMID_BF16_WIDE=1`), bound beside the others. A wider head is refused
  (`head_width_refusal`, naming `--kernels torch`). The routes read
  a padded width's entries under its template width, and the long paths
  copy q, k, v (and dout) 16 bytes at a time only at widths that are a
  multiple of 4 (`_rows_aligned`), 4 bytes at a time at the others. A
  template width runs instances with dh a compile-time constant (the
  one-head kernels' exact instances; the fp32 long paths' libraries as
  they are), a padded width instances that read it at run time (the
  one-head kernels' PAD instances; the fp32 long paths' `_pad` builds,
  chosen with the others in `_entry_point`), so that the template widths
  keep their code.

The dropout `seed` is a Python int or a one-element int64 tensor on the
inputs' device (what a training step draws, `ops.rng.StepRandom.
attention_seed`); only its low 32 bits key the mask. The kernels read it from
device memory through a pointer, so a CUDA graph of a step replays each
launch with the seed that replay drew; an int seed is first written into a
device tensor (a fill, no copy from the host).

The backward's residuals differ from the JAX package's `_vjp_fwd` (q, k, v,
bias, seed): here they are (q, k, v, bias, out, row_max, row_inv_sum, seed),
so the backward does not recompute the softmax's normalisation. The result is
the same function's gradient (tests/test_torch_ops_train.py holds it against
`jax.vjp` of the Pallas kernel).

`mxu_bf16=True` is the JAX kernel's bf16-operand mode (the model's bf16
mode, `ops.precision`): every product's operands rounded to bf16, fp32
sums. The plain versions round where the JAX kernel rounds: Q.K^T, and
P.V with P normalised and the dropout applied; in the backward dO.V^T,
Pd^T.dO, dS.K and dS^T.Q. D_i stays rowsum(dO o O) in fp32, as in the fp32
mode (JAX sums dP o P instead, a difference of bf16 rounding). The row
statistics come from the bf16-operand scores. Every path has native bf16
kernels of its own, bound under the library names `<source>_bf16` and
exporting their fp32 counterparts' entry points: the one-head pair
(`csrc/attention_fwd_bf16.cu`, `csrc/attention_bwd_bf16.cu`) rounds q, k,
v (and dout) to bf16 once, as a block stages them into 16-bit tiles, and
its products are `mma.sync` k16 bf16 steps; the long paths
(`csrc/attention_fwd_long_bf16.cu`, `csrc/attention_bwd_long_bf16.cu`) run
a pre-pass that rounds them to bf16 once a call into a packed scratch from
the caching allocator (`pack_bf16_plain` is its plain version), and their
products are `wgmma` k16 steps on 16-bit tiles. The bf16 one-head kernels
hold longer heads than the fp32 ones (half the bytes a staged row), so
`forward_max_t` and `sweep_fits` read the limits of the mode's own kernel.
The one-head and long forwards run an online
softmax and so round the unnormalised exp(S - m) (dropout applied) where
JAX rounds the normalised P, once a key chunk (32 keys; the long forward's
stage, `LONG_BF16_STAGE_KEYS`): kernel and plain agree to bf16 rounding, not
to fp32's (`chip_smoke.py`'s BF16_LIMITS hold each kernel to an fp64 oracle
of its own rounding points instead). In bf16 mode `attention_plain`'s
gradient is `attention_bwd_plain`'s arithmetic, as the kernels' is. Each
bf16 launch counts in a count of its own (`bf16_launches`,
`long_forward_bf16_launches`, `backward_bf16_launches`,
`long_backward_bf16_launches`; a long call counts once, its pre-pass
inside it), and each mode routes by its own tables (`LONG_FWD_FASTER_FROM`,
`LONG_FASTER_FROM`, keyed by mode).
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from amid_tpu_torch.ops import _build
from amid_tpu_torch.ops._build import SMEM_LIMIT
from amid_tpu_torch.ops.precision import matmul

_BIAS_SHAPES = "[1|B, 1, 1|T, T]"
_M32 = 0xFFFFFFFF
_MIX_KEY0 = 0x9E3779B9
# The kernels' template head widths (csrc/attention_common.cuh): a head of
# any width dh from 1 to MAX_HEAD_DIM runs at the smallest of them that holds
# it, its columns from dh on zero in the kernel and never written
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]
# the long paths' widths, in both modes: also 256, for any dh from 129 to 256
LONG_HEAD_DIMS = KERNEL_HEAD_DIMS + (256,)
MAX_LONG_HEAD_DIM = LONG_HEAD_DIMS[-1]


def kernel_head_dim(dh: int):
    """The template width a head of width `dh` runs at in every kernel; None
    where not every kernel takes it (dh above MAX_HEAD_DIM: see
    `long_head_dim`)."""
    return next((w for w in KERNEL_HEAD_DIMS if dh <= w), None) if dh >= 1 else None


def long_head_dim(dh: int):
    """The template width a head of width `dh` runs at on the long paths
    (fp32 and bf16); None above MAX_LONG_HEAD_DIM."""
    return next((w for w in LONG_HEAD_DIMS if dh <= w), None) if dh >= 1 else None


def head_width_refusal(dh: int) -> str:
    """Why the kernels refuse heads of width `dh` (in either mode), naming
    the way out."""
    return (f"the attention kernels take head widths 1 to {MAX_LONG_HEAD_DIM} "
            f"(above {MAX_HEAD_DIM} on the long paths only), in fp32 and bf16; got "
            f"dh={dh} (--kernels torch, kernels='torch', computes any width)")


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


def _check_inputs(q, k, v, bias, heads: int, rate: float) -> None:
    """The checks of every route, kernel and plain alike."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one [B, T, D] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[2] % heads:
        raise ValueError(f"D={q.shape[2]} is not divisible by heads={heads}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1); got {rate}")
    check_bias(bias, q.shape[0], q.shape[1])


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
    seed, bsz: int, heads: int, t: int, rate: float, device=None, keys=None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Boolean keep mask [B, heads, T, T] of the kernel's dropout; `seed` an
    int or a one-element int64 tensor on `device`. With `keys`, a range of
    key indices, only those columns: [B, heads, T, len(keys)].

    bits(b, h, i, j) = mix(mix(mix(mix(K0, seed), (row_offset + b)*heads + h),
    i), j) and the element is kept iff bits >> 8 >= ceil(rate * 2^24)."""
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(()).to(torch.int64)
    keys = range(t) if keys is None else keys
    stream = _mix(_MIX_KEY0, seed & _M32)
    bh = torch.arange(bsz * heads, dtype=torch.int64, device=device) + row_offset * heads
    idx = torch.arange(t, dtype=torch.int64, device=device)
    jdx = torch.arange(keys.start, keys.stop, dtype=torch.int64, device=device)
    key_bh = _mix(stream, bh)  # [BH]
    key_i = _mix(key_bh[:, None], idx[None, :])  # [BH, T]
    bits = _mix(key_i[:, :, None], jdx[None, None, :])  # [BH, T, keys]
    return ((bits >> 8) >= keep_threshold(rate)).view(bsz, heads, t, len(jdx))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _heads(x, heads: int):
    """[B, T, D] -> [B, h, T, dh]."""
    bsz, t, d = x.shape
    return x.reshape(bsz, t, heads, d // heads).transpose(1, 2)


def _merge(x):
    """[B, h, T, dh] -> [B, T, D]."""
    bsz, heads, t, dh = x.shape
    return x.transpose(1, 2).reshape(bsz, t, heads * dh)


def _mm(a, b, bf16: bool):
    """a @ b; with `bf16` on bf16-rounded operands with fp32 sums."""
    return matmul(a, b, "bf16" if bf16 else "fp32")


def _scores(q, k, bias, heads: int, bf16: bool = False):
    """S = Q K^T / sqrt(dh) + bias per head, [B, h, T, T]."""
    scale = 1.0 / math.sqrt(q.shape[2] // heads)
    return _mm(_heads(q, heads), _heads(k, heads).transpose(-1, -2), bf16) * scale + bias


def _keep(seed, q, heads: int, rate: float, row_offset: int = 0):
    """keep / (1 - rate) as [B, h, T, T] floats."""
    bsz, t, _ = q.shape
    return dropout_keep_mask(seed, bsz, heads, t, rate, q.device,
                             row_offset=row_offset) * (1.0 / (1.0 - rate))


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    seed,
    heads: int,
    rate: float,
    mxu_bf16: bool = False,
    row_offset: int = 0,
) -> torch.Tensor:
    """softmax(Q K^T / sqrt(dh) + bias) [dropout] V per head, in plain
    PyTorch. Same arguments and result as `fused_attention`."""
    _check_inputs(q, k, v, bias, heads, rate)
    if mxu_bf16:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _PlainAttentionBf16.apply(q, k, v, bias, seed, heads, rate, row_offset)
        return attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate, True,
                                         row_offset)[0]
    p = torch.softmax(_scores(q, k, bias, heads), dim=-1)
    if rate > 0.0:
        p = p * _keep(seed, q, heads, rate, row_offset)
    return _merge(torch.matmul(p, _heads(v, heads)))


def attention_fwd_stats_plain(q, k, v, bias, seed, heads: int, rate: float,
                              mxu_bf16: bool = False, row_offset: int = 0):
    """(out, row_max, row_inv_sum): the forward kernel's results under
    autograd, in plain PyTorch. out equals `attention_plain`; row_max[b, h, i]
    is m_i = max_j S_ij and row_inv_sum[b, h, i] is 1 / sum_j exp(S_ij - m_i),
    so that P = exp(S - m) * row_inv_sum. The two stay apart: a log-sum-exp
    m + log l of a fully masked row (every S_ij = -1e9) rounds back to -1e9."""
    _check_inputs(q, k, v, bias, heads, rate)
    s = _scores(q, k, bias, heads, mxu_bf16)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    inv_l = 1.0 / e.sum(dim=-1, keepdim=True)
    p = e * inv_l
    if rate > 0.0:
        p = p * _keep(seed, q, heads, rate, row_offset)
    return _merge(_mm(p, _heads(v, heads), mxu_bf16)), m.squeeze(-1), inv_l.squeeze(-1)


def attention_fwd_stats_streamed_plain(q, k, v, bias, seed, heads: int, rate: float,
                                       block_k: int = 64, mxu_bf16: bool = False,
                                       row_offset: int = 0):
    """(out, row_max, row_inv_sum) of `attention_fwd_stats_plain`, computed
    in the long forward kernel's order (`csrc/attention_fwd_long.cu`): an
    online softmax over tiles of `block_k` keys (the kernel's stage: 64, 32
    at dh=64), the last tile partial. Per tile, S = Q K^T / sqrt(dh) + bias,
    m grows to the tile's row max, l and O are rescaled by exp(m_old - m),
    l += rowsum(exp(S - m)), O += dropout(exp(S - m)) V; then O / l. Holds
    [B, h, T, block_k] at a time, the dropout mask included, so it also runs
    where a [B, h, T, T] block would not fit.

    With `mxu_bf16` it rounds where the JAX kernel does, the normalised P:
    a first sweep over the tiles finds m and l, a second adds
    bf16(dropout(exp(S - m) / l)) . bf16(V) tile by tile."""
    _check_inputs(q, k, v, bias, heads, rate)
    bsz, t, d = q.shape
    scale = 1.0 / math.sqrt(d // heads)
    qh, kh, vh = (_heads(x, heads) for x in (q, k, v))
    m = q.new_full((bsz, heads, t, 1), -math.inf)
    l = q.new_zeros((bsz, heads, t, 1))
    o = torch.zeros_like(qh)
    tiles = [range(j0, min(j0 + block_k, t)) for j0 in range(0, t, block_k)]

    def scores(keys):
        return _mm(qh, kh[:, :, keys.start:keys.stop].transpose(-1, -2), mxu_bf16) * scale + \
            bias[..., keys.start:keys.stop]

    def dropped(e, keys):
        if rate > 0.0:
            e = e * dropout_keep_mask(seed, bsz, heads, t, rate, q.device, keys,
                                      row_offset) * (1.0 / (1.0 - rate))
        return e

    for keys in tiles:
        s = scores(keys)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        l = l * alpha + e.sum(dim=-1, keepdim=True)
        if not mxu_bf16:
            o = o * alpha + torch.matmul(dropped(e, keys), vh[:, :, keys.start:keys.stop])
        m = m_new
    inv_l = 1.0 / l
    if not mxu_bf16:
        return _merge(o * inv_l), m.squeeze(-1), inv_l.squeeze(-1)
    for keys in tiles:
        p = dropped(torch.exp(scores(keys) - m) * inv_l, keys)
        o = o + _mm(p, vh[:, :, keys.start:keys.stop], True)
    return _merge(o), m.squeeze(-1), inv_l.squeeze(-1)


def attention_bwd_plain(q, k, v, bias, out, row_max, row_inv_sum, dout,
                        seed, heads: int, rate: float, mxu_bf16: bool = False,
                        row_offset: int = 0):
    """(dq, dk, dv) of `attention_plain` for the output gradient `dout`
    [B, T, D], by the backward kernel's one-sweep arithmetic from the forward's
    `out` and row statistics (`attention_fwd_stats_plain`):

        P = exp(S - m) * row_inv_sum;  D_i = rowsum(dO * O)_i
        dV = Pd^T dO;  dP = (dO V^T) * keep / (1 - rate)
        dS = P * (dP - D);  dQ = dS K / sqrt(dh);  dK = dS^T Q / sqrt(dh)

    with Pd = P * keep / (1 - rate); with `mxu_bf16` the five products on
    bf16-rounded operands."""
    _check_inputs(q, k, v, bias, heads, rate)
    scale = 1.0 / math.sqrt(q.shape[2] // heads)
    bf = mxu_bf16
    with torch.no_grad():
        qh, kh, vh, gh = (_heads(x, heads) for x in (q, k, v, dout))
        p = torch.exp(_scores(q, k, bias, heads, bf) - row_max[..., None]) * \
            row_inv_sum[..., None]
        d_row = (gh * _heads(out, heads)).sum(dim=-1, keepdim=True)
        dp = _mm(gh, vh.transpose(-1, -2), bf)
        pd = p
        if rate > 0.0:
            keep = _keep(seed, q, heads, rate, row_offset)
            pd, dp = p * keep, dp * keep
        dv = _mm(pd.transpose(-1, -2), gh, bf)
        ds = p * (dp - d_row)
        dq = _mm(ds, kh, bf) * scale
        dk = _mm(ds.transpose(-1, -2), qh, bf) * scale
        return _merge(dq), _merge(dk), _merge(dv)


class _PlainAttentionBf16(torch.autograd.Function):
    """`attention_plain`'s bf16 mode under autograd: the forward and its row
    statistics by `attention_fwd_stats_plain`, the gradient by
    `attention_bwd_plain`, the arithmetic of the kernels' bf16 mode."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, heads, rate, row_offset):
        out, row_max, row_inv_sum = attention_fwd_stats_plain(q, k, v, bias, seed, heads,
                                                              rate, True, row_offset)
        ctx.save_for_backward(q, k, v, bias, out, row_max, row_inv_sum)
        ctx.attn_args = (seed, heads, rate)
        ctx.row_offset = row_offset
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        dq, dk, dv = attention_bwd_plain(*ctx.saved_tensors, dout, *ctx.attn_args,
                                         mxu_bf16=True, row_offset=ctx.row_offset)
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------

# Each entry point takes one block of 8-byte fields (csrc/attention_common.cuh,
# FwdArgs and BwdArgs), packed in one call: ctypes converts argument by argument.
_PACK_FWD = struct.Struct("<24q2d").pack
_PACK_BWD = struct.Struct("<32q2d").pack
# BwdLongArgs: BwdArgs, then the D_i scratch (fp32) or the packed operands' (bf16)
_PACK_BWD_LONG = struct.Struct("<32q2dq").pack
_PACK_PTR = struct.Struct("<q").pack  # the bf16 long forward's scratch, after FwdArgs
# the fp32 long forward's scratch and its bytes, after FwdArgs
_PACK_SCRATCH = struct.Struct("<2q").pack
_BAD_HEAD_WIDTH, _BAD_SHAPE, _TOO_LONG, _MISALIGNED = -1, -2, -3, -4  # the refusals
_SMALL_SCRATCH = -5  # the fp32 long forward's scratch below its bytes
_SOURCES = ["attention_fwd", "attention_fwd_long", "attention_bwd", "attention_bwd_long"]
_PADDED = ["attention_fwd_long", "attention_bwd_long"]  # fp32 builds of their own for padded dh
# the bf16 mode's sources (csrc/<name>_bf16.cu: each exports its fp32
# counterpart's entry points), the padded-width builds and the bf16 long
# paths' builds at template width 256 (ops/_build.py's VARIANTS): library ->
# its source, whose entry point it exports
_LIBRARIES = {**{n: n for n in _SOURCES}, **{f"{n}_bf16": n for n in _SOURCES},
              **{f"{n}_pad": n for n in _PADDED}, **{f"{n}_bf16_dh256": n for n in _PADDED}}

_entry: dict = {}  # library of _LIBRARIES -> its entry point, bound at the first launch
# the fp32 long forward's scratch bytes, of each build: True the padded-width one's
_fwd_long_scratch: dict = {}
# mode -> the one-head forward's and the one-sweep backward's shared-memory
# functions, (T, dh) -> bytes: each mode's kernels hold their own longest T
_fwd_smem: dict = {}
_bwd_smem: dict = {}
_long_max_t = _fwd_long_max_t = None  # the longest T of the long backward and forward
_fwd_max_t: dict = {}  # mode -> dh -> the longest T of the one-head forward kernel
_bwd_fits: dict = {}  # (T, dh, mode) -> whether the one-sweep backward kernel takes it


def _bind() -> None:
    global _long_max_t, _fwd_long_max_t
    i = ctypes.c_int
    _build.build(list(_LIBRARIES))  # one nvcc each, all at once
    fwd, fwd_long, bwd, bwd_long = (_build.load(n) for n in _SOURCES)
    for mode, (f, b) in (("fp32", (fwd, bwd)), ("bf16", (_build.load("attention_fwd_bf16"),
                                                         _build.load("attention_bwd_bf16")))):
        _fwd_smem[mode] = _build.bind(f.attention_fwd_smem_bytes, [i, i], ctypes.c_size_t)
        _bwd_smem[mode] = _build.bind(b.attention_bwd_smem_bytes, [i, i], ctypes.c_size_t)
        _fwd_max_t[mode] = {dh: _largest_t(_fwd_smem[mode], dh) for dh in KERNEL_HEAD_DIMS}
    _long_max_t = _build.bind(bwd_long.attention_bwd_long_max_t, [])()
    _fwd_long_max_t = _build.bind(fwd_long.attention_fwd_long_max_t, [])()
    for padded, lib in ((False, fwd_long), (True, _build.load("attention_fwd_long_pad"))):
        _fwd_long_scratch[padded] = _build.bind(lib.attention_fwd_long_scratch,
                                                [ctypes.c_char_p], ctypes.c_longlong)
    # last, and whole: a bound table means every other table is too
    _entry.update({lib: _build.bind(getattr(_build.load(lib), name), [ctypes.c_char_p])
                   for lib, name in _LIBRARIES.items()})


def _entry_point(name: str, bf16: bool, dh: int):
    """The bound entry point of source `name` (of _SOURCES) for mode `bf16`
    at head width `dh`: the long paths' own builds at a padded fp32 width
    and at a bf16 width above MAX_HEAD_DIM (binds the kernels)."""
    if not _entry:
        _bind()
    lib = f"{name}_bf16" if bf16 else name
    if name in _PADDED and (dh > MAX_HEAD_DIM if bf16 else long_head_dim(dh) != dh):
        lib = f"{name}_bf16_dh256" if bf16 else f"{name}_pad"
    return _entry[lib]


def _largest_t(smem_bytes, dh: int) -> int:
    """The longest T whose `smem_bytes(T, dh)`, which grows with T, fits in
    one block's shared memory (SMEM_LIMIT); 0 if none does."""
    lo, hi = 0, 1  # lo fits (T=0 trivially); hi is not known to
    while smem_bytes(hi, dh) <= SMEM_LIMIT:
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if smem_bytes(mid, dh) <= SMEM_LIMIT else (lo, mid)
    return lo


def _too_long(name: str, smem_bytes, t: int, dh: int) -> ValueError:
    largest = _largest_t(smem_bytes, dh)
    return ValueError(
        f"{name}: T={t}, dh={dh} needs {smem_bytes(t, dh)} bytes of shared memory per "
        f"block; the limit is {SMEM_LIMIT} (largest T at this head width: {largest})")


def _raise(err: int, name: str, smem_bytes, t: int, d: int, heads: int):
    if err == _BAD_HEAD_WIDTH:
        raise ValueError(f"{name}: {head_width_refusal(d // heads)} (D={d}, heads={heads})")
    if err == _TOO_LONG:
        raise _too_long(name, smem_bytes, t, d // heads)
    if err == _BAD_SHAPE:
        raise ValueError(f"{name}: B, T and heads must be at least 1")
    if err == _MISALIGNED:
        raise ValueError(f"{name}: q, k, v and dout rows must start on 16 bytes")
    if err == _SMALL_SCRATCH:
        raise RuntimeError(f"{name}: the scratch is smaller than the kernel's layout")
    raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def forward_max_t(dh: int, mode: str = "fp32") -> int:
    """The longest T the one-head forward kernel of `mode` takes at head
    width `dh` (0 at a width it does not take): one head's K and V at dh's
    template width in one block's shared memory (that kernel's
    `attention_fwd_smem_bytes`, a function that grows with T, against
    SMEM_LIMIT: fp32 tiles in the fp32 mode, bf16 ones in the bf16 mode),
    found once per mode and template width when the kernels are bound,
    since every forward launch routes by it."""
    if not _entry:
        _bind()
    return _fwd_max_t[mode].get(kernel_head_dim(dh), 0)


def long_backward_max_t() -> int:
    """The longest T the long-sequence backward takes (binds the kernels)."""
    if not _entry:
        _bind()
    return _long_max_t


def long_forward_max_t() -> int:
    """The longest T the long-sequence forward takes (binds the kernels)."""
    if not _entry:
        _bind()
    return _fwd_long_max_t


MODES = ("fp32", "bf16")  # the kernels' modes: fp32 (3xTF32), bf16 operands (`mxu_bf16`)

# For each mode and head width, the shortest T from which the long forward's
# device time was below the one-head kernel's on the card for both biases,
# among the T that `chip_smoke.py`'s forward crossover sweeps measure (150,
# 300, 368, 512, 600 and 800, at B=256, D=128, key padding and causal, rate
# 0; `fwd_crossover` and `fwd_crossover_bf16` records; NVIDIA H100 80GB
# HBM3, 700.00 W). A head width between template widths routes as its
# template width (`kernel_head_dim`): the kernels run it at that width. fp32
# (the long forward with its split pre-pass; two sweeps): dh=32, the
# one-head kernel faster at 150 (key padding 0.160 against 0.163 and 0.165
# ms, causal 0.176 against 0.211), the long forward from 300 (0.332 and 0.327
# against 0.510, key padding; causal 0.401 against 0.581); dh=16, the long
# forward from 300 in both biases (key padding 0.400 and 0.407 against
# 0.563, causal 0.417 and 0.415 against 0.642), the one-head kernel at 150
# (0.169 against 0.193). dh=128 (B=256, D=512, T=20, 40, 80, 150 and 200,
# `chip_smoke.py`'s `width_crossover_sweeps`; the fp32 one-head kernel
# holds T <= 216 there): the long forward the faster from 40 in both biases
# (0.160 against 0.183 ms, key padding), the one-head kernel at 20.
# bf16 (the native long forward, its query blocks of a head neighbours in
# the grid and at dh=128 two blocks an SM, against the native one-head
# kernel, `csrc/attention_fwd_bf16.cu`; its sweeps add T=40 and 1,200, and
# dh=128 T=300 and 400), taken from the shortest T at and after which the
# long forward was at least 10% faster for both biases in each of two
# sweeps, long over one-head device time: dh=32 from 600 (key padding 0.648
# and 0.652, causal 0.794 and 0.790; at 512 causal 1.036 and 1.038, at 368
# 0.834 and 0.829, at 300 key padding 0.747 where causal reads 0.924 and
# 0.917: the one-head kernel skips the causal chunks past a warp's rows, so
# BERT4Rec's key padding at encoder T=300 runs the one-head kernel where
# the long one would take 0.75 of its time); dh=16 from 600 (key padding
# 0.660 and 0.655, causal 0.691 and 0.689; causal at 512 0.938 and 0.934,
# at 368 1.039 and 1.036, so SASRec's causal T=150 to 512 stays on the
# one-head kernel); dh=128 from 40 (key padding 0.627 and 0.629, causal 0.701
# and 0.701; at 20 1.148 and 1.136, causal 1.239 and 1.222). Below it, and at
# the head widths not swept (8, 64), shapes stay on the one-head kernel as
# long as it holds them (`forward_max_t`). A head wider than 128 (dh 129 to
# 256, template width 256) has no one-head kernel: it takes the long forward
# of its mode at every T (`forward_route`).
LONG_FWD_FASTER_FROM = {"fp32": {16: 300, 32: 300, 128: 40},
                        "bf16": {16: 600, 32: 600, 128: 40}}


def forward_route(t: int, dh: int, mode: str = "fp32") -> str:
    """'long' (the long-sequence forward) where the one-head kernel of
    `mode` cannot hold the shape (`forward_max_t(dh, mode) < t`: a head
    wider than MAX_HEAD_DIM at every T) or from
    `LONG_FWD_FASTER_FROM[mode][dh]` on, else 'sweep' (the one-head kernel).
    Binds the kernels."""
    if kernel_head_dim(dh) is None:
        return "long"
    start = LONG_FWD_FASTER_FROM[mode].get(kernel_head_dim(dh))
    return "long" if (start is not None and t >= start) or forward_max_t(dh, mode) < t else "sweep"


# For each mode and head width, the shortest T from which the long path's
# device time was below the one-sweep kernel's on the card, among the T that
# `chip_smoke.py`'s crossover sweeps measure (150, 200, 256, 300, 368 and
# 512, at B=256, D=128, key padding, rate 0, where both paths take the shape;
# `bwd_crossover` and `bwd_crossover_bf16` records; NVIDIA H100 80GB HBM3,
# 700.00 W); a head width between template widths routes as its template
# width (`kernel_head_dim`). SASRec's causal bias at dh=16 (150 to 600:
# C2DSR's views) crosses at the same T in fp32. fp32 dh=128 (T=20, 48, 64
# and 80, where the one-sweep kernel holds the shape; `width_crossover_sweeps`,
# two sweeps): the long path from 48 in both biases, 0.455 against 0.582 ms
# (key padding; causal 0.481 against 0.595), the one-sweep kernel at 20
# (0.215 against 0.327). bf16 (the native long backward against the native
# one-sweep kernel, `csrc/attention_bwd_bf16.cu`; its sweeps add T=40, and at
# dh=128 T=96 and 128), taken where the long path was at least 10% faster
# for both biases in each of two sweeps, long over one-sweep device time:
# dh=8 from 200 (0.796 and 0.798; 1.363 and 1.366 at 150); dh=16 from 512,
# where SASRec's causal bias crosses (0.535 and 0.537; 0.998 and 0.995 at
# 300, 1.008 and 1.007 at 368; key padding alone from 200, 0.822); dh=32
# from 256 (0.843 and 0.849; at 200 0.954 and 0.969); dh=64 from 150 (0.868
# and 0.865; 1.817 and 1.834 at 40); dh=128 from 128, the one-sweep kernel's
# longest T (key padding 0.892 and 0.898, causal 0.781 and 0.778; at 96 key
# padding 0.957 and 0.960). Below it, and wherever the one-sweep kernel was
# the faster, shapes stay on that kernel. A head wider than 128 (dh 129 to
# 256) takes the long path of its mode at every T (`backward_route`).
LONG_FASTER_FROM = {"fp32": {8: 512, 16: 368, 32: 150, 64: 150, 128: 48},
                    "bf16": {8: 200, 16: 512, 32: 256, 64: 150, 128: 128}}


def long_faster(t: int, dh: int, mode: str = "fp32") -> bool:
    """Whether the long path was the faster backward at (T, dh) in `mode`
    where both paths take the shape: from `LONG_FASTER_FROM[mode][dh]` on. A
    plain rule of the shape; binds nothing."""
    start = LONG_FASTER_FROM[mode].get(kernel_head_dim(dh))
    return start is not None and t >= start


def sweep_fits(t: int, dh: int, mode: str = "fp32") -> bool:
    """Whether the shared memory of the one-sweep kernel of `mode` holds a
    head of length `t` at head width `dh`. Asks the kernel once per shape
    and mode (binds them)."""
    fits = _bwd_fits.get((t, dh, mode))
    if fits is None:
        if not _entry:
            _bind()
        fits = _bwd_fits[(t, dh, mode)] = _bwd_smem[mode](t, dh) <= SMEM_LIMIT
    return fits


def backward_route(t: int, dh: int, mode: str = "fp32") -> str:
    """'long' (the long-sequence path) where `long_faster(t, dh, mode)` or
    where the one-sweep kernel of `mode` cannot hold the shape
    (`sweep_fits`; a head wider than MAX_HEAD_DIM at every T), else
    'sweep'."""
    if kernel_head_dim(dh) is None:
        return "long"
    return "long" if long_faster(t, dh, mode) or not sweep_fits(t, dh, mode) else "sweep"


def long_backward_max_t_at(dh: int) -> int:
    """The longest T the long backward takes at head width `dh`, in either
    mode: its blocks own 128 rows up to dh=128 and 64 above (the fp32 pair's
    blocks, the bf16 dK/dV kernel's; the grid's 65,535 of them)."""
    limit = long_backward_max_t()
    return limit if dh <= MAX_HEAD_DIM else limit // 2


def check_head_width(dh: int) -> None:
    """Raises naming `--kernels torch` if no kernel takes heads of width
    `dh`: above MAX_LONG_HEAD_DIM, in either mode."""
    if long_head_dim(dh) is None:
        raise ValueError(head_width_refusal(dh))


def _check_backward_fits(t: int, dh: int) -> None:
    """Raises now if no backward path takes (T, dh), not in the middle of a
    backward pass: a head width no kernel takes, or a T beyond the long
    path's."""
    check_head_width(dh)
    if t > long_backward_max_t_at(dh):
        raise ValueError(f"attention backward: T={t} is beyond the long-sequence path's "
                         f"limit of T={long_backward_max_t_at(dh)} at dh={dh}")


def _strides(named, bias, dev, also=()) -> list:
    """The batch and time strides of each named [B, T, D] input, then the
    bias's batch and query strides (0 where it broadcasts), once the checks
    every kernel input needs pass; the tensors of `also` are checked only."""
    for name, x in (*named, ("bias", bias), *also):
        if x.dtype is not torch.float32 or x.stride(-1) != 1 or x.device != dev:
            if x.device != dev:
                raise ValueError(f"{name} is on {x.device}, q on {dev}")
            if x.dtype is not torch.float32:
                raise TypeError(f"the attention kernel takes float32; {name} is {x.dtype}")
            raise ValueError(f"{name} must have unit stride along its last dim")
    bias_st = bias.stride()
    return [s for _, x in named for s in x.stride()[:2]] + [
        bias_st[0] if bias.shape[0] > 1 else 0, bias_st[2] if bias.shape[2] > 1 else 0]


def _seed_tensor(seed, dev) -> torch.Tensor:
    """The seed as the one-element int64 device tensor the kernels read."""
    if not isinstance(seed, torch.Tensor):
        return torch.full((1,), seed & _M32, dtype=torch.int64, device=dev)
    if seed.device != dev or seed.dtype is not torch.int64 or seed.numel() != 1:
        raise ValueError(f"the dropout seed must be an int or one int64 on {dev}; got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
    return seed


def _dropout_fields(seed, rate: float, dev, row_offset: int):
    """dropout, keep_threshold, the seed's address (0 without dropout), stream,
    row_offset; and the seed tensor, which the caller keeps alive until the
    launch."""
    dropout = rate > 0.0
    seed_t = _seed_tensor(seed, dev) if dropout else None
    return (dropout, keep_threshold(rate) if dropout else 0,
            seed_t.data_ptr() if dropout else 0, _build.raw_stream(dev.index),
            row_offset), seed_t


def _pack_forward(q, k, v, bias, seed, heads: int, rate: float, stats: bool,
                  row_offset: int = 0):
    """The FwdArgs block of one forward launch on checked CUDA tensors, the
    tensors it writes (out, row_max, row_inv_sum; the statistics only with
    `stats`) and the seed tensor, which the caller keeps alive until the
    launch."""
    bsz, t, d = q.shape
    dev = q.device
    strides = _strides((("q", q), ("k", k), ("v", v)), bias, dev)
    out = q.new_empty((bsz, t, d))
    row_max = row_inv_sum = None
    if stats:
        row_max, row_inv_sum = q.new_empty((bsz, heads, t)), q.new_empty((bsz, heads, t))
    fields, seed_t = _dropout_fields(seed, rate, dev, row_offset)
    block = _PACK_FWD(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        row_max.data_ptr() if stats else 0, row_inv_sum.data_ptr() if stats else 0,
        bsz, t, d, heads, *strides, *fields,
        1.0 / math.sqrt(d // heads), 1.0 / (1.0 - rate))
    return block, (out, row_max, row_inv_sum), seed_t


def _launch_forward(q, k, v, bias, seed, heads: int, rate: float, stats: bool, path=None,
                    bf16: bool = False, row_offset: int = 0):
    """(out, row_max, row_inv_sum) from one forward launch of the path `path`
    ('sweep', the one-head kernel, or 'long'; None: `forward_route`'s) on
    checked CUDA tensors; the statistics are written (and returned) only with
    `stats`; `bf16`: the bf16-operand kernels; `row_offset`: the dropout mask's
    global row of row 0."""
    if not _entry:
        _bind()
    bsz, t, d = q.shape
    check_head_width(d // heads)
    if path is None:
        path = forward_route(t, d // heads, "bf16" if bf16 else "fp32")
    if path == "long":
        return _launch_forward_long(q, k, v, bias, seed, heads, rate, stats, bf16,
                                    row_offset)
    if path != "sweep":
        raise ValueError(f"the forward path is 'sweep' or 'long'; got {path!r}")
    block, outs, _seed_alive = _pack_forward(q, k, v, bias, seed, heads, rate, stats,
                                             row_offset)
    err = _entry_point("attention_fwd", bf16, d // heads)(block)
    if err:
        _raise(err, "attention_fwd", _fwd_smem["bf16" if bf16 else "fp32"], t, d, heads)
    if bf16:
        fused_attention.bf16_launches += 1
    else:
        fused_attention.launches += 1
    return outs


def _launch_forward_long(q, k, v, bias, seed, heads: int, rate: float, stats: bool,
                         bf16: bool = False, row_offset: int = 0):
    """`_launch_forward` on the long-sequence path: its copies read 16-byte
    chunks of q, k and v rows, so a view whose rows do not start on 16 bytes
    is copied first (at a head width that is a multiple of 4; others are
    read 4 bytes at a time). Both modes pack operands into a scratch from the
    caching allocator first (so a CUDA graph's capture keeps it): the fp32
    kernel K and V split into TF32 halves and the bias, as many bytes as its
    `attention_fwd_long_scratch` asks; the bf16 kernel what
    `bf16_forward_packing` names at the head's template width (k and v
    alone from 128 on, where its blocks round their Q rows themselves)."""
    if not _entry:
        _bind()
    bsz, t, d = q.shape
    q, k, v = (x if _rows_aligned(x, d // heads) else x.contiguous() for x in (q, k, v))
    block, outs, _seed_alive = _pack_forward(q, k, v, bias, seed, heads, rate, stats,
                                             row_offset)
    if bf16:  # the native bf16 path: the packed operands' scratch after the block
        scratch = _long_bf16_forward_scratch(q, bias, heads)
        err = _entry_point("attention_fwd_long", True, d // heads)(
            block + _PACK_PTR(scratch.data_ptr()))
    else:  # a padded width: its own build
        padded = long_head_dim(d // heads) != d // heads
        nbytes = _fwd_long_scratch[padded](block)
        if nbytes < 0:
            err = nbytes
        else:
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
            err = _entry_point("attention_fwd_long", False, d // heads)(
                block + _PACK_SCRATCH(scratch.data_ptr(), nbytes))
    if err == _TOO_LONG:
        raise ValueError(f"attention_fwd_long: T={t} is beyond its limit of "
                         f"T={_fwd_long_max_t} (or B*heads*ceil(T / 128) beyond 2^31 - 1)")
    if err:
        _raise(err, "attention_fwd_long", _fwd_smem["bf16" if bf16 else "fp32"], t, d, heads)
    if bf16:
        fused_attention.long_forward_bf16_launches += 1
    else:
        fused_attention.long_forward_launches += 1
    return outs


def _launch_backward(q, k, v, bias, out, row_max, row_inv_sum, dout,
                     seed, heads: int, rate: float, path=None, bf16: bool = False,
                     row_offset: int = 0):
    """(dq, dk, dv) from one launch of the backward path `path` ('sweep' or
    'long'; None: `backward_route`'s) on checked CUDA tensors; `bf16`: the
    bf16-operand kernels; `row_offset` as in `_launch_forward`."""
    if not _entry:
        _bind()
    bsz, t, d = q.shape
    check_head_width(d // heads)
    dev = q.device
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"out and dout must be {tuple(q.shape)}; got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}")
    if row_max.shape != (bsz, heads, t) or row_inv_sum.shape != (bsz, heads, t):
        raise ValueError(f"row_max and row_inv_sum must be {(bsz, heads, t)}; got "
                         f"{tuple(row_max.shape)}, {tuple(row_inv_sum.shape)}")
    row_max, row_inv_sum = row_max.contiguous(), row_inv_sum.contiguous()
    if path is None:
        path = backward_route(t, d // heads, "bf16" if bf16 else "fp32")
    if path == "long":  # its copies read 16-byte chunks of q, k, v and dout rows
        dh = d // heads
        q, k, v, dout = (x if _rows_aligned(x, dh) else x.contiguous()
                         for x in (q, k, v, dout))
        if bf16 and not _rows_aligned(out, dh):  # and its pre-pass of out's
            out = out.contiguous()
    strides = _strides((("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)), bias,
                       dev, (("row_max", row_max), ("row_inv_sum", row_inv_sum)))
    dq, dk, dv = (q.new_empty((bsz, t, d)) for _ in range(3))
    fields, _seed_alive = _dropout_fields(seed, rate, dev, row_offset)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            dout.data_ptr(), row_max.data_ptr(), row_inv_sum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bsz, t, d, heads, *strides, *fields,
            1.0 / math.sqrt(d // heads), 1.0 / (1.0 - rate))
    if path == "long":
        if bf16:  # the native bf16 path: packed q, k, v, dout, the rows' float4s
            scratch = _long_bf16_scratch(q, bias, heads, 4, 16)
        else:  # D_i, from the dQ kernel to the dK/dV kernel
            scratch = q.new_empty((bsz, heads, t))
        err = _entry_point("attention_bwd_long", bf16, d // heads)(
            _PACK_BWD_LONG(*args, scratch.data_ptr()))
        if err == _TOO_LONG:
            raise ValueError(f"attention_bwd_long: T={t} is beyond its limit of "
                             f"T={long_backward_max_t_at(d // heads)} at dh={d // heads} "
                             f"(or B*heads beyond 2^31 - 1)")
        if err:
            _raise(err, "attention_bwd_long", _bwd_smem["bf16" if bf16 else "fp32"], t, d, heads)
        if bf16:
            fused_attention.long_backward_bf16_launches += 1
        else:
            fused_attention.long_backward_launches += 1
        return dq, dk, dv
    if path != "sweep":
        raise ValueError(f"the backward path is 'sweep' or 'long'; got {path!r}")
    err = _entry_point("attention_bwd", bf16, d // heads)(_PACK_BWD(*args))
    if err:
        _raise(err, "attention_bwd", _bwd_smem["bf16" if bf16 else "fp32"], t, d, heads)
    if bf16:
        fused_attention.backward_bf16_launches += 1
    else:
        fused_attention.backward_launches += 1
    return dq, dk, dv


def _rows_aligned(x: torch.Tensor, dh: int) -> bool:
    """Whether every [dh] row of a [B, T, D] tensor starts on 16 bytes, as
    the long paths' 16-byte copies need at a head width that is a multiple
    of 4; at any other width they copy 4 bytes at a time (True)."""
    return dh % 4 != 0 or (x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0
                           and x.stride(1) % 4 == 0)


# ---------------------------------------------------------------------------
# the native bf16 long paths' packed operands (csrc/attention_long_bf16.cuh)
# ---------------------------------------------------------------------------

# keys a stage of the bf16 long forward (kStageKeys of
# csrc/attention_fwd_long_bf16.cu): its online softmax rounds the
# unnormalised exp(S - m) once a stage, so this is part of its function
LONG_BF16_STAGE_KEYS = 64
LONG_BF16_PAD_ROWS = 128  # kPadRows: a packed head's T_pad is T rounded up to it


def bf16_packed_shape(t: int, dh: int) -> tuple[int, int]:
    """(T_pad, dh_pad) of a packed head: T rounded up to LONG_BF16_PAD_ROWS,
    dh's template width on the long paths (`long_head_dim`: 256 for dh 129
    to 256), at least 16 (a k16 step reads 16 columns): a whole number of
    k16 steps at every width."""
    return -(-t // LONG_BF16_PAD_ROWS) * LONG_BF16_PAD_ROWS, max(long_head_dim(dh), 16)


def pack_bf16_plain(x: torch.Tensor, heads: int) -> torch.Tensor:
    """The bf16 long paths' pack pre-pass in plain PyTorch: [B, T, D] fp32
    rounded to bf16 (nearest even) into [B, h, T_pad / 8, dh_pad / 8, 8, 8]:
    each head padded with zero rows to T_pad and zero columns to dh_pad, cut
    into core matrices of 8 rows x 8 columns, core matrix (r / 8, c / 8)
    after the ones before it in row-block-major order. Its memory order is
    the kernel's packed head."""
    bsz, t, d = x.shape
    dh = d // heads
    tp, dhp = bf16_packed_shape(t, dh)
    padded = x.new_zeros((bsz, heads, tp, dhp))
    padded[:, :, :t, :dh] = _heads(x, heads)
    blocks = padded.to(torch.bfloat16).view(bsz, heads, tp // 8, 8, dhp // 8, 8)
    return blocks.permute(0, 1, 2, 4, 3, 5).contiguous()


def unpack_bf16_plain(packed: torch.Tensor, t: int, dh: int) -> torch.Tensor:
    """The inverse of `pack_bf16_plain`: a packed [B, h, T_pad / 8, dh_pad / 8,
    8, 8] tensor of heads of width `dh` as [B, T, h * dh] fp32, the padding
    dropped."""
    bsz, heads, rb, cb, _, _ = packed.shape
    rows = packed.permute(0, 1, 2, 4, 3, 5).reshape(bsz, heads, rb * 8, cb * 8)
    return _merge(rows[:, :, :t, :dh].float())


def _long_bf16_scratch(q, bias, heads: int, operands: int, row_bytes: int,
                       pad_rows: int = LONG_BF16_PAD_ROWS) -> torch.Tensor:
    """The scratch of one native bf16 long launch, from the caching allocator
    (so a CUDA graph's capture keeps it): `operands` packed bf16 inputs of
    [B, h, T_pad, dh_pad] (T_pad: T rounded up to `pad_rows`), `row_bytes`
    more a packed row (the backward's float4 of m, 1/l, D and the dropout
    key), and a bias that broadcasts over queries padded to T_pad (fp32), as
    the entry point carves it."""
    bsz, t, d = q.shape
    tp, dhp = -(-t // pad_rows) * pad_rows, bf16_packed_shape(t, d // heads)[1]
    nbytes = bsz * heads * tp * (operands * dhp * 2 + row_bytes)
    if (bias.stride(2) if bias.shape[2] > 1 else 0) == 0:
        nbytes += (bsz if bias.shape[0] > 1 else 1) * tp * 4
    return torch.empty(nbytes, dtype=torch.uint8, device=q.device)


def bf16_forward_packing(dh: int) -> tuple[int, int]:
    """(operands, pad_rows): what the bf16 long forward's pre-pass packs at
    head width `dh` (`packed_operands` and `packed_rows` of
    csrc/attention_fwd_long_bf16.cu): q, k and v to 128-row blocks up to
    template width 64 (a block's Q rows land by one bulk copy), k and v to
    whole stages from 128 on (the blocks round their Q rows themselves)."""
    if long_head_dim(dh) >= 128:
        return 2, LONG_BF16_STAGE_KEYS
    return 3, LONG_BF16_PAD_ROWS


def _long_bf16_forward_scratch(q, bias, heads: int) -> torch.Tensor:
    """The scratch of one bf16 long forward: `_long_bf16_scratch` of the
    operands `bf16_forward_packing` names."""
    operands, pad_rows = bf16_forward_packing(q.shape[2] // heads)
    return _long_bf16_scratch(q, bias, heads, operands, 0, pad_rows)


def _device_route(q, name: str) -> bool:
    """True for CUDA tensors (the kernels), False for CPU tensors (plain)."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")


def attention_backward(q, k, v, bias, out, row_max, row_inv_sum, dout,
                       seed, heads: int, rate: float, path=None, mxu_bf16: bool = False,
                       row_offset: int = 0):
    """(dq, dk, dv) for the output gradient `dout`, from the forward's `out`
    and row statistics: a backward kernel on CUDA tensors (or an error),
    `attention_bwd_plain` on CPU tensors. `path` ('sweep' or 'long') asks
    for one CUDA path; None takes `backward_route`'s."""
    if not _device_route(q, "attention_backward"):
        return attention_bwd_plain(q, k, v, bias, out, row_max, row_inv_sum, dout,
                                   seed, heads, rate, mxu_bf16, row_offset)
    _check_inputs(q, k, v, bias, heads, rate)
    return _launch_backward(q, k, v, bias, out, row_max, row_inv_sum, dout, seed, heads,
                            rate, path, mxu_bf16, row_offset)


class _FusedAttention(torch.autograd.Function):
    """Forward kernel (with row statistics) and backward kernel as one
    differentiable function. The residuals are q, k, v, bias, the output, the
    row statistics and the seed (the device tensor both launches read)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, heads, rate, bf16, row_offset):
        seed = _seed_tensor(seed, q.device) if rate > 0.0 else 0
        out, row_max, row_inv_sum = _launch_forward(q, k, v, bias, seed, heads, rate, True,
                                                    bf16=bf16, row_offset=row_offset)
        ctx.save_for_backward(q, k, v, bias, out, row_max, row_inv_sum)
        ctx.attn_args = (seed, heads, rate)
        ctx.bf16, ctx.row_offset = bf16, row_offset
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        dq, dk, dv = _launch_backward(*ctx.saved_tensors, dout, *ctx.attn_args,
                                      bf16=ctx.bf16, row_offset=ctx.row_offset)
        return dq, dk, dv, None, None, None, None, None, None


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    seed,
    heads: int,
    rate: float,
    mxu_bf16: bool = False,
    row_offset: int = 0,
) -> torch.Tensor:
    """q, k, v: [B, T, D] float32; bias: additive [1|B, 1, 1|T, T]; seed: an
    int or a one-element int64 tensor on q's device, keying the dropout mask
    (read only when rate > 0); heads, rate: Python numbers; mxu_bf16: the
    bf16-operand mode; row_offset: the global row of row 0 in the mask's key.
    Returns [B, T, D], differentiable in q, k and v.

    CUDA tensors launch the kernels (or raise); CPU tensors take
    `attention_plain`."""
    if not _device_route(q, "fused_attention"):
        return attention_plain(q, k, v, bias, seed, heads, rate, mxu_bf16, row_offset)
    _check_inputs(q, k, v, bias, heads, rate)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        _check_backward_fits(q.shape[1], q.shape[2] // heads)
        return _FusedAttention.apply(q, k, v, bias, seed, heads, rate, mxu_bf16, row_offset)
    return _launch_forward(q, k, v, bias, seed, heads, rate, False, bf16=mxu_bf16,
                           row_offset=row_offset)[0]


fused_attention.launches = 0  # one-head forward kernel launches since the last reset
fused_attention.long_forward_launches = 0  # long-sequence forward kernel launches
fused_attention.backward_launches = 0  # one-sweep backward kernel launches
fused_attention.long_backward_launches = 0  # long-sequence backward calls (two kernels each)
fused_attention.bf16_launches = 0  # the same four of the bf16-operand kernels
fused_attention.long_forward_bf16_launches = 0
fused_attention.backward_bf16_launches = 0
fused_attention.long_backward_bf16_launches = 0
