"""The model's matmul precision — the counterpart of the JAX model's
`jax.default_matmul_precision` context (`amid_tpu/models/amid.py`:
`cfg.matmul_precision or ("bfloat16" if cfg.use_bf16 else "")` around the
whole forward).

`resolve_precision(cfg)` gives the mode, `"fp32"` or `"bf16"`. `AMIDModel`
hands it to each of its modules as an attribute, so that an fp32 model and a
bf16 model live side by side in one process and a captured CUDA graph keeps
the mode it was captured with; nothing here sets process-wide state.

The three products `linear`, `matmul` and `einsum` take the mode:

* `"fp32"`: exactly `F.linear`, `torch.matmul`, `torch.einsum`, so an fp32
  model computes bit for bit what it did before the mode existed.
* `"bf16"`: what a JAX dot computes under the `bfloat16` context on the chips
  the JAX package ran on: both operands rounded to bf16 (round to nearest
  even, as `astype(bfloat16)` and `.bfloat16()` round), the products summed
  in fp32, an fp32 result. The backward is bf16 as well, as JAX's
  transposed dots carry the forward's precision: each gradient product
  rounds its operands, the incoming cotangent included. `linear`'s bias is
  added in fp32 after the product, as `x @ w + b` adds it in JAX.

The forms. On the CPU: round both operands to bf16, upcast, and multiply in
fp32, which is exact (the product of two bf16 numbers fits in fp32). On the
card, `linear` and `matmul` run a GEMM with bf16 operands and an fp32 output
(`torch.mm` / `torch.bmm` with `out_dtype=torch.float32`); `einsum`, which
the model uses only for the comps' small message sums, multiplies the
rounded operands in fp32 on both devices (TF32 off: the same numbers). The
device chooses the form; there is no fallback between them. Not
`torch.autocast`: it rounds the result to bf16 too, which is another
function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_JAX_NAMES = {"": "fp32", "highest": "fp32", "float32": "fp32", "bfloat16": "bf16"}


def resolve_precision(cfg) -> str:
    """The mode of a `ModelConfig`: JAX's expression `cfg.matmul_precision or
    ("bfloat16" if cfg.use_bf16 else "")`, then `""`, `"highest"` and
    `"float32"` give `"fp32"` and `"bfloat16"` gives `"bf16"`. Raises
    `ValueError` on any other string."""
    name = cfg.matmul_precision or ("bfloat16" if cfg.use_bf16 else "")
    mode = _JAX_NAMES.get(name)
    if mode is None:
        raise ValueError(f"matmul_precision={name!r} is not one of {tuple(_JAX_NAMES)}")
    return mode


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even) and back to its fp32 value."""
    return x.to(torch.bfloat16).to(x.dtype)


def _product(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """a16 @ b16 of bf16 operands ([M, K] @ [K, N], or a batch of them as
    [G, M, K] @ [G, K, N]) with fp32 sums and an fp32 result."""
    if a16.is_cuda:
        return (torch.mm if a16.dim() == 2 else torch.bmm)(a16, b16, out_dtype=torch.float32)
    return torch.matmul(a16.float(), b16.float())


class _Bf16Product(torch.autograd.Function):
    """a @ b on bf16-rounded operands, fp32 out; the backward's two products
    round the cotangent and the saved (rounded) operands."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        return _product(a16, b16)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        da = _product(g16, b16.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        db = _product(a16.transpose(-1, -2), g16) if ctx.needs_input_grad[1] else None
        return da, db


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.matmul's shapes for a [..., M, K] and b [K, N] or [..., K, N]
    with a's batch shape."""
    k, n = b.shape[-2:]
    if b.dim() == 2:
        return _Bf16Product.apply(a.reshape(-1, k), b).reshape(*a.shape[:-1], n)
    if b.shape[:-2] != a.shape[:-2]:
        raise ValueError(f"bf16 matmul: batch shapes {tuple(a.shape[:-2])} and "
                         f"{tuple(b.shape[:-2])} differ")
    out = _Bf16Product.apply(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, k, n))
    return out.reshape(*a.shape[:-1], n)


class _RoundOperand(torch.autograd.Function):
    """Forward: bf16 rounding; backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x):
        return bf16_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundCotangent(torch.autograd.Function):
    """Forward: the identity; backward: the incoming gradient rounded to bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return bf16_round(g)


def linear(x: torch.Tensor, w: torch.Tensor, b, mode: str) -> torch.Tensor:
    """F.linear(x, w, b) in `mode` (w [N, K], b [N] or None)."""
    if mode == "fp32":
        return F.linear(x, w, b)
    y = _bf16_matmul(x, w.T)
    return y if b is None else y + b


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """torch.matmul(a, b) in `mode`; in bf16 b is [K, N] or batched as a is."""
    if mode == "fp32":
        return torch.matmul(a, b)
    return _bf16_matmul(a, b)


def einsum(spec: str, *operands: torch.Tensor, mode: str) -> torch.Tensor:
    """torch.einsum(spec, *operands) in `mode`. In bf16 each operand is
    rounded and the product's gradient is rounded before it reaches the
    operands' gradient products, all of them exact fp32 products."""
    if mode == "fp32":
        return torch.einsum(spec, *operands)
    return _RoundCotangent.apply(torch.einsum(spec, *(_RoundOperand.apply(x) for x in operands)))
