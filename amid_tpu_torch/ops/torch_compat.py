"""Numerics of the reference (PyTorch) model, as the JAX package reproduces
them in `amid_tpu/ops/torch_compat.py`.

* torch nn.Linear init: weight and bias U(+-1/sqrt(fan_in)).
* torch nn.Embedding init: N(0, 1).
* nn.MultiheadAttention in_proj: xavier-uniform.
* Hand-rolled LayerNorm (model_seq.py:115-127): unbiased std, eps on the std.
* torch nn.LayerNorm (model_seq.py:342): biased variance, eps inside the rsqrt.
* tanh-approx GELU (model_seq.py:198-204).
* torch nn.GRU's gate order (r, z, n) and init, one layer (model_seq.py:72-73).

Every init takes an explicit `torch.Generator` on the parameter's device, so
a model built from a seed is the same on every run.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from amid_tpu_torch.ops.precision import matmul


def uniform_(w: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    nn.init.uniform_(w, -bound, bound, generator=gen)


def torch_linear_init_(layer: nn.Linear, gen: torch.Generator) -> None:
    """nn.Linear's default init: weight and bias U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(layer.in_features)
    uniform_(layer.weight, bound, gen)
    if layer.bias is not None:
        uniform_(layer.bias, bound, gen)


def torch_embedding_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    """nn.Embedding's default init: N(0, 1)."""
    nn.init.normal_(w, 0.0, 1.0, generator=gen)


def xavier_uniform_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    """nn.MultiheadAttention's in_proj init (xavier_uniform_)."""
    nn.init.xavier_uniform_(w, generator=gen)


class TorchLayerNorm(nn.LayerNorm):
    """torch nn.LayerNorm with the reference's eps 1e-8 (model_seq.py:342):
    biased variance, eps inside the rsqrt."""

    def __init__(self, d: int, eps: float = 1e-8):
        super().__init__(d, eps=eps)


class RefLayerNorm(nn.Module):
    """The reference's hand-rolled LayerNorm (model_seq.py:115-127):
    a * (x - mean) / (std + eps) + b with the unbiased std."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        std = x.std(-1, keepdim=True)  # unbiased, like the reference
        return self.weight * (x - mean) / (std + self.eps) + self.bias


def tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approx GELU (model_seq.py:198-204)."""
    return F.gelu(x, approximate="tanh")


class TorchGRU(nn.Module):
    """Single-layer GRU with torch's gate convention and init, zero initial
    state — the counterpart of `amid_tpu/ops/torch_compat.py::TorchGRU` (a
    `lax.scan` there, a loop over time here; no kernel on either side):

        r = sig(x W_ir + b_ir + h W_hr + b_hr)
        z = sig(x W_iz + b_iz + h W_hz + b_hz)
        n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
        h' = (1 - z) * n + z * h

    The weights keep the JAX package's layout, `w_ih` [D, 3H] and `w_hh`
    [H, 3H] with the gates side by side in (r, z, n) order (torch's nn.GRU
    stores the transpose), so the converter copies them as they are. The
    input projection of every step is one product before the loop; a step is
    one product and four fused elementwise kernels (a CUDA graph of a
    training step holds them all). The steps' inputs come from one `unbind`
    and the gates from `split`/`chunk`, whose backwards each write one
    tensor: indexing `x_proj[:, t]` would give every step's backward a
    zero-filled [B, T, 3H] gradient to add up, T^2 work. All four tensors
    start from U(+-1/sqrt(H)). `precision` is the model's mode
    (`ops.precision`): in `"bf16"` both products take bf16 operands and the
    biases are added after them, as `x @ w + b` in the JAX package."""

    def __init__(self, d: int, hidden: int, precision: str = "fp32"):
        super().__init__()
        self.hidden = hidden
        self.precision = precision
        self.w_ih = nn.Parameter(torch.empty(d, 3 * hidden))
        self.w_hh = nn.Parameter(torch.empty(hidden, 3 * hidden))
        self.b_ih = nn.Parameter(torch.empty(3 * hidden))
        self.b_hh = nn.Parameter(torch.empty(3 * hidden))

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden)
        for w in (self.w_ih, self.w_hh, self.b_ih, self.b_hh):
            uniform_(w, bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, D] -> [B, T, H]
        hd, mode = self.hidden, self.precision
        x_proj = matmul(x, self.w_ih, mode) + self.b_ih  # [B, T, 3H]
        h = x.new_zeros((x.shape[0], hd))
        out = []
        for xp in x_proj.unbind(1):
            if mode == "fp32":
                hp = torch.addmm(self.b_hh, h, self.w_hh)  # [B, 3H]
            else:
                hp = matmul(h, self.w_hh, mode) + self.b_hh
            x_rz, x_n = xp.split([2 * hd, hd], dim=1)
            h_rz, h_n = hp.split([2 * hd, hd], dim=1)
            r, z = torch.sigmoid(x_rz + h_rz).chunk(2, dim=1)
            n = torch.tanh(torch.addcmul(x_n, r, h_n))
            h = torch.lerp(n, h, z)  # (1 - z) * n + z * h
            out.append(h)
        return torch.stack(out, dim=1)
