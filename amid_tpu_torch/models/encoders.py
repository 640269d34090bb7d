"""SASRec encoder — the counterpart of the SASRec part of
`amid_tpu/models/encoders.py` (Log2feats, model_seq.py:331-387).

Reference quirks kept deliberately, as the JAX package keeps them:
* pre-LN on the attention query only; K and V take the un-normalised input,
  and the residual adds onto the normalised Q (model_seq.py:373-378);
* the causal mask is an additive -1e9 above the diagonal, not -inf (:369);
* a learned position embedding, sliced to the input length;
* the out_proj bias is trainable and zero at init (nn.MultiheadAttention).

With `kernels="cuda"` the attention core goes through the CUDA kernels
(`ops.attention.fused_attention`, forward and backward) at every sequence
length; with `kernels="torch"` through its plain PyTorch version. BERT4Rec
and GRU4Rec are not ported yet.

Train-mode dropout (on the embedded input, on the attention probabilities
and twice in the FFN) draws from the step's `ops.rng.StepRandom`, passed as
`rng`; in eval mode `rng` is not read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from amid_tpu_torch.ops.attention import attention_plain, fused_attention
from amid_tpu_torch.ops.rng import apply_dropout
from amid_tpu_torch.ops.torch_compat import (
    TorchLayerNorm,
    torch_embedding_init_,
    torch_linear_init_,
    uniform_,
    xavier_uniform_init_,
)

NEG_INF = -1e9  # reference mask fill value (model_seq.py:155)


class TorchMultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters and math (model_seq.py:348-351):
    a fused in_proj [3D, D] with xavier-uniform init and zero bias, an
    out_proj Linear with a zero-init bias, dropout on the probabilities."""

    def __init__(self, d: int, num_heads: int, dropout: float, kernels: str):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.attend = fused_attention if kernels == "cuda" else attention_plain
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)

    def reset_parameters(self, gen: torch.Generator) -> None:
        d = self.out_proj.in_features
        xavier_uniform_init_(self.in_proj_weight, gen)
        nn.init.zeros_(self.in_proj_bias)
        uniform_(self.out_proj.weight, 1.0 / math.sqrt(d), gen)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q, k, v, attn_bias, rng=None):
        d = q.shape[-1]
        w, b = self.in_proj_weight, self.in_proj_bias
        qp = F.linear(q, w[:d], b[:d])
        kp = F.linear(k, w[d : 2 * d], b[d : 2 * d])
        vp = F.linear(v, w[2 * d :], b[2 * d :])
        if self.training and self.dropout > 0.0:
            if rng is None:
                raise ValueError("train-mode attention dropout needs the step's "
                                 "StepRandom (pass rng=...)")
            seed, rate = rng.attention_seed(), self.dropout
        else:
            seed, rate = 0, 0.0
        out = self.attend(qp, kp, vp, attn_bias, seed, self.num_heads, rate)
        return self.out_proj(out)


class PointWiseFeedForward(nn.Module):
    """SASRec FFN (model_seq.py:311-326): two k=1 convs (dense layers), ReLU,
    dropouts, residual."""

    def __init__(self, d: int, dropout: float):
        super().__init__()
        self.conv1 = nn.Linear(d, d)
        self.conv2 = nn.Linear(d, d)
        self.dropout = dropout

    def reset_parameters(self, gen: torch.Generator) -> None:
        torch_linear_init_(self.conv1, gen)
        torch_linear_init_(self.conv2, gen)

    def forward(self, x, rng=None):
        y = torch.relu(apply_dropout(self.conv1(x), self.dropout, self.training, rng))
        return apply_dropout(self.conv2(y), self.dropout, self.training, rng) + x


class SasrecEncoder(nn.Module):
    """Log2feats on an already-embedded sequence [B, T, D] -> [B, T, D]."""

    def __init__(self, d: int, seq_len: int, num_blocks: int = 2,
                 num_heads: int = 8, dropout: float = 0.5,
                 kernels: str = "torch"):
        super().__init__()
        self.pos_emb = nn.Parameter(torch.empty(seq_len, d))
        self.dropout = dropout
        self.attn_ln = nn.ModuleList(TorchLayerNorm(d) for _ in range(num_blocks))
        self.attn = nn.ModuleList(
            TorchMultiheadAttention(d, num_heads, dropout, kernels)
            for _ in range(num_blocks)
        )
        self.ffn_ln = nn.ModuleList(TorchLayerNorm(d) for _ in range(num_blocks))
        self.ffn = nn.ModuleList(
            PointWiseFeedForward(d, dropout) for _ in range(num_blocks)
        )
        self.last_ln = TorchLayerNorm(d)

    def reset_parameters(self, gen: torch.Generator) -> None:
        torch_embedding_init_(self.pos_emb, gen)
        for m in (*self.attn_ln, *self.ffn_ln, self.last_ln):
            m.reset_parameters()
        for m in (*self.attn, *self.ffn):
            m.reset_parameters(gen)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        t = x.shape[1]
        x = apply_dropout(x + self.pos_emb[:t], self.dropout, self.training, rng)
        causal = torch.triu(
            torch.full((t, t), NEG_INF, dtype=x.dtype, device=x.device), diagonal=1
        )[None, None]
        for attn_ln, attn, ffn_ln, ffn in zip(
            self.attn_ln, self.attn, self.ffn_ln, self.ffn
        ):
            q = attn_ln(x)
            x = q + attn(q, x, x, causal, rng)  # residual onto the normalised Q
            x = ffn(ffn_ln(x), rng)
        return self.last_ln(x)
