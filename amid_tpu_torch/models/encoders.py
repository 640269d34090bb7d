"""Sequence encoders — the counterpart of `amid_tpu/models/encoders.py`:
SASRec (Log2feats, model_seq.py:331-387), BERT4Rec (model_seq.py:221-267) and
GRU4Rec (model_seq.py:72-73,92-95). Each maps an embedded sequence [B, T, D]
to [B, T, D].

SASRec quirks kept deliberately, as the JAX package keeps them:
* pre-LN on the attention query only; K and V take the un-normalised input,
  and the residual adds onto the normalised Q (model_seq.py:373-378);
* the causal mask is an additive -1e9 above the diagonal, not -inf (:369);
* a learned position embedding, sliced to the input length;
* the out_proj bias is trainable and zero at init (nn.MultiheadAttention).

BERT4Rec: pre-norm sublayers with the hand-rolled LayerNorm, separate q, k,
v and out projections, a tanh-GELU FFN, no positional embedding, and a
key-padding mask that the model builds (from `seq_d2 > 0` for both towers
under `bert_d2_mask_quirk`). The mask enters the attention as the additive
bias `where(key_mask, 0, -1e9)` [B, 1, 1, T], the JAX package's Pallas route
(`encoders.py:214-222`); its XLA route replaces masked scores by -1e9
instead, which agrees only while |score| < 32 (ROADMAP.md, "Deliberate
differences"). GRU4Rec: one `TorchGRU` a tower (the reference's dropout on a
one-layer GRU is a no-op and is left out, as in JAX).

With `kernels="cuda"` every attention core goes through the CUDA kernels
(`ops.attention.fused_attention`, forward and backward) at every sequence
length; with `kernels="torch"` through its plain PyTorch version.

`precision` is the model's mode (`ops.precision`): every projection, FFN
and GRU product goes through its `linear` / `matmul`, and in `"bf16"` the
attention core runs with bf16 operands (`mxu_bf16=True`). `remat=True`
(SASRec only, as in the JAX package) recomputes each block's attention and
FFN in the backward (`torch.utils.checkpoint`, non-reentrant) instead of
keeping their activations; each region keeps its dropout draws
(`ops.rng.RegionRandom`), so the recompute sees the forward's masks and the
gradients are the ones without remat. The parameter names do not change.

Train-mode dropout draws from the step's `ops.rng.StepRandom`, passed as
`rng` (SASRec: on the embedded input, on the attention probabilities and
twice in the FFN; BERT4Rec: on the probabilities, after each sublayer, in the
FFN and after the block); in eval mode `rng` is not read.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from amid_tpu_torch.ops.attention import attention_plain, fused_attention
from amid_tpu_torch.ops.precision import linear
from amid_tpu_torch.ops.rng import RegionRandom, apply_dropout
from amid_tpu_torch.ops.torch_compat import (
    RefLayerNorm,
    TorchGRU,
    TorchLayerNorm,
    tanh_gelu,
    torch_embedding_init_,
    torch_linear_init_,
    uniform_,
    xavier_uniform_init_,
)

NEG_INF = -1e9  # reference mask fill value (model_seq.py:155)


def _attention_dropout(training: bool, rate: float, rng):
    """(seed, rate, row_offset) of an attention call: a seed drawn from the
    step's generators in train mode with dropout and the global row of the
    batch's row 0 (`ops.rng.DropoutRandom.row_offset`: nonzero on a gspmd
    mesh rank), else (0, 0.0, 0)."""
    if not training or rate <= 0.0:
        return 0, 0.0, 0
    if rng is None:
        raise ValueError("train-mode attention dropout needs the step's "
                         "StepRandom (pass rng=...)")
    return rng.attention_seed(), rate, rng.row_offset


def _remat(fn, rng, *args):
    """fn(*args, rng) with its activations recomputed in the backward: the
    region draws through a `RegionRandom`, replayed by the recompute."""
    region = None if rng is None else RegionRandom(rng)
    calls = []

    def run(*a):
        if calls and region is not None:
            region.replay()
        calls.append(1)
        return fn(*a, region)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class TorchMultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters and math (model_seq.py:348-351):
    a fused in_proj [3D, D] with xavier-uniform init and zero bias, an
    out_proj Linear with a zero-init bias, dropout on the probabilities."""

    def __init__(self, d: int, num_heads: int, dropout: float, kernels: str,
                 precision: str = "fp32"):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.precision = precision
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
        d, mode = q.shape[-1], self.precision
        w, b = self.in_proj_weight, self.in_proj_bias
        qp = linear(q, w[:d], b[:d], mode)
        kp = linear(k, w[d : 2 * d], b[d : 2 * d], mode)
        vp = linear(v, w[2 * d :], b[2 * d :], mode)
        seed, rate, row_offset = _attention_dropout(self.training, self.dropout, rng)
        out = self.attend(qp, kp, vp, attn_bias, seed, self.num_heads, rate,
                          mxu_bf16=mode == "bf16", row_offset=row_offset)
        return linear(out, self.out_proj.weight, self.out_proj.bias, mode)


class PointWiseFeedForward(nn.Module):
    """SASRec FFN (model_seq.py:311-326): two k=1 convs (dense layers), ReLU,
    dropouts, residual."""

    def __init__(self, d: int, dropout: float, precision: str = "fp32"):
        super().__init__()
        self.conv1 = nn.Linear(d, d)
        self.conv2 = nn.Linear(d, d)
        self.dropout = dropout
        self.precision = precision

    def reset_parameters(self, gen: torch.Generator) -> None:
        torch_linear_init_(self.conv1, gen)
        torch_linear_init_(self.conv2, gen)

    def forward(self, x, rng=None):
        mode, c1, c2 = self.precision, self.conv1, self.conv2
        y = torch.relu(apply_dropout(linear(x, c1.weight, c1.bias, mode), self.dropout,
                                     self.training, rng))
        return apply_dropout(linear(y, c2.weight, c2.bias, mode), self.dropout,
                             self.training, rng) + x


class SasrecEncoder(nn.Module):
    """Log2feats on an already-embedded sequence [B, T, D] -> [B, T, D]."""

    def __init__(self, d: int, seq_len: int, num_blocks: int = 2,
                 num_heads: int = 8, dropout: float = 0.5,
                 kernels: str = "torch", precision: str = "fp32", remat: bool = False):
        super().__init__()
        self.pos_emb = nn.Parameter(torch.empty(seq_len, d))
        self.dropout = dropout
        self.remat = remat
        self.attn_ln = nn.ModuleList(TorchLayerNorm(d) for _ in range(num_blocks))
        self.attn = nn.ModuleList(
            TorchMultiheadAttention(d, num_heads, dropout, kernels, precision)
            for _ in range(num_blocks)
        )
        self.ffn_ln = nn.ModuleList(TorchLayerNorm(d) for _ in range(num_blocks))
        self.ffn = nn.ModuleList(
            PointWiseFeedForward(d, dropout, precision) for _ in range(num_blocks)
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
        remat = self.remat and torch.is_grad_enabled()
        for attn_ln, attn, ffn_ln, ffn in zip(
            self.attn_ln, self.attn, self.ffn_ln, self.ffn
        ):
            q = attn_ln(x)
            if remat:
                x = q + _remat(attn, rng, q, x, x, causal)
                x = _remat(ffn, rng, ffn_ln(x))
            else:
                x = q + attn(q, x, x, causal, rng)  # residual onto the normalised Q
                x = ffn(ffn_ln(x), rng)
        return self.last_ln(x)


class BertBlock(nn.Module):
    """TransformerBlock (model_seq.py:221-245): x + drop(MHA(norm(x))), then
    x + drop(FFN(norm(x))), then a trailing dropout. `bias` is the additive
    key-padding bias [B, 1, 1, T]."""

    def __init__(self, d: int, num_heads: int, ff_dim: int, dropout: float,
                 kernels: str, precision: str = "fp32"):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.precision = precision
        self.attend = fused_attention if kernels == "cuda" else attention_plain
        self.ln1 = RefLayerNorm(d)
        self.q, self.k, self.v, self.out = (nn.Linear(d, d) for _ in range(4))
        self.ln2 = RefLayerNorm(d)
        self.ff1 = nn.Linear(d, ff_dim)
        self.ff2 = nn.Linear(ff_dim, d)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in (self.q, self.k, self.v, self.out, self.ff1, self.ff2):
            torch_linear_init_(m, gen)
        for m in (self.ln1, self.ln2):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, rng=None) -> torch.Tensor:
        def drop(y):
            return apply_dropout(y, self.dropout, self.training, rng)

        def lin(layer, y):
            return linear(y, layer.weight, layer.bias, self.precision)

        q_in = self.ln1(x)
        seed, rate, row_offset = _attention_dropout(self.training, self.dropout, rng)
        att = self.attend(lin(self.q, q_in), lin(self.k, q_in), lin(self.v, q_in), bias,
                          seed, self.num_heads, rate, mxu_bf16=self.precision == "bf16",
                          row_offset=row_offset)
        x = x + drop(lin(self.out, att))
        f = lin(self.ff2, drop(tanh_gelu(lin(self.ff1, self.ln2(x)))))
        return drop(x + drop(f))


def key_padding_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """The additive fp32 bias [B, 1, 1, T] of a boolean key mask [B, T]: 0
    where a key is kept, -1e9 where it is masked (masked_fill(mask == 0,
    -1e9), model_seq.py:155, added to the scores as the Pallas route adds it)."""
    return torch.where(key_mask, 0.0, NEG_INF)[:, None, None, :]


class Bert4RecEncoder(nn.Module):
    """One tower of the BERT4Rec stack (model_seq.py:264-267): `num_blocks`
    BertBlocks, no positional embedding; `key_mask` [B, T] bool."""

    def __init__(self, d: int, num_blocks: int = 2, num_heads: int = 4,
                 ff_dim: int = 512, dropout: float = 0.1, kernels: str = "torch",
                 precision: str = "fp32"):
        super().__init__()
        self.block = nn.ModuleList(
            BertBlock(d, num_heads, ff_dim, dropout, kernels, precision)
            for _ in range(num_blocks))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in self.block:
            m.reset_parameters(gen)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor, rng=None) -> torch.Tensor:
        bias = key_padding_bias(key_mask)
        for blk in self.block:
            x = blk(x, bias, rng)
        return x


class GruEncoder(nn.Module):
    """GRU4Rec tower (model_seq.py:72-73,92-95): one `TorchGRU`, zero initial
    state; `rng` is not read (no dropout)."""

    def __init__(self, d: int, hidden: int, precision: str = "fp32"):
        super().__init__()
        self.gru = TorchGRU(d, hidden, precision)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.gru.reset_parameters(gen)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        return self.gru(x)
