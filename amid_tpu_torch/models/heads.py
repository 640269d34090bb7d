"""Prediction head — the counterpart of `amid_tpu/models/heads.py`.

predictModule (model_seq.py:32-54): sigmoid(MLP([user ; item])) scored once
with the domain-1 and once with the domain-2 user representation against the
same candidates. The concat [B, C, 2D] is never built: fc1's weight [H, 2D]
is split into its user and item halves,

    h = relu(u W_u^T + i W_i^T + b1)    # [B, C, H]
    logits = sigmoid(h w2^T + b2)       # [B, C]

and the item half is computed once for both users. `kernels='cuda'` scores
through the fused kernel (`ops.scoring.scoring_head_pair`: both user
representations in one launch, every candidate count: the TPU package's
`PALLAS_SCORING_MIN_C` is a TPU setting and is not carried over), which never
builds `[B, C, H]`; `kernels='torch'` is its plain version,
`ops.scoring.scoring_head_pair_plain`. In the model's bf16 mode
(`precision="bf16"`) both routes take bf16 operands in all three products
(`bf16=True`), as the JAX head's dots do under the bfloat16 context.
"""

from __future__ import annotations

import torch
from torch import nn

from amid_tpu_torch.ops.scoring import scoring_head_pair, scoring_head_pair_plain
from amid_tpu_torch.ops.torch_compat import torch_linear_init_


class PredictHead(nn.Module):
    def __init__(self, d: int, hid_dim: int, kernels: str = "torch",
                 precision: str = "fp32"):
        super().__init__()
        self.kernels = kernels
        self.precision = precision
        self.fc1 = nn.Linear(2 * d, hid_dim)  # torch init with fan_in = 2D
        self.fc2 = nn.Linear(hid_dim, 1)

    def reset_parameters(self, gen: torch.Generator) -> None:
        torch_linear_init_(self.fc1, gen)
        torch_linear_init_(self.fc2, gen)

    def split_fc1(self) -> tuple[torch.Tensor, torch.Tensor]:
        """fc1's weight as its (user, item) halves, each [H, D]."""
        d = self.fc1.in_features // 2
        return self.fc1.weight[:, :d], self.fc1.weight[:, d:]

    def forward(self, user_d1, user_d2, item_feat):
        """user_d*: [B, D]; item_feat: [B, C, D] -> (logits_d1, logits_d2),
        each [B, C]."""
        score = scoring_head_pair if self.kernels == "cuda" else scoring_head_pair_plain
        return score(user_d1, user_d2, item_feat, *self.split_fc1(), self.fc1.bias,
                     self.fc2.weight, self.fc2.bias, bf16=self.precision == "bf16")
