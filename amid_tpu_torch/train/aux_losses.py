"""Auxiliary losses from the reference's utility layer (utils.py:70-260) — the
counterpart of `amid_tpu/train/aux_losses.py`.

These are dead code in the reference's current trainers (sce_loss is bound at
train_sr.py:183 but never applied; the contrastive family belongs to an
earlier model iteration) but are part of the public component inventory, so
the port ships working equivalents, as plain functions on tensors, for users
who enable them. No trainer calls them.

Implemented (well-defined members only):
* sce_loss            (utils.py:170-180) — scaled cosine error.
* info_nce_loss       (utils.py:137-151, `cal_loss_cl_refine`) — normalized
  in-batch InfoNCE with temperature 0.07, diagonal positives.
* contrastive_margin_loss (utils.py:210-244, `ContrastiveLoss`) — siamese
  margin loss.
* cross_feature_cl_loss (utils.py:70-135, `cal_loss_cl_all`) — 1-vs-7
  feature-slot contrastive CE (query slot m1..m4 against the other slots).

(`cal_loss_cl`, utils.py:153-168, references an undefined global and cannot
be executed in the reference; it is intentionally not reproduced.)
"""

from __future__ import annotations

import torch


def _l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(min=eps)


def sce_loss(x: torch.Tensor, y: torch.Tensor, alpha: float = 3.0) -> torch.Tensor:
    """mean((1 - cos(x, y))^alpha) (utils.py:170-180)."""
    x = _l2norm(x)
    y = _l2norm(y)
    return torch.mean((1.0 - torch.sum(x * y, dim=-1)) ** alpha)


def info_nce_loss(a: torch.Tensor, b: torch.Tensor, temperature: float = 0.07) -> torch.Tensor:
    """In-batch InfoNCE with diagonal positives (utils.py:137-151):
    -log(exp(sim_ii/t) / sum_j exp(sim_ij/t)), sims on l2-normalized rows."""
    a = _l2norm(a)
    b = _l2norm(b)
    logits = torch.exp((a @ b.T) / temperature)
    pos = torch.diagonal(logits)
    neg = torch.sum(logits, dim=1)
    return torch.mean(-torch.log(pos / neg))


def contrastive_margin_loss(x0: torch.Tensor, x1: torch.Tensor, y: torch.Tensor,
                            margin: float = 1.0) -> torch.Tensor:
    """Siamese margin loss (utils.py:231-244): y*d^2 + (1-y)*max(m-d, 0)^2,
    summed and halved per row."""
    diff = x0 - x1
    dist_sq = torch.sum(diff**2, dim=1)
    dist = torch.sqrt(dist_sq)
    mdist = torch.clamp(margin - dist, min=0.0)
    loss = y * dist_sq + (1.0 - y) * mdist**2
    return torch.sum(loss) / 2.0 / x0.shape[0]


def cross_feature_cl_loss(feats_d1: list[torch.Tensor],
                          feats_d2: list[torch.Tensor]) -> torch.Tensor:
    """`cal_loss_cl_all` (utils.py:70-135): for each feature slot m, score its
    d1 representation against [own d2 (positive), all other slots' d1/d2
    (negatives)] with a dot product and take CE at label 0; sum over slots.
    The keys' order (own d2, then each other slot's d1 and d2 in slot order)
    sets the logits' columns, as in the JAX package."""
    slots = list(zip(feats_d1, feats_d2))
    total = 0.0
    for m, (q_d1, q_d2) in enumerate(slots):
        keys = [q_d2]
        for j, (o_d1, o_d2) in enumerate(slots):
            if j != m:
                keys.extend([o_d1, o_d2])
        key_mat = torch.stack(keys, dim=-1)  # [B, D, K]
        logits = torch.einsum("bd,bdk->bk", q_d1, key_mat)
        total = total + torch.mean(-torch.log_softmax(logits, dim=-1)[:, 0])
    return total
