"""Training losses — the counterpart of `amid_tpu/train/losses.py`.

* masked BCE — the base objective (train_sr.py:210-212): per-domain BCE on
  sigmoid outputs, masked by the row's active domain, mean over all elements.
* DR error loss (phase A, train_sr_dr.py:217-221):
      loss_dr_e = mean( (BCE(p) - gfunc)^2 / ips , domain-masked )
* DR regularizer (phase B, train_sr_dr.py:392-394):
      loss_dr_r = mean( gfunc^2 + ob * ((BCE(p)^2 - gfunc^2)^2) / ips ,
                        domain-masked )

BCE matches torch nn.BCELoss numerics: log clamped at -100.
"""

from __future__ import annotations

import torch


def bce(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on probabilities (torch BCELoss with
    reduce=False): -(y log p + (1-y) log(1-p)), logs clamped at -100."""
    log_p = torch.log(pred).clamp(min=-100.0)
    log_1p = torch.log(1.0 - pred).clamp(min=-100.0)
    return -(label * log_p + (1.0 - label) * log_1p)


def domain_masks(domain_id: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask_d1, mask_d2) column vectors from the row's active domain
    (train_sr.py:205-207)."""
    d = domain_id.to(torch.float32)[:, None]
    return 1.0 - d, d


def masked_bce_loss(
    logits_d1: torch.Tensor, logits_d2: torch.Tensor,
    labels: torch.Tensor, domain_id: torch.Tensor,
) -> torch.Tensor:
    m1, m2 = domain_masks(domain_id)
    per = bce(logits_d1, labels) * m1 + bce(logits_d2, labels) * m2
    return per.mean()


def dr_e_loss(
    out: dict[str, torch.Tensor], labels: torch.Tensor, domain_id: torch.Tensor
) -> torch.Tensor:
    m1, m2 = domain_masks(domain_id)
    e1 = (bce(out["logits_d1"], labels) - out["gfunc_d1"]) ** 2 / out["ips_d1"]
    e2 = (bce(out["logits_d2"], labels) - out["gfunc_d2"]) ** 2 / out["ips_d2"]
    return (e1 * m1 + e2 * m2).mean()


def dr_r_loss(
    out: dict[str, torch.Tensor],
    labels: torch.Tensor,
    domain_id: torch.Tensor,
    ob_label: torch.Tensor,
) -> torch.Tensor:
    m1, m2 = domain_masks(domain_id)
    ob = ob_label.to(torch.float32)[:, None]  # broadcast over candidates
    #     (reference tiles to [B, 2], train_sr_dr.py:391)
    r1 = (
        out["gfunc_d1"] ** 2
        + ob * ((bce(out["logits_d1"], labels) ** 2 - out["gfunc_d1"] ** 2) ** 2)
        / out["ips_d1"]
    )
    r2 = (
        out["gfunc_d2"] ** 2
        + ob * ((bce(out["logits_d2"], labels) ** 2 - out["gfunc_d2"] ** 2) ** 2)
        / out["ips_d2"]
    )
    return (r1 * m1 + r2 * m2).mean()
