"""The train and eval steps — the counterpart of `amid_tpu/train/steps.py`.

Each reference hot loop (train_sr.py:190-219, train_sr_dr.py:191-229,363-403,
test() train_sr.py:31-128) is one step function: device-side negative
sampling -> forward -> loss -> backward -> Adam update, with no host
round-trip inside (losses come back as device scalars).

What differs from the JAX package, by PyTorch's idiom:

* parameters live in the `nn.Module` and are updated in place; `TrainState`
  holds the parameter dictionary and the explicit Adam states
  (`train/optim.py`), and a step returns the same state object it was given;
* a step's `key` is an integer: the step builds its own generators from it
  (`ops.rng.StepRandom`), so two steps from one key and one state draw the
  same negatives and dropout masks;
* `neg=None` lets a caller hand a step its negatives instead of the
  sampler's draw (the parity tests feed both packages the same ones);
* the eval step takes no `params` argument: the model holds them.

`make_resident_chunk_runner` and `make_scanned_eval` are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from amid_tpu_torch.data.sampler import sample_negatives
from amid_tpu_torch.ops.rng import StepRandom
from amid_tpu_torch.train import losses
from amid_tpu_torch.train.metrics import positive_ranks
from amid_tpu_torch.train.optim import Adam


@dataclass
class TrainState:
    params: dict[str, torch.Tensor]  # the model's own parameters, by name
    opt_state: Any
    opt_state2: Optional[Any] = None  # DR phase-B optimizer moments


def init_state(model, tx: Adam, tx2: Optional[Adam] = None) -> TrainState:
    """Optimizer state(s) over ALL of the model's parameters."""
    params = dict(model.named_parameters())
    return TrainState(params, tx.init(params),
                      tx2.init(params) if tx2 is not None else None)


def _make_labels(bsz: int, num_neg: int, device) -> torch.Tensor:
    labels = torch.zeros((bsz, 1 + num_neg), dtype=torch.float32, device=device)
    labels[:, 0] = 1.0
    return labels


def _model_batch(batch: dict, neg: torch.Tensor) -> dict:
    return {
        "target": batch["target"],
        "neg_samples": neg,
        "seq_d1": batch["seq_d1"],
        "seq_d2": batch["seq_d2"],
    }


def _draw_negatives(rng: StepRandom, batch, pools, pool_sizes, num_neg: int, neg):
    if neg is not None:
        return torch.as_tensor(neg, device=pools.device)
    return sample_negatives(
        rng.sampler, pools, pool_sizes, batch["domain_id"], batch["reject"],
        num_neg, batch.get("reject_counts"),
    )


def nonfinite_flag(metrics: dict) -> torch.Tensor:
    """1.0 if any loss metric is non-finite, else 0.0 — a device scalar, so
    the trainer's latch sees EVERY step without a host sync per step."""
    flags = [(~torch.isfinite(v)).to(torch.float32) for v in metrics.values()]
    return torch.stack(flags).max()


def phase_a_loss(dr_e_w: Optional[float]) -> Callable:
    """loss_fn(out, labels, batch) -> (loss, metrics) of phase A:
    masked BCE, + dr_e_w * loss_dr_e when DR."""

    def loss_fn(out, labels, batch):
        loss_cls = losses.masked_bce_loss(
            out["logits_d1"], out["logits_d2"], labels, batch["domain_id"]
        )
        metrics = {"loss_cls": loss_cls}
        loss = loss_cls
        if dr_e_w is not None:
            dr_e = losses.dr_e_loss(out, labels, batch["domain_id"])
            loss = loss_cls + dr_e * dr_e_w
            metrics["loss_dr_e"] = dr_e
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def phase_b_loss(out, labels, batch):
    """Phase B (train_sr_dr.py:363-403): the DR regularizer."""
    loss = losses.dr_r_loss(out, labels, batch["domain_id"], batch["ob_label"])
    return loss, {"loss_dr_r": loss}


def _finish_metrics(metrics: dict) -> dict:
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["nonfinite"] = nonfinite_flag(metrics)
    return metrics


def _make_dense_step(model, tx: Adam, loss_fn: Callable, slot: int) -> Callable:
    """A dense step: Adam over ALL parameters with the moments of optimizer
    `slot` (1 = opt_state, 2 = opt_state2); the other state is untouched."""

    def step(state: TrainState, batch, pools, pool_sizes, key: int, neg=None):
        device = pools.device
        rng = StepRandom(key, device)
        neg = _draw_negatives(rng, batch, pools, pool_sizes, 1, neg)
        labels = _make_labels(batch["target"].shape[0], 1, device)
        model.train()
        out = model(_model_batch(batch, neg), rng=rng)
        loss, metrics = loss_fn(out, labels, batch)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names],
                                    allow_unused=True)
        tx.update_(state.params, dict(zip(names, grads)),
                   state.opt_state if slot == 1 else state.opt_state2)
        return state, _finish_metrics(metrics)

    return step


def make_train_step(model, tx: Adam, dr_e_w: Optional[float] = None,
                    c2dsr_w: Optional[float] = None) -> Callable:
    """Phase-A step: masked BCE (+ dr_e_w * loss_dr_e when DR).

    Returns step(state, batch, pools, pool_sizes, key, neg=None) ->
    (state, metrics)."""
    if c2dsr_w is not None:
        raise NotImplementedError("the C2DSR contrastive objective is not ported yet")
    return _make_dense_step(model, tx, phase_a_loss(dr_e_w), 1)


def make_dr_r_step(model, tx2: Adam) -> Callable:
    """Phase-B step (train_sr_dr.py:363-403): trains imputation/propensity
    heads on observed+unobserved rows with optimizer2, whose moments cover
    ALL parameters."""
    return _make_dense_step(model, tx2, phase_b_loss, 2)


def make_eval_step(model, num_neg: int) -> Callable:
    """Eval pass (test(), train_sr.py:31-128): forward with num_neg sampled
    negatives, masked BCE val loss, on-device positive ranks (fixed & raw
    tie-break variants).

    Returns step(batch, pools, pool_sizes, key, neg=None) -> dict."""

    @torch.no_grad()
    def step(batch, pools, pool_sizes, key: int, neg=None):
        device = pools.device
        neg = _draw_negatives(StepRandom(key, device), batch, pools, pool_sizes,
                              num_neg, neg)
        labels = _make_labels(batch["target"].shape[0], num_neg, device)
        model.eval()
        out = model(_model_batch(batch, neg))
        loss_cls = losses.masked_bce_loss(
            out["logits_d1"], out["logits_d2"], labels, batch["domain_id"]
        )
        # choose_predict (utils.py:21-32): the active domain's scores
        dom = batch["domain_id"][:, None]
        pred = torch.where(dom == 0, out["logits_d1"], out["logits_d2"])
        return {
            "loss_cls": loss_cls,
            "ranks_fixed": positive_ranks(pred, fix=True),
            "ranks_raw": positive_ranks(pred, fix=False),
        }

    return step
