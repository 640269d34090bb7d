"""The train and eval steps — the counterpart of `amid_tpu/train/steps.py`.

Each reference hot loop (train_sr.py:190-219, train_sr_dr.py:191-229,363-403,
test() train_sr.py:31-128) is one step function: device-side negative
sampling -> forward -> loss -> backward -> Adam update, with no host
round-trip inside (losses come back as device scalars).

What differs from the JAX package, by PyTorch's idiom:

* parameters live in the `nn.Module` and are updated in place; `TrainState`
  holds the parameter dictionary and the explicit Adam states
  (`train/optim.py`), and a step returns the same state object it was given;
* a step's `key` is an integer: a step function owns one `ops.rng.
  StepRandom` (`step.rng`) and reseeds it from each step's key, so two steps
  from one key and one state draw the same negatives and dropout masks;
  `key=None` runs with the generators as the caller seeded them (what a
  CUDA graph of the step does: `train/graphs.py`);
* `neg=None` lets a caller hand a step its negatives instead of the
  sampler's draw, and `corr=None` a C2DSR step its corrupted items (the
  parity tests feed both packages the same ones);
* the eval step takes no `params` argument: the model holds them.

A step reads no device value on the host: the step count, the bias
corrections, the lazy step's unique ids and the attention kernels' dropout
seeds stay on the device. So a step can be captured as a CUDA graph and
replayed: `make_resident_chunk_runner` and `make_scanned_eval`, the fast
loops (`TrainConfig.fast_train`, `fast_eval`), run the steps over a dataset
resident on the device, as graphs on `cuda` and eagerly on the CPU.

On a mesh (inside `parallel.context.spmd`, `parallel/`) every step takes the
GLOBAL batch, which every rank holds, and runs on this rank's rows of it:
the table parameter is this rank's row shard and the model's lookups and
peer banks issue their collectives (`models/amid.py`, `models/comp.py`);
the loss and the logged metrics are averaged over the `data` group, the
gradients summed over it (the table shard's too), and the update is the
plain one, so every rank of a `model` group holds the same replicated
parameters. Under `impl="gspmd"` the negatives, C2DSR's corrupted items
and every dropout mask are drawn at the global batch's shape and cut to the
rank's rows (`ops.rng.StepRandom.set_rows`; the attention kernels' masks by
their row offset), so a mesh step computes the single-process step of the
global batch; under `impl="shard_map"` (`parallel/spmd.py`) the batch is cut
first and each shard draws its own, from the key folded with its data rank
when there is more than one. A `neg` (or `corr`) handed to a mesh step is
the global batch's. The evaluation step all-gathers the ranks over `data`,
so every rank reads the global batch's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from amid_tpu_torch.data.sampler import sample_negatives
from amid_tpu_torch.ops.rng import StepRandom, fold_in
from amid_tpu_torch.parallel import context
from amid_tpu_torch.parallel.collectives import (
    all_gather_data, mean_data, pmean_data, sum_data_,
)
from amid_tpu_torch.train import losses
from amid_tpu_torch.train.c2dsr import c2dsr_loss, c2dsr_views, sample_corr
from amid_tpu_torch.train.graphs import GraphPool, StepGraph
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


def _step_random(model, c2dsr: bool = False) -> StepRandom:
    """The generators of a step function, on the model's device, unseeded."""
    return StepRandom(None, model.item_embedding.device, c2dsr)


def _seeded(rng: StepRandom, key) -> StepRandom:
    if key is not None:
        return rng.reseed(key)
    if rng.key is None:
        raise ValueError("a step without a key needs its generators seeded first "
                         "(step.rng.reseed(key))")
    return rng


def _rows_of(axes, x):
    """This rank's rows of a global batch array."""
    lo, hi = axes.rows(x.shape[0])
    return x[lo:hi]


def _local(axes, batch: dict) -> dict:
    return {k: _rows_of(axes, torch.as_tensor(v)) for k, v in batch.items()}


def _mesh_start(rng: StepRandom, key, batch: dict, given: tuple):
    """The mesh's part before a step's draws: (axes, batch, given) with the
    generators seeded. Off the mesh and under gspmd the batch stays global;
    under shard_map it is cut to this rank's rows (with the arrays `given`
    in place of draws) and the key is folded with the data rank when there
    are several data shards (`amid_tpu/parallel/spmd.py`)."""
    axes = context.current()
    if axes is None or axes.impl == "gspmd":
        _seeded(rng, key)
        return axes, batch, given
    if key is not None and axes.data_shards > 1:
        key = fold_in(key, axes.data_rank)
    _seeded(rng, key)
    given = tuple(None if g is None else _rows_of(axes, torch.as_tensor(g)) for g in given)
    return axes, _local(axes, batch), given


def _mesh_rows(rng: StepRandom, axes, batch: dict, drawn: tuple):
    """The mesh's part after the draws: under gspmd this rank's rows of the
    batch and of the draws, and the dropout masks set to the global rows."""
    if axes is None or axes.impl != "gspmd":
        rng.set_rows(None)
        return batch, drawn
    n = batch["target"].shape[0]
    rng.set_rows((axes.rows(n)[0], n))
    return _local(axes, batch), tuple(None if d is None else _rows_of(axes, d) for d in drawn)


def _mesh_loss(axes, loss, metrics: dict):
    """The loss and metrics averaged over `data` on a mesh."""
    if axes is None:
        return loss, metrics
    return pmean_data(loss, axes), mean_data(metrics, axes)


def _sum_grads(axes, grads: dict, params: dict, table_key: str = "item_embedding") -> dict:
    """Every gradient summed over the `data` group on a mesh (a missing one
    as zeros): the table's alone, in place, the others in one buffer."""
    if axes is None:
        return grads
    grads = {k: g if g is not None else torch.zeros_like(params[k]) for k, g in grads.items()}
    sum_data_([g for k, g in grads.items() if k != table_key], axes)
    if table_key in grads:
        sum_data_([grads[table_key]], axes)
    return grads


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


def _make_dense_step(model, tx: Adam, loss_fn: Callable, slot: int,
                     c2dsr_w: Optional[float] = None) -> Callable:
    """A dense step: Adam over ALL parameters with the moments of optimizer
    `slot` (1 = opt_state, 2 = opt_state2); the other state is untouched.
    With `c2dsr_w`, + c2dsr_w * the C2DSR infomax loss of the views, whose
    gradient flows through the main forward's u_d1, u_d2 and both view
    passes (`train/c2dsr.py`). `step.losses` is the step's forward alone:
    the same draws from `key`, (loss, metrics), without the gradient and
    the update."""

    is_c2dsr = c2dsr_w is not None
    rng = _step_random(model, is_c2dsr)

    def losses_of(batch, pools, pool_sizes, key, neg=None, corr=None):
        device = pools.device
        axes, batch, (neg, corr) = _mesh_start(rng, key, batch, (neg, corr))
        neg = _draw_negatives(rng, batch, pools, pool_sizes, 1, neg)
        if is_c2dsr and corr is None:
            corr = sample_corr(rng.corr, pools, pool_sizes, batch)
        if corr is not None:
            corr = torch.as_tensor(corr, device=device)
        batch, (neg, corr) = _mesh_rows(rng, axes, batch, (neg, corr))
        labels = _make_labels(batch["target"].shape[0], 1, device)
        model_batch = _model_batch(batch, neg)
        if is_c2dsr:
            views = c2dsr_views(batch, corr)
        model.train()
        out = model(model_batch, rng=rng)
        loss, metrics = loss_fn(out, labels, batch)
        if is_c2dsr:
            cl = c2dsr_loss(model, model_batch, views, out["u_d1"], out["u_d2"], rng.views)
            loss = loss + cl * c2dsr_w
            metrics["loss_cl"] = cl
            metrics["loss"] = loss
        return _mesh_loss(axes, loss, metrics)

    def step(state: TrainState, batch, pools, pool_sizes, key, neg=None, corr=None):
        loss, metrics = losses_of(batch, pools, pool_sizes, key, neg, corr)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names],
                                    allow_unused=True)
        grads = _sum_grads(context.current(), dict(zip(names, grads)), state.params)
        tx.update_(state.params, grads, state.opt_state if slot == 1 else state.opt_state2)
        return state, _finish_metrics(metrics)

    step.rng = rng
    step.losses = losses_of
    return step


def make_train_step(model, tx: Adam, dr_e_w: Optional[float] = None,
                    c2dsr_w: Optional[float] = None) -> Callable:
    """Phase-A step: masked BCE (+ dr_e_w * loss_dr_e when DR,
    + c2dsr_w * contrastive infomax when C2DSR — train/c2dsr.py, with a
    `loss_cl` metric).

    Returns step(state, batch, pools, pool_sizes, key, neg=None, corr=None)
    -> (state, metrics); `corr` [B, L] hands a C2DSR step its corrupted
    items in place of its draw (`rng.corr`)."""
    return _make_dense_step(model, tx, phase_a_loss(dr_e_w), 1, c2dsr_w)


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
    rng = _step_random(model)

    @torch.no_grad()
    def step(batch, pools, pool_sizes, key, neg=None):
        device = pools.device
        axes, batch, (neg,) = _mesh_start(rng, key, batch, (neg,))
        neg = _draw_negatives(rng, batch, pools, pool_sizes, num_neg, neg)
        batch, (neg,) = _mesh_rows(rng, axes, batch, (neg,))
        labels = _make_labels(batch["target"].shape[0], num_neg, device)
        model.eval()
        out = model(_model_batch(batch, neg))
        loss_cls = losses.masked_bce_loss(
            out["logits_d1"], out["logits_d2"], labels, batch["domain_id"]
        )
        # choose_predict (utils.py:21-32): the active domain's scores
        dom = batch["domain_id"][:, None]
        pred = torch.where(dom == 0, out["logits_d1"], out["logits_d2"])
        got = {
            "loss_cls": loss_cls,
            "ranks_fixed": positive_ranks(pred, fix=True),
            "ranks_raw": positive_ranks(pred, fix=False),
        }
        if axes is not None:  # every rank reads the global batch's ranks
            got["loss_cls"] = mean_data({"loss_cls": loss_cls}, axes)["loss_cls"]
            for k in ("ranks_fixed", "ranks_raw"):
                got[k] = all_gather_data(got[k], axes)
        return got

    step.rng = rng
    return step


def _bind_once(bound: list, args: tuple, make: Callable) -> tuple:
    """`make(*args)` at the first call; later calls must pass the same
    objects, since a captured graph reads them where they lie."""
    if not bound:
        bound.append((args, make(*args)))
    held, made = bound[0]
    if any(a is not b for a, b in zip(args, held)):
        raise ValueError("a fast-loop runner is bound to the state, arrays and pools of "
                         "its first call; make a new runner for others")
    return made


def make_resident_chunk_runner(step, batch_size: int,
                               pool: Optional[GraphPool] = None) -> Callable:
    """A chunk of train steps over the DEVICE-RESIDENT dataset (the fast
    train loop, `TrainConfig.fast_train`) — the counterpart of the JAX
    package's `make_resident_chunk_runner`, where `lax.scan` runs the chunk.

    run_chunk(state, arrays, perm, pools, pool_sizes, base_key, kidxs, bidxs)
    -> (state, first-step metrics, nonfinite latch): `arrays` = {k: [n, ...]}
    on the device (put there once per seed), `perm` [nb * bs] the epoch's row
    order in a device buffer the caller refills each epoch, `kidxs` the
    key-fold indices of the chunk's steps (phase B offsets them by 20_000),
    `bidxs` their batch positions 0..nb-1. Step j gathers its batch on the
    device, rows perm[bidxs[j]*bs : (bidxs[j]+1)*bs] of every array, and runs
    with the key fold_in(base_key, kidxs[j]), as the per-step loop does. The
    first step's metrics come back cloned (the loop logs at chunk starts),
    the latch as the largest `nonfinite` flag of the chunk, a device scalar.

    On `cuda` the step is a `StepGraph` in `pool` (a pool of its own if none
    is given): the runner's first step runs eagerly, the second captures,
    every later one is a replay; on the CPU every step runs eagerly. The
    runner is bound to the state, arrays, permutation and pools of its
    first call."""
    bound: list = []

    def bind(state, arrays, perm, pools, pool_sizes):
        device = perm.device
        idx = torch.zeros(1, dtype=torch.int64, device=device)  # the step's batch
        latch = torch.zeros((), dtype=torch.float32, device=device)
        perm2d = perm.view(-1, batch_size)

        def body():
            rows = perm2d.index_select(0, idx).reshape(-1)
            batch = {k: v.index_select(0, rows) for k, v in arrays.items()}
            _, m = step(state, batch, pools, pool_sizes, None)
            torch.maximum(latch, m["nonfinite"], out=latch)
            return m

        run = body
        if device.type == "cuda":
            run = StepGraph(body, step.rng.generators(), pool or GraphPool(device))
        return idx, latch, run

    def run_chunk(state, arrays, perm, pools, pool_sizes, base_key, kidxs, bidxs):
        idx, latch, run = _bind_once(bound, (state, arrays, perm, pools, pool_sizes), bind)
        latch.zero_()
        m0 = None
        for ki, bi in zip(kidxs, bidxs):
            step.rng.reseed(fold_in(base_key, ki))
            idx.fill_(bi)
            m = run()
            if m0 is None:
                m0 = {k: v.clone() for k, v in m.items() if k != "nonfinite"}
        return state, m0, latch

    return run_chunk


def make_scanned_eval(model, num_neg: int, pool: Optional[GraphPool] = None) -> Callable:
    """The whole evaluation pass over the val batches stacked on the device
    (the fast evaluation, `TrainConfig.fast_eval`) — the counterpart of the
    JAX package's `make_scanned_eval`, where `lax.scan` runs the pass.

    eval_all(batches, pools, pool_sizes, key) -> {loss_cls [nb],
    ranks_fixed [nb, B], ranks_raw [nb, B]}: `batches` = {k: [nb, B, ...]}
    stacked once per seed (the val loader is deterministic); batch i draws
    its negatives with fold_in(key, i), as the per-batch loop does, and
    writes row i of the results, device buffers that the next pass
    overwrites (the caller reads them once a pass). On `cuda` the step is a
    `StepGraph` in `pool`; on the CPU it runs eagerly. Bound to the batches
    and pools of its first call."""
    eval_step = make_eval_step(model, num_neg)
    bound: list = []

    def bind(batches, pools, pool_sizes):
        nb, bsz = next(iter(batches.values())).shape[:2]
        device = pools.device
        idx = torch.zeros(1, dtype=torch.int64, device=device)
        res = {"loss_cls": torch.zeros(nb, device=device),
               "ranks_fixed": torch.zeros((nb, bsz), dtype=torch.int32, device=device),
               "ranks_raw": torch.zeros((nb, bsz), dtype=torch.int32, device=device)}

        def body():
            batch = {k: v.index_select(0, idx)[0] for k, v in batches.items()}
            out = eval_step(batch, pools, pool_sizes, None)
            for k, buf in res.items():
                buf.index_copy_(0, idx, out[k].reshape(1, *buf.shape[1:]))
            return out

        run = body
        if device.type == "cuda":
            run = StepGraph(body, eval_step.rng.generators(), pool or GraphPool(device))
        return nb, idx, res, run

    def eval_all(batches, pools, pool_sizes, key):
        nb, idx, res, run = _bind_once(bound, (batches, pools, pool_sizes), bind)
        for i in range(nb):
            eval_step.rng.reseed(fold_in(key, i))
            idx.fill_(i)
            run()
        return res

    return eval_all
