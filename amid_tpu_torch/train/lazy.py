"""Lazy (sparse) Adam for the embedding table — the counterpart of
`amid_tpu/train/lazy.py`.

Dense Adam touches every row of the item table each step (params, gradient,
mu, nu) for a step that gathers a few thousand rows. The reference pays the
same, so dense is the parity default; this opt-in path (`lazy_table_adam`)
restructures the step so the table's gradient is never materialised and only
touched rows' parameters/moments move:

1. negatives are sampled first, then the step's unique ids are computed on
   the device at the static size `_unique_budget`, sorted, with the
   out-of-range sentinel V in the tail (`unique_padded`, the counterpart of
   `jnp.unique(size=, fill_value=)`), so every later shape is static;
2. the touched rows are gathered ONCE and become the differentiated leaf —
   the model's lookups are redirected to positions within them
   (`AMIDModel.lookup(ids_list, lazy_rows=(uids, rows))`); the table parameter
   takes no gradient;
3. the [U, D] row gradient drives a per-row Adam update (bias correction by
   the GLOBAL step count, a device tensor, in float64) written back in place
   by the unique-row scatter kernel (`ops/scatter.py`), which drops the
   sentinel rows; dense parameters use Adam as usual.

Nothing in the step reads a device value on the host, so it can be captured
as a CUDA graph (`train/graphs.py`).

Both DR phases are covered: `make_lazy_train_step` is phase A on optimizer 1,
`make_lazy_dr_r_step` phase B on optimizer 2 with a second, independent set
of table moments.

Semantics: identical to dense Adam on the first touch of each row; diverges
only in that an untouched row's moments do not decay that step (standard
lazy-Adam behaviour, cf. torch.optim.SparseAdam).

On a gspmd mesh (`parallel/`; shard_map does not cover it, as in the JAX
package) the unique ids come from the global batch and its negatives,
which every rank holds; their rows are one sharded lookup
(`parallel.embedding.sharded_lookup`), whole on every rank; the row
gradient is summed over `data` with the dense ones; and the scatter writes
each rank's table, mu and nu shard at `ids - lo`, dropping the ids outside
[0, V_local) (the kernel's contract).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from amid_tpu_torch.ops.embedding import embedding_gather_many_plain
from amid_tpu_torch.ops.scatter import (
    scatter_set_unique,
    scatter_set_unique3,
    scatter_set_unique3_plain,
    scatter_set_unique_plain,
)
from amid_tpu_torch.parallel.embedding import sharded_lookup
from amid_tpu_torch.train.optim import Adam, AdamState, bias_correction, new_count
from amid_tpu_torch.train.steps import (
    TrainState, _draw_negatives, _finish_metrics, _make_labels, _mesh_loss, _mesh_rows,
    _mesh_start, _model_batch, _step_random, _sum_grads, phase_a_loss, phase_b_loss,
)

TABLE_KEY = "item_embedding"


@dataclass
class LazyTableState:
    dense_opt: AdamState  # Adam state over the non-table params
    mu: torch.Tensor  # [V, D]
    nu: torch.Tensor  # [V, D]
    count: torch.Tensor  # global step (int32 on the device), for bias correction


def _init_slot(table, dense, tx: Adam) -> LazyTableState:
    return LazyTableState(
        dense_opt=tx.init(dense),
        mu=torch.zeros_like(table),
        nu=torch.zeros_like(table),
        count=new_count(table.device),
    )


def init_lazy_state(params, tx_dense: Adam,
                    tx2_dense: Optional[Adam] = None) -> TrainState:
    table = params[TABLE_KEY]
    dense = {k: v for k, v in params.items() if k != TABLE_KEY}
    opt = _init_slot(table, dense, tx_dense)
    opt2 = _init_slot(table, dense, tx2_dense) if tx2_dense is not None else None
    return TrainState(dict(params), opt, opt2)


def _unique_budget(batch_size: int, seq_len: int, num_neg: int) -> int:
    total = batch_size * (1 + num_neg + 2 * seq_len)
    return -(-total // 1024) * 1024


def unique_padded(ids: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """`jnp.unique(ids, size=size, fill_value=fill_value)` on the device: the
    sorted distinct values of `ids`, the first `size` of them, then
    `fill_value` up to `size`; no result size is read on the host.

    Sort, mark each value that differs from its left neighbour, number the
    marks by a cumulative sum, and scatter every value to its number: the
    copies of one value carry one number and one value, so the order of the
    writes does not matter. Numbers past `size` land in one spare slot."""
    s = torch.sort(ids.reshape(-1)).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[1:] = s[1:] != s[:-1]
    pos = (torch.cumsum(new, 0) - 1).clamp_(max=size)
    out = torch.full((size + 1,), fill_value, dtype=ids.dtype, device=ids.device)
    return out.scatter_(0, pos, s)[:size]


def _make_lazy_step(
    model,
    tx_dense: Adam,
    loss_fn: Callable,
    slot: int,
    fused_scatter: bool = True,
) -> Callable:
    """Shared lazy-step skeleton. loss_fn(out, labels, batch) ->
    (loss, metrics); slot selects which optimizer state (1 = opt_state,
    2 = opt_state2) is read and written — the other is untouched. The table
    rows take `tx_dense`'s own lr, b1, b2 and eps.

    A model built with kernels='cuda' writes back through the scatter kernel
    — one fused launch, or three single-array launches with
    fused_scatter=False; kernels='torch' through the plain versions."""
    lr, b1, b2, eps = tx_dense.lr, tx_dense.b1, tx_dense.b2, tx_dense.eps
    on_kernels = model.cfg.kernels == "cuda"
    set3 = scatter_set_unique3 if on_kernels else scatter_set_unique3_plain
    set1 = scatter_set_unique if on_kernels else scatter_set_unique_plain

    rng = _step_random(model)

    def step(state: TrainState, batch, pools, pool_sizes, key, neg=None):
        device = pools.device
        table = state.params[TABLE_KEY]
        opt: LazyTableState = state.opt_state if slot == 1 else state.opt_state2

        axes, batch, (neg,) = _mesh_start(rng, key, batch, (neg,))
        if axes is not None and axes.impl != "gspmd":
            raise ValueError("mesh_impl=shard_map does not cover --lazy_table_adam; use gspmd")
        neg = _draw_negatives(rng, batch, pools, pool_sizes, 1, neg)
        # the table's rows on this rank: [lo, lo + v_local) of v
        v_local = table.shape[0]
        v = v_local * (axes.model_shards if axes is not None else 1)
        lo = v_local * (axes.model_rank if axes is not None else 0)

        all_ids = torch.cat([
            batch["target"].reshape(-1), neg.reshape(-1),
            batch["seq_d1"].reshape(-1), batch["seq_d2"].reshape(-1),
        ])
        u_budget = _unique_budget(
            batch["target"].shape[0], batch["seq_d1"].shape[1], neg.shape[1]
        )
        uids = unique_padded(all_ids, u_budget, v)  # sorted; sentinel tail
        with torch.no_grad():
            if axes is None:
                rows = table.index_select(0, uids.clamp(max=v - 1))
            else:  # whole on every rank, from the shards that own them
                rows = sharded_lookup(table, [uids], axes, embedding_gather_many_plain)[0]
        rows.requires_grad_()  # [U, D] — the diff leaf
        batch, (neg,) = _mesh_rows(rng, axes, batch, (neg,))
        labels = _make_labels(batch["target"].shape[0], 1, device)

        dense = {k: p for k, p in state.params.items() if k != TABLE_KEY}
        model.train()
        out = model(_model_batch(batch, neg), rng=rng, lazy_rows=(uids, rows))
        loss, metrics = _mesh_loss(axes, *loss_fn(out, labels, batch))
        names = list(dense)
        *g_dense, g_rows = torch.autograd.grad(
            loss, [*(dense[k] for k in names), rows], allow_unused=True
        )
        grads = _sum_grads(axes, {**dict(zip(names, g_dense)), TABLE_KEY: g_rows},
                           {**dense, TABLE_KEY: rows})
        g_rows = grads.pop(TABLE_KEY)
        metrics = _finish_metrics(metrics)

        with torch.no_grad():
            # dense params: plain Adam
            tx_dense.update_(dense, grads, opt.dense_opt)

            # touched table rows: per-row Adam with global-step bias correction
            opt.count.add_(1)
            if g_rows is None:
                g_rows = torch.zeros_like(rows)
            ids = uids - lo  # this shard's rows; the others fall outside [0, v_local)
            safe = ids.clamp(0, v_local - 1)
            mu_new = b1 * opt.mu.index_select(0, safe) + (1.0 - b1) * g_rows
            nu_new = b2 * opt.nu.index_select(0, safe) + (1.0 - b2) * g_rows**2
            mhat = mu_new / bias_correction(b1, opt.count)
            vhat = nu_new / bias_correction(b2, opt.count)
            new_rows = rows.detach() - lr * mhat / (torch.sqrt(vhat) + eps)
            if fused_scatter:
                set3(table, opt.mu, opt.nu, ids, new_rows, mu_new, nu_new)
            else:
                set1(table, ids, new_rows)
                set1(opt.mu, ids, mu_new)
                set1(opt.nu, ids, nu_new)
        return state, metrics

    step.rng = rng
    return step


def make_lazy_train_step(model, tx_dense: Adam, dr_e_w: Optional[float] = None,
                         fused_scatter: bool = True) -> Callable:
    """Phase-A step (masked BCE, + dr_e_w * dr_e when DR) on optimizer 1."""
    return _make_lazy_step(model, tx_dense, phase_a_loss(dr_e_w), 1, fused_scatter)


def make_lazy_dr_r_step(model, tx2_dense: Adam, fused_scatter: bool = True) -> Callable:
    """Phase-B step (train_sr_dr.py:363-403): imputation/propensity heads on
    observed+unobserved rows, optimizer2 — with lazy table updates against
    the second per-row moment set."""
    return _make_lazy_step(model, tx2_dense, phase_b_loss, 2, fused_scatter)
