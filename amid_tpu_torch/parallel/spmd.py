"""The shard_map steps — the counterpart of `amid_tpu/parallel/spmd.py`.

The JAX package's gspmd path lets XLA partition the plain steps; its
shard_map path pins the collectives down around per-shard code. The port's
steps issue their collectives themselves on a mesh (`train/steps.py`,
inside `parallel.context.spmd`), so the two paths differ only in how a step
cuts the global batch and draws its randomness, which `SpmdAxes.impl`
selects:

* batch cut over `data` first; item table row-sharded over `model`; every
  other parameter and the optimizer moments replicated;
* embedding lookup = local gather + sum over `model`
  (`parallel.embedding.sharded_lookup`);
* InnerComp/InterComp = all-gather of the per-shard peer bank over `data`,
  the affinity and gate rows local (`models.comp.PeerMessage`);
* the negatives and dropout drawn per shard from the step key folded with
  the data rank when there is more than one data shard, and with no fold at
  one, so that a 1x1 mesh reproduces the single-process stream (the
  attention kernels' masks at row offset 0);
* loss = mean over `data`; the gradients of the replicated parameters and
  of the table shard summed over `data`.

Dense Adam only, and the per-step loop (`train/loop.py` refuses the lazy
table Adam and C2DSR, and keeps the fast loops off, with the JAX trainer's
messages).
"""

from __future__ import annotations

from typing import Callable, Optional

from amid_tpu_torch.parallel.context import spmd
from amid_tpu_torch.parallel.mesh import Mesh
from amid_tpu_torch.train.optim import Adam
from amid_tpu_torch.train.steps import make_dr_r_step, make_eval_step, make_train_step


def _in_region(step: Callable, mesh: Mesh) -> Callable:
    """`step` run on `mesh` with the shard_map semantics."""
    axes = mesh.axes("shard_map")

    def run(*args, **kwargs):
        with spmd(axes):
            return step(*args, **kwargs)

    run.rng = step.rng
    return run


def make_spmd_train_step(model, tx: Adam, mesh: Mesh,
                         dr_e_w: Optional[float] = None) -> Callable:
    """Phase-A step: masked BCE (+ dr_e_w * dr_e when DR), optimizer 1, each
    shard on its rows. step(state, batch, pools, pool_sizes, key, neg=None)
    with the global batch (and the global batch's negatives, if given)."""
    return _in_region(make_train_step(model, tx, dr_e_w=dr_e_w), mesh)


def make_spmd_dr_r_step(model, tx2: Adam, mesh: Mesh) -> Callable:
    """Phase-B step (train_sr_dr.py:363-403): imputation/propensity heads on
    observed+unobserved rows, optimizer2."""
    return _in_region(make_dr_r_step(model, tx2), mesh)


def make_spmd_eval_step(model, num_neg: int, mesh: Mesh) -> Callable:
    """Eval pass (test(), train_sr.py:31-128): per-shard negatives and
    forward; the val loss averaged over `data`, the ranks all-gathered so
    that every rank holds the global batch's."""
    return _in_region(make_eval_step(model, num_neg), mesh)
