"""SPMD context: lets the model's and the steps' code know that it runs on
one rank of a `data x model` mesh, and which groups its collectives use —
the counterpart of `amid_tpu/parallel/context.py`.

The model code (embedding lookup, InnerComp/InterComp peer banks) and the
train steps are written once; inside `spmd(axes)` they see this rank's
shards and issue the collectives themselves:

* embedding lookup -> mask-and-all-reduce over the `model` group
  (`parallel.embedding.sharded_lookup`),
* peer message passing -> all-gather of the per-shard peer bank over the
  `data` group (`models.comp.PeerMessage`),
* the steps -> this rank's rows of the global batch, the loss averaged and
  the gradients summed over `data` (`train/steps.py`, `train/lazy.py`).

`impl` says how a step cuts the global batch and draws its randomness:
"gspmd" draws every random number at the global batch's shape and keeps
this rank's rows (so a mesh run computes the single-process function of the
global batch, as XLA's partitioning does); "shard_map" cuts the batch first
and draws per shard, from the step key folded with the data rank when there
is more than one data shard (`amid_tpu/parallel/spmd.py`).

The JAX module's other half, the lazy-rows redirection, lives in the port
as `AMIDModel.lookup(..., lazy_rows=)` (`models/amid.py`).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True, eq=False)
class SpmdAxes:
    """This rank's place on the mesh: the two groups, their sizes and this
    rank's index in each, and the step semantics (`impl`)."""

    data_group: Any = None  # a torch.distributed ProcessGroup
    model_group: Any = None
    data_shards: int = 1
    model_shards: int = 1
    data_rank: int = 0
    model_rank: int = 0
    impl: str = "gspmd"

    def rows(self, n_global: int) -> tuple[int, int]:
        """This rank's [start, end) rows of a global batch of `n_global`."""
        per = n_global // self.data_shards
        return self.data_rank * per, (self.data_rank + 1) * per


_ctx: contextvars.ContextVar[Optional[SpmdAxes]] = contextvars.ContextVar(
    "amid_torch_spmd_axes", default=None
)


def current() -> Optional[SpmdAxes]:
    return _ctx.get()


@contextlib.contextmanager
def spmd(axes: Optional[SpmdAxes]):
    """Runs the body on `axes` (None: off the mesh)."""
    token = _ctx.set(axes)
    try:
        yield
    finally:
        _ctx.reset(token)
