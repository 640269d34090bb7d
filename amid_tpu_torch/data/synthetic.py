"""Synthetic packed datasets at the real table size, made from a numpy seed.

The reference CSVs are not part of the repository, so the scripts that run on the card
(`chip_smoke.py`, `amid_tpu_torch/profile_step.py`) train on data made here,
in the manner of the JAX package's `__graft_entry__.py::_synth_packed`, but
with item ids over the whole shared table and pools of the real size.
"""

from __future__ import annotations

import numpy as np

from amid_tpu_torch.config import ModelConfig
from amid_tpu_torch.data.packed import PackedDualDomainDataset, pack_rows


def synth_packed(cfg: ModelConfig, rng: np.random.Generator,
                 n_rows: int) -> PackedDualDomainDataset:
    """Histories of 2..T+2 items per domain, d1 ids from the first half of
    the shared table and d2 ids from the second (every row of the table can
    occur, the pad id cannot), a random active domain and observed flag;
    packed by `pack_rows`. The pools are then widened to the real size (every
    id of each half) and the rows' holes re-expressed as positions in them."""
    t = cfg.seq_len
    lo = np.array([0, cfg.item_length + 2])
    hi = np.array([cfg.item_length + 1, cfg.item_table_size])
    users, s1, s2, dom = [], [], [], []
    for i in range(n_rows):
        users.append(i)
        dom.append(int(rng.integers(0, 2)))
        s1.append(rng.integers(lo[0], hi[0], int(rng.integers(2, t + 3))).tolist())
        s2.append(rng.integers(lo[1], hi[1], int(rng.integers(2, t + 3))).tolist())
    ob = rng.integers(0, 2, n_rows).tolist()
    ds = pack_rows(users, s1, s2, dom, ob, t, cfg.pad_id)

    width = int((hi - lo).max())
    held = ds.reject < ds.pools.shape[1]  # real holes, not the sentinel
    items = ds.pools[ds.domain_id[:, None], np.where(held, ds.reject, 0)]
    ds.reject = np.where(held, items - lo[ds.domain_id][:, None], width).astype(np.int32)
    ds.pools = np.stack([np.resize(np.arange(a, b, dtype=np.int32), width)
                         for a, b in zip(lo, hi)])
    ds.pool_sizes = (hi - lo).astype(np.int32)
    return ds
