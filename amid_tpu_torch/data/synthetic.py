"""Synthetic datasets at the real table size, made from a numpy seed: packed
arrays (`synth_packed`) and CSV files in the reference's format
(`write_synthetic_csvs`), which the trainer's CLI reads like real ones.

The reference CSVs are not part of the repository, so the scripts that run on the card
(`chip_smoke.py`, `amid_tpu_torch/profile_step.py`) train on data made here,
in the manner of the JAX package's `__graft_entry__.py::_synth_packed`, but
with item ids over the whole shared table and pools of the real size.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from amid_tpu_torch.config import DataConfig, ModelConfig
from amid_tpu_torch.data.packed import PackedDualDomainDataset, pack_rows


def _id_ranges(cfg: ModelConfig):
    """[lo, hi) of the d1 and d2 item ids: the two halves of the shared
    table, the pad id left out."""
    return (np.array([0, cfg.item_length + 2]),
            np.array([cfg.item_length + 1, cfg.item_table_size]))


def _synth_rows(cfg: ModelConfig, rng: np.random.Generator, n_rows: int):
    """Histories of 2..T+2 items per domain, a random active domain and
    observed flag, as python lists."""
    t = cfg.seq_len
    lo, hi = _id_ranges(cfg)
    users, s1, s2, dom = [], [], [], []
    for i in range(n_rows):
        users.append(i)
        dom.append(int(rng.integers(0, 2)))
        s1.append(rng.integers(lo[0], hi[0], int(rng.integers(2, t + 3))).tolist())
        s2.append(rng.integers(lo[1], hi[1], int(rng.integers(2, t + 3))).tolist())
    ob = rng.integers(0, 2, n_rows).tolist()
    return users, s1, s2, dom, ob


def synth_packed(cfg: ModelConfig, rng: np.random.Generator,
                 n_rows: int) -> PackedDualDomainDataset:
    """Histories of 2..T+2 items per domain, d1 ids from the first half of
    the shared table and d2 ids from the second (every row of the table can
    occur, the pad id cannot), a random active domain and observed flag;
    packed by `pack_rows`. The pools are then widened to the real size (every
    id of each half) and the rows' holes re-expressed as positions in them."""
    lo, hi = _id_ranges(cfg)
    ds = pack_rows(*_synth_rows(cfg, rng, n_rows), cfg.seq_len, cfg.pad_id)

    width = int((hi - lo).max())
    held = ds.reject < ds.pools.shape[1]  # real holes, not the sentinel
    items = ds.pools[ds.domain_id[:, None], np.where(held, ds.reject, 0)]
    ds.reject = np.where(held, items - lo[ds.domain_id][:, None], width).astype(np.int32)
    ds.pools = np.stack([np.resize(np.arange(a, b, dtype=np.int32), width)
                         for a, b in zip(lo, hi)])
    ds.pool_sizes = (hi - lo).astype(np.int32)
    return ds


def write_synthetic_csvs(data: DataConfig, cfg: ModelConfig, rng: np.random.Generator,
                         n_train: int, n_val: int, n_dr: int = 0) -> list[str]:
    """Writes the train, test and (n_dr > 0) DR splits that `data` names, in
    the reference's CSV format (columns user_id, seq_d1, seq_d2, domain_id and,
    in the DR split, ob_label; sequences as JSON lists), with the rows of
    `synth_packed`. A split's item pools are the items its own rows hold, as
    with real CSVs. Returns the paths written."""
    splits = [(data.train_csv(), n_train, False), (data.test_csv(), n_val, False)]
    if n_dr:
        splits.append((data.train_dr_csv(), n_dr, True))
    for path, n_rows, with_ob in splits:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        users, s1, s2, dom, ob = _synth_rows(cfg, rng, n_rows)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["user_id", "seq_d1", "seq_d2", "domain_id"]
                       + (["ob_label"] if with_ob else []))
            for i in range(n_rows):
                w.writerow([users[i], json.dumps(s1[i]), json.dumps(s2[i]), dom[i]]
                           + ([ob[i]] if with_ob else []))
    return [path for path, _, _ in splits]
