"""Packed dual-domain dataset: CSV -> dense int32 arrays, parsed once — the
port's own copy of `amid_tpu/data/packed.py` (numpy only). The CSV is read
and packed in C++ (`data/native.py`, the repository's `native/` library)
where that library loads, as in the JAX package, and in Python otherwise
(`read_csv_python` and `pack_rows`), with the same arrays.

The reference re-parses each row's JSON sequences in `__getitem__` every epoch
across 8 DataLoader workers (dataset_seq.py:177-250). Here the CSV is parsed a
single time into padded int32 arrays; everything downstream (negative
sampling, batching, model input) is array arithmetic that can run on device.

Semantics reproduced exactly from `DualDomainSeqDataset.__getitem__`
(dataset_seq.py:177-250):

* `overlap_label` = both raw sequences non-empty (dataset_seq.py:181-184).
* active domain = `domain_id` column; its last item is popped as the positive
  target, then every other occurrence of the target is removed from the
  remaining history (dataset_seq.py:187-196).
* negatives are sampled uniformly from the split's item pool for the active
  domain minus ALL of the user's items in that domain including the target
  (dataset_seq.py:188: the pool subtraction happens before the pop)
  — the per-row rejection set is stored in `reject`.
* both sequences are left-padded with `pad_id` / truncated to the last
  `seq_len` items; `long_tail_mask` = len(seq) >= long_length, evaluated on
  the post-dedupe active sequence and the raw other sequence
  (dataset_seq.py:12-22,223-224).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np


def seq_pad_trunc(seq: list[int], seq_len: int, pad_id: int) -> list[int]:
    """Left-pad with pad_id / keep last `seq_len` items (dataset_seq.py:12-22,
    called with length_enc = seq_len + 1 so output length is exactly seq_len).
    """
    if len(seq) >= seq_len + 1:
        return seq[-seq_len:]
    return [pad_id] * (seq_len - len(seq)) + seq


@dataclass
class PackedDualDomainDataset:
    user: np.ndarray  # [N] int32
    target: np.ndarray  # [N] int32 positive item
    seq_d1: np.ndarray  # [N, L] int32, left-padded with pad_id
    seq_d2: np.ndarray  # [N, L] int32
    long_mask_d1: np.ndarray  # [N] int32
    long_mask_d2: np.ndarray  # [N] int32
    domain_id: np.ndarray  # [N] int32, 0 or 1
    overlap: np.ndarray  # [N] int32
    ob_label: np.ndarray  # [N] int32 (DR observed flag; all ones for non-DR)
    reject: np.ndarray  # [N, R] int32: *positions in the active domain's
    #   sorted pool* of the user's items (incl. target), ascending, padded
    #   with P (= pools.shape[1], a sentinel past every valid index).
    #   Negatives are sampled uniformly from the pool minus these holes.
    reject_counts: np.ndarray  # [N] int32 number of real holes per row
    pools: np.ndarray  # [2, P] int32, per-domain sorted item pools padded
    pool_sizes: np.ndarray  # [2] int32 true pool sizes
    pad_id: int
    seq_len: int

    def __len__(self) -> int:
        return int(self.user.shape[0])

    def save(self, path: str) -> None:
        """Persist the packed arrays (npz). Re-loading skips CSV/JSON parsing
        entirely — the production restart path for large splits."""
        np.savez_compressed(
            path,
            pad_id=np.int32(self.pad_id),
            seq_len=np.int32(self.seq_len),
            **self.batch_arrays(),
            pools=self.pools,
            pool_sizes=self.pool_sizes,
        )

    @classmethod
    def load(cls, path: str) -> "PackedDualDomainDataset":
        z = np.load(path)
        return cls(
            user=z["user"], target=z["target"],
            seq_d1=z["seq_d1"], seq_d2=z["seq_d2"],
            long_mask_d1=z["long_mask_d1"], long_mask_d2=z["long_mask_d2"],
            domain_id=z["domain_id"], overlap=z["overlap"],
            ob_label=z["ob_label"], reject=z["reject"],
            reject_counts=z["reject_counts"], pools=z["pools"],
            pool_sizes=z["pool_sizes"],
            pad_id=int(z["pad_id"]), seq_len=int(z["seq_len"]),
        )

    def batch_arrays(self) -> dict[str, np.ndarray]:
        """Per-row arrays that get sliced into batches."""
        return {
            "user": self.user,
            "target": self.target,
            "seq_d1": self.seq_d1,
            "seq_d2": self.seq_d2,
            "long_mask_d1": self.long_mask_d1,
            "long_mask_d2": self.long_mask_d2,
            "domain_id": self.domain_id,
            "overlap": self.overlap,
            "ob_label": self.ob_label,
            "reject": self.reject,
            "reject_counts": self.reject_counts,
        }


def pack_rows(
    user_ids: list[int],
    seqs_d1: list[list[int]],
    seqs_d2: list[list[int]],
    domain_ids: list[int],
    ob_labels: list[int] | None,
    seq_len: int,
    pad_id: int,
    long_length: int = 7,
) -> PackedDualDomainDataset:
    """Pack parsed rows into dense arrays (protocol of dataset_seq.py:177-250)."""
    n = len(user_ids)
    if ob_labels is None:
        ob_labels = [1] * n

    pool_d1: set[int] = set()
    pool_d2: set[int] = set()
    for s in seqs_d1:
        pool_d1.update(s)
    for s in seqs_d2:
        pool_d2.update(s)

    targets = np.zeros(n, dtype=np.int32)
    overlap = np.zeros(n, dtype=np.int32)
    long_d1 = np.zeros(n, dtype=np.int32)
    long_d2 = np.zeros(n, dtype=np.int32)
    sd1 = np.full((n, seq_len), pad_id, dtype=np.int32)
    sd2 = np.full((n, seq_len), pad_id, dtype=np.int32)
    reject_lists: list[list[int]] = []

    for i in range(n):
        s1 = list(seqs_d1[i])
        s2 = list(seqs_d2[i])
        overlap[i] = 1 if (len(s1) > 0 and len(s2) > 0) else 0
        active = s1 if domain_ids[i] == 0 else s2
        # Reject set = user's full active-domain sequence incl. the target
        # (dataset_seq.py:188 subtracts set(seq) from the pool pre-pop).
        reject_lists.append(sorted(set(active)))
        target = active[-1]
        hist = active[:-1]
        hist = [x for x in hist if x != target]  # dedupe target (d_s.py:194-196)
        targets[i] = target
        if domain_ids[i] == 0:
            s1 = hist
        else:
            s2 = hist
        long_d1[i] = 1 if len(s1) >= long_length else 0
        long_d2[i] = 1 if len(s2) >= long_length else 0
        sd1[i] = seq_pad_trunc(s1, seq_len, pad_id)
        sd2[i] = seq_pad_trunc(s2, seq_len, pad_id)

    p1 = np.array(sorted(pool_d1), dtype=np.int32)
    p2 = np.array(sorted(pool_d2), dtype=np.int32)
    p_width = max(1, len(p1), len(p2))
    pools = np.zeros((2, p_width), dtype=np.int32)
    # Cyclic pad so any index < p_width maps to a valid pool member; sampling
    # only draws indices < pool_sizes[d] anyway.
    if len(p1):
        pools[0] = np.resize(p1, p_width)
    if len(p2):
        pools[1] = np.resize(p2, p_width)

    # Reject sets as *pool positions* (every user item is in its domain pool
    # by construction). Padded with the sentinel p_width, which is past any
    # index the sampler can produce.
    r_width = max(1, max(len(r) for r in reject_lists))
    reject = np.full((n, r_width), p_width, dtype=np.int32)
    reject_counts = np.zeros(n, dtype=np.int32)
    for i, r in enumerate(reject_lists):
        pool = p1 if domain_ids[i] == 0 else p2
        pos = np.searchsorted(pool, np.asarray(r, dtype=np.int32))
        reject[i, : len(r)] = pos
        reject_counts[i] = len(r)

    return PackedDualDomainDataset(
        user=np.asarray(user_ids, dtype=np.int32),
        target=targets,
        seq_d1=sd1,
        seq_d2=sd2,
        long_mask_d1=long_d1,
        long_mask_d2=long_d2,
        domain_id=np.asarray(domain_ids, dtype=np.int32),
        overlap=overlap,
        ob_label=np.asarray(ob_labels, dtype=np.int32),
        reject=reject,
        reject_counts=reject_counts,
        pools=pools,
        pool_sizes=np.array([len(p1), len(p2)], dtype=np.int32),
        pad_id=pad_id,
        seq_len=seq_len,
    )


def read_dual_domain_csv(csv_path: str, with_ob_label: bool = False):
    """Parse an AMID-style dual-domain CSV into python lists: the native
    parser where it loads, else `read_csv_python`."""
    from amid_tpu_torch.data.native import parse_csv_native

    parsed = parse_csv_native(csv_path, with_ob_label)
    if parsed is not None:
        return parsed
    return read_csv_python(csv_path, with_ob_label)


def read_csv_python(csv_path: str, with_ob_label: bool = False):
    """The pure-Python reader: (users, seq_d1, seq_d2, domains, ob_labels)."""
    import csv

    users: list[int] = []
    s1: list[list[int]] = []
    s2: list[list[int]] = []
    dom: list[int] = []
    ob: list[int] = []
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        for row in reader:
            users.append(int(row["user_id"]))
            s1.append(json.loads(row["seq_d1"]))
            s2.append(json.loads(row["seq_d2"]))
            dom.append(int(row["domain_id"]))
            if with_ob_label:
                ob.append(int(row["ob_label"]))
    return users, s1, s2, dom, ob


def load_dual_domain_csv(
    csv_path: str,
    seq_len: int,
    pad_id: int,
    long_length: int = 7,
    with_ob_label: bool = False,
    subdomain: int | None = None,
) -> PackedDualDomainDataset:
    """CSV (columns: user_id, seq_d1, seq_d2, domain_id[, ob_label]) -> packed
    dataset.

    subdomain: when set, keep only rows of that domain — the
    SingleDomainSeqDataset semantics (dataset_seq.py:24-28: rows filtered by
    `domain_id == subdomain`; targets/negatives then come only from that
    domain's sequences and pool).

    Without a subdomain the CSV is parsed and packed in C++ where the native
    library loads (`data/native.py::pack_csv_native`, `pack_rows`'s arrays
    bit for bit)."""
    if subdomain is None:
        from amid_tpu_torch.data.native import pack_csv_native

        ds = pack_csv_native(csv_path, with_ob_label, seq_len, pad_id, long_length)
        if ds is not None:
            return ds
    users, s1, s2, dom, ob = read_dual_domain_csv(csv_path, with_ob_label)
    if subdomain is not None:
        keep = [i for i, d in enumerate(dom) if d == subdomain]
        users = [users[i] for i in keep]
        s1 = [s1[i] for i in keep]
        s2 = [s2[i] for i in keep]
        dom = [dom[i] for i in keep]
        if with_ob_label:
            ob = [ob[i] for i in keep]
    return pack_rows(
        users, s1, s2, dom, ob if with_ob_label else None, seq_len, pad_id, long_length
    )
