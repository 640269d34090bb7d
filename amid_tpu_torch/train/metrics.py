"""Leave-one-out ranking metrics: HR@k, NDCG@k, MRR, overlap-bucketed — the
counterpart of `amid_tpu/train/metrics.py`.

Reference protocol (utils.py:296-313, train_sr.py:113-128): the positive sits
in column 0 of a [rows, 1+neg] score matrix; after `pred[:, 0] -= 1e-7` the
rank of the positive is its position in a descending argsort with
index-order tie-breaks. Since column 0 is the first index, its rank equals
the count of scores strictly greater than `pred[0] - 1e-7`:

    rank = sum_j>=1 [ pred[j] > pred[0] - 1e-7 ]

which is computed on device in O(neg) with no sort (the reference does a
double argsort on host numpy). Bucket routing (per-domain, overlap /
non-overlap — utils.py:21-68) happens on the tiny [rows] rank vector.
"""

from __future__ import annotations

import numpy as np
import torch

FIX_VALUE = 1e-7  # tie-break (train_sr.py:42)
TOP_KS = (1, 5, 10)


def positive_ranks(pred: torch.Tensor, fix: bool = True) -> torch.Tensor:
    """pred: [B, 1+K] scores, positive in column 0 -> int32 ranks [B].

    fix=True applies the reference's 1e-7 tie-break. The reference applies it
    only to the full-domain lists, NOT the overlap/non-overlap buckets
    (train_sr.py:114-127) — callers pass fix=False for the bucketed ranks.
    """
    pos = pred[:, 0] - (FIX_VALUE if fix else 0.0)
    return (pred[:, 1:] > pos[:, None]).sum(dim=1).to(torch.int32)


def rank_metrics(ranks: np.ndarray) -> dict[str, float]:
    """HIT@{1,5,10}, NDCG@{1,5,10}, MRR from integer ranks (utils.py:303-313)."""
    out: dict[str, float] = {}
    if ranks.size == 0:
        for k in TOP_KS:
            out[f"hit_{k}"] = 0.0
            out[f"ndcg_{k}"] = 0.0
        out["mrr"] = 0.0
        return out
    r = ranks.astype(np.float64)
    for k in TOP_KS:
        hit = r < k
        out[f"hit_{k}"] = float(hit.mean())
        out[f"ndcg_{k}"] = float((hit / np.log2(r + 2.0)).mean())
    out["mrr"] = float((1.0 / (r + 1.0)).mean())
    return out


class RankAccumulator:
    """Accumulates per-row ranks into (domain x overlap) buckets across eval
    batches; finalizes to the reference's metric dict."""

    def __init__(self, overlap_eval: bool) -> None:
        self.overlap_eval = overlap_eval
        self.ranks_fixed: list[np.ndarray] = []
        self.ranks_raw: list[np.ndarray] = []
        self.domains: list[np.ndarray] = []
        self.overlaps: list[np.ndarray] = []

    def add(self, ranks_fixed, ranks_raw, domain_id, overlap) -> None:
        # store as-is (device tensors or numpy arrays, one kind per argument)
        # — the host fetch is deferred to finalize() so eval batches pipeline
        # without per-batch syncs
        self.ranks_fixed.append(ranks_fixed)
        self.ranks_raw.append(ranks_raw)
        self.domains.append(domain_id)
        self.overlaps.append(overlap)

    def finalize(self) -> dict[str, float]:
        def cat(xs):
            if not xs:
                return np.zeros(0, np.int32)
            if isinstance(xs[0], torch.Tensor):
                return torch.cat(xs).cpu().numpy()  # one fetch for the pass
            return np.concatenate([np.asarray(x) for x in xs])

        rf, rr = cat(self.ranks_fixed), cat(self.ranks_raw)
        dom, ov = cat(self.domains), cat(self.overlaps)
        out: dict[str, float] = {}
        for d, tag in ((0, "d1"), (1, "d2")):
            sel = dom == d
            for k, v in rank_metrics(rf[sel]).items():
                out[f"{k}_{tag}"] = v
            if self.overlap_eval:
                for o, otag in ((1, "ov"), (0, "no")):
                    s2 = sel & (ov == o)
                    # bucketed metrics skip the tie-break (train_sr.py:120-123)
                    for k, v in rank_metrics(rr[s2]).items():
                        out[f"{k}_{tag}_{otag}"] = v
        return out
