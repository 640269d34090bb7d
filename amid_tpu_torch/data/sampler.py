"""Device-side negative sampling — exact uniform over (pool - user items);
the counterpart of `amid_tpu/data/sampler.py::sample_negatives`.

Reference semantics (dataset_seq.py:197-203): negatives are drawn uniformly
from the active domain's item pool minus all of the user's items in that
domain (including the held-out target) — 1 at train, `neg_nums` at eval, per
row. The packed dataset stores each row's user-item *positions in its sorted
domain pool* ("holes", ascending, sentinel-padded — data/packed.py). Sampling
the j-th valid element of pool-minus-holes is the skip-sorted-holes scheme:

    j ~ U[0, pool_size - num_holes)
    idx = j;  for each hole h ascending:  idx += (h <= idx)

The JAX package runs that ascending pass as a loop over the R hole columns.
Hole k (0-based) increments idx exactly when h_k <= j + k, and because real
holes are distinct and ascending, h_k - k is non-decreasing, so the holes
that increment form a prefix and the pass has a closed form:

    idx = j + #{k < num_holes : h_k - k <= j}

which is one `searchsorted` per row over g_k = h_k - k. The sentinel tail
(h = P) is not monotone in g, so it is masked to a value no j reaches; the
literal loop never counts a sentinel either (idx < P always). Draws within a
row are i.i.d. (with replacement), as in the JAX package.

`interleave_corr_seq` builds C2DSR's interleaved views from two sequences
(`train/c2dsr.py`).
"""

from __future__ import annotations

import torch

_NEVER = torch.iinfo(torch.int32).max


def sample_negatives(
    gen: torch.Generator,
    pools: torch.Tensor,  # [2, P] sorted per-domain item pools
    pool_sizes: torch.Tensor,  # [2]
    domain_id: torch.Tensor,  # [B]
    reject: torch.Tensor,  # [B, R] ascending hole positions, sentinel-padded
    num_neg: int,
    reject_counts: torch.Tensor | None = None,  # [B]; derived if None
) -> torch.Tensor:
    """Returns [B, num_neg] int32 item ids, drawn from `gen` (a generator on
    the tensors' device)."""
    b, r = reject.shape
    p = pools.shape[1]
    dev = pools.device
    dom = domain_id.long()
    if reject_counts is None:
        reject_counts = (reject < p).sum(dim=1)

    valid = (pool_sizes.long()[dom] - reject_counts.long()).clamp(min=1)[:, None]  # [B, 1]
    u = torch.rand((b, num_neg), generator=gen, device=dev, dtype=torch.float32)
    j = torch.minimum((u * valid).long(), valid - 1)  # [B, K]

    k = torch.arange(r, device=dev)
    g = torch.where(k[None, :] < reject_counts[:, None], reject.long() - k, _NEVER)
    idx = j + torch.searchsorted(g, j, right=True)
    return pools[dom[:, None], idx].to(torch.int32)


def interleave_corr_seq(real_seq: torch.Tensor, fake_seq: torch.Tensor) -> torch.Tensor:
    """C2DSR corrupted-sequence interleave (dataset_seq.py:276-281):
    [r0, f0, r1, f1, ...] -> [B, 2L]. Used with `sample_negatives(...,
    num_neg=L)` as the fake sequence for the C2DSR contrastive objective."""
    b, l = real_seq.shape
    return torch.stack([real_seq, fake_seq], dim=-1).reshape(b, 2 * l)
