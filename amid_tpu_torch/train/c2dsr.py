"""C2DSR mode: corrupted-sequence views + contrastive infomax objective — the
counterpart of `amid_tpu/train/c2dsr.py`.

Reference surface reproduced (data semantics): DualDomainSeqDatasetC2DSR
(dataset_seq.py:283-441) emits, per row,

* ``corr_seq``     — seq_len items sampled uniformly from the active domain's
                     pool minus the user's items (dataset_seq.py:358,380);
* ``corr_seq_d1``  — generate_corr_seq(padded seq_d1, corr_seq): elementwise
                     interleave [r0, f0, r1, f1, ...] (dataset_seq.py:276-281,
                     382);
* ``corr_seq_d2``  — same with seq_d2 (:383);
* ``all_seq``      — generate_corr_seq(seq_d1, seq_d2) (:384).

As in the JAX package, nothing changes in the packed dataset or loader: the
corrupted items are sampled on the device inside the step with the
hole-skipping sampler of the negatives (`data/sampler.py`, uniform over
pool-minus-user-items, i.i.d. draws), and the interleaves are a stack and a
reshape.

Objective (the C2DSR paper's mutual-information discriminator, Cao et al.,
CIKM'22, built from the pooled tower features; the reference ships no
trainer for it):

    h1, h2   = tower features of the true per-domain sequences
    ha1, ha2 = tower features of ``all_seq`` (the interleaved dual-domain
               view), each through its own tower
    hc1, hc2 = tower features of the corrupted views corr_seq_d1/2

    L_cl = mean[ softplus(-(ha1.h1)) + softplus(hc1.h1)        (domain 1)
               + softplus(-(ha2.h2)) + softplus(hc2.h2) ]      (domain 2)

Enabled with --isC2DSR (+ --cl_w weight); adds two feature passes over views
of length 2L (`ModelConfig.enc_seq_len` doubles so the SASRec position table
covers them). The JAX package gives both view passes one dropout key, so they
draw the same masks; `c2dsr_loss` takes one dropout source per pass
(`ops.rng.StepRandom.views`), seeded alike for the same effect.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from amid_tpu_torch.data.sampler import interleave_corr_seq, sample_negatives


def c2dsr_views(batch: dict, corr: torch.Tensor) -> dict[str, torch.Tensor]:
    """Interleaved views (dataset_seq.py:276-281,382-384): corr is [B, L]
    device-sampled corrupted items."""
    return {
        "corr_seq_d1": interleave_corr_seq(batch["seq_d1"], corr),
        "corr_seq_d2": interleave_corr_seq(batch["seq_d2"], corr),
        "all_seq": interleave_corr_seq(batch["seq_d1"], batch["seq_d2"]),
    }


def sample_corr(gen: torch.Generator, pools, pool_sizes, batch) -> torch.Tensor:
    """Corrupted items: seq_len uniform draws from the active domain pool
    minus the user's items (dataset_seq.py:358,380), from `gen`."""
    return sample_negatives(
        gen, pools, pool_sizes, batch["domain_id"], batch["reject"],
        batch["seq_d1"].shape[1], batch.get("reject_counts"),
    )


def infomax_loss(h1, h2, ha1, ha2, hc1, hc2) -> torch.Tensor:
    """Dot-product-critic MI discriminator (module docstring): BCE-with-
    logits, positives (ha_x, h_x), negatives (hc_x, h_x)."""
    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    pos = F.softplus(-dot(ha1, h1)) + F.softplus(-dot(ha2, h2))
    neg = F.softplus(dot(hc1, h1)) + F.softplus(dot(hc2, h2))
    return torch.mean(pos + neg)


def c2dsr_loss(model, batch, views, h1, h2, rngs) -> torch.Tensor:
    """Encode the interleaved views through the towers (features_only) and
    apply the infomax loss against the true-tower features h1/h2. `all_seq`
    goes into both towers, `corr_seq_d1` into tower 1 and `corr_seq_d2` into
    tower 2; `rngs` are the two passes' dropout sources (read in train mode)."""
    def feats(seq_d1, seq_d2, rng):
        return model({**batch, "seq_d1": seq_d1, "seq_d2": seq_d2},
                     features_only=True, rng=rng)

    ha1, ha2 = feats(views["all_seq"], views["all_seq"], rngs[0])
    hc1, hc2 = feats(views["corr_seq_d1"], views["corr_seq_d2"], rngs[1])
    return infomax_loss(h1, h2, ha1, ha2, hc1, hc2)
