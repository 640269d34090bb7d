"""AMID model assembly — the counterpart of `amid_tpu/models/amid.py`, with
each backbone's placement of the peer message passing as the reference has it:

    GRU4Rec  (model_seq.py:83-113):  table -> [InnerComp] -> GRU towers -> [InterComp]
    SASRec   (model_seq.py:416-443): table -> [InnerComp] -> SASRec towers -> [InterComp]
    BERT4Rec (model_seq.py:277-309): table -> [InnerComp] -> [InterComp] -> BERT towers

then a plain mean over time (pad positions included, model_seq.py:432-434)
and the PredictHead(s). BERT4Rec's key mask is `ids > 0` of the raw
sequence, from `seq_d2` for BOTH towers while `bert_d2_mask_quirk` is on (the
reference's quirk, model_seq.py:286-294), from `seq_d1` for tower 1 when it
is off; it is tiled along time (the whole row repeated) to the length that
InnerComp and InterComp give the encoder's input.

`forward(batch, features_only=True)` returns the pooled user representations
(u_d1, u_d2), the serving entry point and C2DSR's view passes (sequences of
2L; SASRec's position table holds `cfg.enc_seq_len` rows, which C2DSR
doubles, and is sliced to the input's length); the normal forward scores
[target ; negatives] and returns logits_d1/d2 (and, with is_dr, the IPS and
imputation heads' outputs, model_seq.py:436-440) beside u_d1/u_d2.

The item table is one embedding shared by both domains (ids are pre-offset
at data-prep time, model_seq.py:22-29). Lookups go in groups, one kernel
launch each: both sequences of a feature pass, and target with negatives
straight into the [B, 1+K, D] candidate block. `kernels='cuda'` gathers
through the hand-written kernel (`ops.embedding.embedding_gather_many`),
`kernels='torch'` through its plain version (`index_select`); `cfg.kernels`
also reaches the attention core, the pairwise affinity and the prediction
heads.

The model's matmul precision (`ops.precision.resolve_precision`: the JAX
model's `jax.default_matmul_precision` context, from `matmul_precision` and
`use_bf16`) is handed to every module as its `precision` attribute: in
`"bf16"` every product inside the model takes bf16 operands with fp32 sums,
the attention core and the heads included, forward and backward. The losses,
C2DSR's infomax dot and `serve.full_catalog_topk` are outside the model and
stay fp32, as in JAX. `remat` rematerialises SASRec's blocks
(`SasrecEncoder`); the other backbones ignore it, as the JAX package passes
it to SASRec only.

Two optional arguments serve the trainer. `rng` is the step's
`ops.rng.StepRandom`, the source of train-mode dropout. `lazy_rows=(uids,
rows)` redirects every lookup to `rows[searchsorted(uids, ids)]` (the
counterpart of `amid_tpu/parallel/context.py::lazy_rows` and the redirect in
`parallel/embedding.py::embedding_lookup`): `uids` are the step's sorted
unique ids and `rows` the gathered table rows, the differentiated leaf of the
lazy table Adam, so the table itself takes no gradient. A group of lookups
shares one `searchsorted`.

On a mesh (inside `parallel.context.spmd`), as the JAX package's hooks
(`amid_tpu/models/amid.py::_item_table`, `_features`): the table parameter
holds this rank's `item_table_size // model_shards` rows (the trainer cuts
them, `parallel/distributed.py::shard_global`; a table the model axis does
not divide is refused there, where the JAX package's shard_map floors it
and loses the last rows), and every lookup goes through
`parallel.embedding.embedding_lookup`: the sharded lookup, unless the step
hands the model lazy rows, which are whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from amid_tpu_torch.config import BACKBONES, KERNEL_CHOICES, ModelConfig
from amid_tpu_torch.models.comp import InnerComp, InterComp
from amid_tpu_torch.models.encoders import Bert4RecEncoder, GruEncoder, SasrecEncoder
from amid_tpu_torch.models.heads import PredictHead
from amid_tpu_torch.ops.embedding import embedding_gather_many, embedding_gather_many_plain
from amid_tpu_torch.ops.precision import resolve_precision
from amid_tpu_torch.ops.torch_compat import torch_embedding_init_
from amid_tpu_torch.parallel.embedding import embedding_lookup

Batch = dict[str, Any]


class AMIDModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {cfg.backbone!r}; one of {BACKBONES}")
        if cfg.kernels not in ("torch", "cuda"):
            raise ValueError(
                f"kernels must be resolved to 'torch' or 'cuda' (build_model "
                f"resolves 'auto'); got {cfg.kernels!r}"
            )
        self.cfg = cfg
        self.precision = mode = resolve_precision(cfg)
        d, quirk, kernels = cfg.emb_dim, cfg.comp_broadcast_quirk, cfg.kernels
        self.item_embedding = nn.Parameter(torch.empty(cfg.item_table_size, d))
        if cfg.is_inc:
            self.inc_d1 = InnerComp(d, cfg.batch_size, cfg.ts1, quirk, kernels, mode)
            self.inc_d2 = InnerComp(d, cfg.batch_size, cfg.ts1, quirk, kernels, mode)
        for name in ("enc_d1", "enc_d2"):
            self.add_module(name, _encoder(cfg, mode))
        if cfg.is_itc:
            self.itc_d1 = InterComp(d, cfg.batch_size, cfg.ts2, quirk, kernels, mode)
            self.itc_d2 = InterComp(d, cfg.batch_size, cfg.ts2, quirk, kernels, mode)
        self.predict = PredictHead(d, cfg.hid_dim, kernels, mode)
        if cfg.is_dr:
            self.predict_ips = PredictHead(d, cfg.hid_dim, kernels, mode)
            self.predict_gfunc = PredictHead(d, cfg.hid_dim, kernels, mode)

    def reset_parameters(self, gen: torch.Generator) -> None:
        torch_embedding_init_(self.item_embedding, gen)
        for m in self.children():
            if isinstance(m, (InnerComp, InterComp)):
                m.message.reset_parameters(gen)
            else:
                m.reset_parameters(gen)

    def lookup(self, ids_list, lazy_rows=None, concat: bool = False):
        """Rows of the item table for a group of id arrays, in one launch:
        a tuple of [..., D] tensors, or with `concat` one [B, P, D] block of
        every array's rows per user side by side."""
        table = self.item_embedding
        ids_list = [torch.as_tensor(ids, device=table.device) for ids in ids_list]
        if lazy_rows is not None:
            uids, table = lazy_rows
            if concat:  # one id array per user, one segment
                users = ids_list[0].shape[0]
                ids = torch.cat([ids.reshape(users, -1) for ids in ids_list], dim=1)
                ids_list = [torch.searchsorted(uids, ids.to(uids.dtype))]
            else:
                flat = torch.cat([ids.reshape(-1) for ids in ids_list])
                pos = torch.searchsorted(uids, flat.to(uids.dtype))
                ids_list = [p.view(ids.shape) for p, ids in
                            zip(pos.split([ids.numel() for ids in ids_list]), ids_list)]
        gather = (embedding_gather_many if self.cfg.kernels == "cuda"
                  else embedding_gather_many_plain)
        return embedding_lookup(table, ids_list, gather, concat, lazy=lazy_rows is not None)

    def features(self, batch: Batch, rng=None,
                 lazy_rows=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Pooled per-domain user representations (u_feat_enhance_d1/d2)."""
        cfg = self.cfg
        seq_d1, seq_d2 = self.lookup((batch["seq_d1"], batch["seq_d2"]), lazy_rows)  # [B, L, D]
        if cfg.is_inc:
            seq_d1, seq_d2 = self.inc_d1(seq_d1), self.inc_d2(seq_d2)
        if cfg.backbone == "bert4rec":
            seq_d1, seq_d2 = self._apply_itc(seq_d1, seq_d2)
            mask_d1, mask_d2 = self._bert_key_masks(batch, seq_d1.shape[1], seq_d1.device)
            seq_d1, seq_d2 = self.enc_d1(seq_d1, mask_d1, rng), self.enc_d2(seq_d2, mask_d2, rng)
        else:
            seq_d1, seq_d2 = self.enc_d1(seq_d1, rng), self.enc_d2(seq_d2, rng)
            seq_d1, seq_d2 = self._apply_itc(seq_d1, seq_d2)
        return seq_d1.mean(dim=1), seq_d2.mean(dim=1)

    def _apply_itc(self, seq_d1, seq_d2):
        if not self.cfg.is_itc:
            return seq_d1, seq_d2
        return self.itc_d1(seq_d1, seq_d2), self.itc_d2(seq_d2, seq_d1)

    def _bert_key_masks(self, batch: Batch, t_enc: int, device):
        """The key masks [B, t_enc] of both BERT towers: `ids > 0` of the raw
        sequences (seq_d2 for both under the d2-mask quirk), each row repeated
        whole along time to the encoder's length (jnp.tile, not interleaved)."""
        src_d2 = torch.as_tensor(batch["seq_d2"], device=device)
        src_d1 = (src_d2 if self.cfg.bert_d2_mask_quirk
                  else torch.as_tensor(batch["seq_d1"], device=device))
        reps = t_enc // src_d2.shape[1]  # 2 with InnerComp, doubled again with InterComp
        return (src_d1 > 0).repeat(1, reps), (src_d2 > 0).repeat(1, reps)

    def forward(self, batch: Batch, features_only: bool = False, rng=None,
                lazy_rows=None):
        u_d1, u_d2 = self.features(batch, rng, lazy_rows)
        if features_only:
            return u_d1, u_d2
        cand = self.lookup((batch["target"], batch["neg_samples"]), lazy_rows,
                           concat=True)  # [B, 1+K, D]
        out = {"u_d1": u_d1, "u_d2": u_d2}
        out["logits_d1"], out["logits_d2"] = self.predict(u_d1, u_d2, cand)
        if self.cfg.is_dr:
            out["ips_d1"], out["ips_d2"] = self.predict_ips(u_d1, u_d2, cand)
            out["gfunc_d1"], out["gfunc_d2"] = self.predict_gfunc(u_d1, u_d2, cand)
        return out


def _encoder(cfg: ModelConfig, mode: str) -> nn.Module:
    """One tower of the configured backbone, in precision `mode`."""
    if cfg.backbone == "gru4rec":
        return GruEncoder(cfg.emb_dim, cfg.emb_dim, mode)
    if cfg.backbone == "bert4rec":
        return Bert4RecEncoder(cfg.emb_dim, cfg.bert_blocks, cfg.bert_heads, cfg.bert_ff_dim,
                               cfg.bert_dropout, cfg.kernels, mode)
    return SasrecEncoder(cfg.emb_dim, cfg.enc_seq_len, cfg.sasrec_blocks, cfg.sasrec_heads,
                         cfg.sasrec_dropout, cfg.kernels, mode, cfg.remat)


def head_width(cfg: ModelConfig):
    """The attention head width dh of `cfg`'s encoders; None for GRU4Rec."""
    if cfg.backbone == "gru4rec":
        return None
    heads = cfg.bert_heads if cfg.backbone == "bert4rec" else cfg.sasrec_heads
    return cfg.emb_dim // heads


def check_kernels_fit(cfg: ModelConfig) -> None:
    """Raises, before any forward, if a kernel of a kernels='cuda' model of
    `cfg` cannot take a shape the model hands it, naming the limit and
    `--kernels torch`:
    * K1 (attention; not GRU4Rec): a head width above the long paths' 256
      (`ops.attention.MAX_LONG_HEAD_DIM`, in fp32 and bf16; every width up
      to it runs at a template width), or the longest attention call (the
      encoder at L, or at 2L on C2DSR's views) beyond the long forward's or
      backward's limit at that width (`long_forward_max_t`,
      `long_backward_max_t_at`; the one-head kernels hand longer or wider
      shapes to the long paths);
    * K6/K7 (the pairwise affinity, with a comp and
      `comp_broadcast_quirk=False`): a row wider than `ops.affinity.MAX_D`
      (any N and any narrower D run).
    K5 (the scoring head) takes every D and H (`ops.scoring.scoring_kernel`).
    Binds the attention kernels."""
    from amid_tpu_torch.ops import affinity as affinity_ops
    from amid_tpu_torch.ops.attention import (
        MAX_LONG_HEAD_DIM, long_backward_max_t_at, long_forward_max_t, long_head_dim,
    )

    way_out = "so kernels='cuda' cannot run it (--kernels torch, kernels='torch', can)"
    dh = head_width(cfg)
    if dh is not None:
        t = cfg.enc_seq_len
        limit = min(long_forward_max_t(), long_backward_max_t_at(dh))
        if long_head_dim(dh) is None or t > limit:
            parts = [name for name, on in (("InnerComp", cfg.is_inc), ("InterComp", cfg.is_itc),
                                           ("C2DSR", cfg.is_c2dsr)) if on]
            raise ValueError(
                f"{cfg.backbone} at seq_len={cfg.seq_len} with {', '.join(parts) or 'no comp'} "
                f"attends over T={t} at head width dh={dh}; the attention kernels take head "
                f"widths 1 to {MAX_LONG_HEAD_DIM} (fp32 and bf16) and T<={limit}, {way_out}")
    d = cfg.emb_dim
    if (cfg.is_inc or cfg.is_itc) and not cfg.comp_broadcast_quirk and d > affinity_ops.MAX_D:
        raise ValueError(f"the pairwise affinity at --emb_dim {d}: the affinity kernels take "
                         f"D from 1 to {affinity_ops.MAX_D}, {way_out}")


def resolve_device(device=None) -> torch.device:
    """`device`, or `cuda` when none is given; never the CPU unless asked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; amid_tpu_torch runs on cuda unless "
            "the caller passes device='cpu'"
        )
    return torch.device("cuda")


def build_model(cfg: ModelConfig, device=None, seed: int = 0) -> AMIDModel:
    """Builds the model on `device` (default `cuda`), initialised from a
    `torch.Generator` on that device seeded with `seed`, in eval mode.

    kernels='auto' resolves to 'cuda' on a CUDA device and 'torch' on the
    CPU; 'cuda' on a CPU device is refused, and so is a configuration whose
    shapes some kernel cannot take (`check_kernels_fit`)."""
    device = resolve_device(device)
    if cfg.kernels not in KERNEL_CHOICES:
        raise ValueError(f"kernels must be one of {KERNEL_CHOICES}; got {cfg.kernels!r}")
    kernels = cfg.kernels
    if kernels == "auto":
        kernels = "cuda" if device.type == "cuda" else "torch"
    if kernels == "cuda" and device.type != "cuda":
        raise ValueError(f"kernels='cuda' needs a CUDA device; got {device}")
    cfg = dataclasses.replace(cfg, kernels=kernels)
    if kernels == "cuda":
        check_kernels_fit(cfg)
    with torch.device("meta"):
        model = AMIDModel(cfg)
    model.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        model.reset_parameters(gen)
    return model.eval()
