"""Configuration — the port's copy of `amid_tpu/config.py`: the dataclasses
(`ModelConfig`, `DataConfig`, `MeshConfig`, `TrainConfig`) and `parse_cli`.

Field names, defaults and properties are the reference's own, so a config can
be moved between the two packages field by field. These differ in what they
accept:

* `kernels` takes `auto|torch|cuda`. `cuda` routes every op that has a
  hand-written kernel through it, at every shape: the SASRec attention core
  (`ops.attention.fused_attention`, forward and backward), the embedding
  lookups (`ops.embedding.embedding_gather`), the prediction heads
  (`ops.scoring.scoring_head`), the pairwise-mode affinity
  (`ops.affinity.max_affinity`: bf16 inputs, where `torch` computes fp32) and
  the lazy table Adam's write-back (`ops.scatter`). `torch` uses the plain
  PyTorch versions; `auto` means `cuda` on a CUDA device and `torch` on the
  CPU (resolved by `build_model`).
* `use_bf16` and `matmul_precision` give the model's matmul precision as
  in the JAX package (`ops.precision.resolve_precision`): `"bfloat16"`
  (or `use_bf16=True` with no `matmul_precision`) runs every product inside
  the model on bf16 operands with fp32 sums, the kernels' bf16-operand
  builds included; `""`, `"highest"` and `"float32"` run full fp32 with
  TF32 off. `remat=True` rematerialises SASRec's blocks in the backward
  (the other backbones ignore it, as in the JAX package).
* `DataConfig.data_root` defaults to the relative directory `reference`; the
  caller names where the CSVs are.
* `TrainConfig`'s checkpoint fields (`checkpoint`, `checkpoint_keep`,
  `checkpoint_every`, `checkpoint_async`, `checkpoint_payload`, `resume`),
  `nan_policy`, `profile_steps` and the fast loops (`fast_train`,
  `fast_eval`) act as in the JAX package, with its defaults, and so do the
  mesh fields (`use_mesh`, `mesh_impl`, `mesh`: `parallel/`, a rank of the
  `torch.distributed` world where the JAX package has a device).

`parse_cli` takes the reference-style flags of the JAX package's `parse_cli`
with the same defaults and builds the same `TrainConfig`, field by field.
What differs: `--kernels` is checked against `auto|torch|cuda`;
`--data_root` defaults to `reference`; `--device` (not a config field: see
`parse_cli_with_device`) names the device, the card when absent; `--model`
takes the three backbones of `BACKBONES` in any case and raises
`ValueError` on another name (the JAX package raises it when the model is
built); `--distributed True` joins the `torch.distributed` world before
anything else (`parallel.distributed.initialize_distributed`: torchrun's
environment, or `--coordinator host:port --num_processes N --process_id I`;
NCCL on the card, gloo with `--device cpu`) and sets `use_mesh`, as
`--mesh True`, `--data_axis` and `--model_axis` do; `--bf16`, `--remat` and
`--matmul_precision` fill their fields, which the model reads.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

# Reference hard-coded vocab constants (train_sr.py:447-450); the table is
# doubled "for pad id" (train_sr.py:456-457).
REF_USER_LENGTH = 895510
REF_ITEM_LENGTH = 447410

KERNEL_CHOICES = ("auto", "torch", "cuda")
BACKBONES = ("sasrec", "bert4rec", "gru4rec")  # --model, lowercased


@dataclass
class ModelConfig:
    """Model hyper-parameters (reference model_seq.py:56-58 etc.)."""

    backbone: str = "sasrec"  # one of BACKBONES
    emb_dim: int = 128
    hid_dim: int = 32
    seq_len: int = 20  # 20 for mybank, 150 for amazon (train_sr.py:366)
    batch_size: int = 256  # InterComp ties a weight to this (model_seq.py:457)
    is_inc: bool = False
    is_itc: bool = False
    ts1: float = 0.5  # InnerComp hard threshold (model_seq.py:467)
    ts2: float = 0.5  # InterComp hard threshold (model_seq.py:492)
    is_dr: bool = False  # doubly-robust heads (model_seq.py:412-414)
    is_c2dsr: bool = False
    item_length: int = REF_ITEM_LENGTH
    user_length: int = REF_USER_LENGTH
    sasrec_blocks: int = 2
    sasrec_heads: int = 8
    sasrec_dropout: float = 0.5
    bert_blocks: int = 2
    bert_heads: int = 4
    bert_ff_dim: int = 512
    bert_dropout: float = 0.1
    # True reproduces the reference's degenerate broadcast affinity
    # (diagonal affinity, one shared message; see models/comp.py).
    comp_broadcast_quirk: bool = True
    bert_d2_mask_quirk: bool = True
    use_bf16: bool = False
    matmul_precision: str = ""
    remat: bool = False
    kernels: str = "auto"

    @property
    def item_table_size(self) -> int:
        return self.item_length * 2

    @property
    def user_table_size(self) -> int:
        return self.user_length * 2

    @property
    def pad_id(self) -> int:
        # pad_id = item_length + 1 (train_sr.py:451)
        return self.item_length + 1

    @property
    def enc_seq_len(self) -> int:
        """The longest encoder input: `encoder_length` at L, or at 2L on the
        C2DSR interleaved views."""
        return encoder_length(self, self.seq_len * (2 if self.is_c2dsr else 1))


def encoder_length(cfg: ModelConfig, seq_len: int) -> int:
    """The length of the sequence an encoder of `cfg` sees for inputs of
    `seq_len`: doubled by InnerComp's concat along time (model_seq.py:66,471)
    and, before BERT4Rec's encoder, by InterComp's."""
    return seq_len * (2 if cfg.is_inc else 1) * (
        2 if cfg.backbone == "bert4rec" and cfg.is_itc else 1)


@dataclass
class DataConfig:
    """Dataset selection + leave-one-out protocol constants.

    Mirrors reference path assembly (train_sr.py:451: csv =
    `{ds}_dataset/{dm}_train{int(ratio*100)}.csv`) and sampling protocol
    (dataset_seq.py:177-250).
    """

    dataset_type: str = "amazon"
    domain_type: str = "cloth_sport"
    data_root: str = "reference"
    overlap_ratio: float = 0.25
    seq_len: int = 20
    neg_nums: int = 199  # eval negatives (999 in run.sh)
    long_length: int = 7  # long-tail threshold (dataset_seq.py:13)
    pad_id: int = REF_ITEM_LENGTH + 1

    def train_csv(self) -> str:
        return (
            f"{self.data_root}/{self.dataset_type}_dataset/"
            f"{self.domain_type}_train{int(self.overlap_ratio * 100)}.csv"
        )

    def train_dr_csv(self) -> str:
        return (
            f"{self.data_root}/{self.dataset_type}_dataset/"
            f"{self.domain_type}_train{int(self.overlap_ratio * 100)}_DR.csv"
        )

    def test_csv(self) -> str:
        return (
            f"{self.data_root}/{self.dataset_type}_dataset/"
            f"{self.domain_type}_test.csv"
        )


@dataclass
class MeshConfig:
    """Mesh layout (`data` axis for batch parallelism, `model` axis for
    row-sharded tables) over the ranks of the world (`parallel/mesh.py`)."""

    data_axis: int = -1  # -1: all remaining devices
    model_axis: int = 1

    def axis_sizes(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model_axis)
        if n_devices % model != 0:
            raise ValueError(f"n_devices={n_devices} not divisible by model={model}")
        data = self.data_axis if self.data_axis > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} != n_devices {n_devices}")
        return data, model


@dataclass
class TrainConfig:
    """Training loop configuration (reference defaults: train_sr.py:360-389)."""

    epochs: int = 50
    lr: float = 5e-4
    lr2: float = 0.01  # DR phase-B lr multiplier: optimizer2 lr = lr*lr2 (train_sr_dr.py:669)
    dr_e_w: float = 0.1  # weight on loss_dr_e in phase A (train_sr_dr.py:221)
    seeds: int = 5  # 5-seed protocol (train_sr.py:439)
    seed_offset: int = 0  # first seed index
    overlap_eval: bool = False  # bucket metrics by overlap users (train_sr.py:75)
    model_dir: str = "model/"
    log_every: int = 20  # log train loss every N steps (train_sr.py:218)
    checkpoint: bool = True  # save under model_dir/checkpoint/seed{seed} (train/checkpoint.py)
    checkpoint_keep: int = 1
    checkpoint_every: int = 10
    checkpoint_async: bool = True
    checkpoint_payload: str = "full"
    profile_steps: int = 0  # >0: trace steps 1..N of epoch 0 into model_dir/profile
    resume: bool = False  # restore the latest checkpoint and continue after it
    subdomain: int = -1  # >=0: single-domain training (dataset_seq.py:24-28)
    # Failure detection: on a non-finite train loss "halt" raises, "restore"
    # rolls back to the last checkpoint (in place), "ignore" logs and
    # continues (as "restore" does with no checkpoint).
    nan_policy: str = "restore"
    use_mesh: bool = False  # train on the data x model mesh (parallel/)
    mesh_impl: str = "gspmd"
    # Sparse embedding updates (train/lazy.py): only touched table rows'
    # params/moments move; lazy-Adam semantics (untouched rows' moments don't
    # decay). Covers both DR phases (optimizer2 gets its own per-row moments).
    lazy_table_adam: bool = False
    cl_w: float = 0.1  # C2DSR contrastive weight (train/c2dsr.py; active when model.is_c2dsr)
    eval_batch_drop_last: bool = True  # reference val loader drop_last=True (train_sr.py:455)
    fast_eval: bool = True  # the stacked evaluation pass (a CUDA graph on the card)
    fast_train: bool = True  # the device-resident chunked train loop (CUDA graphs)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def __post_init__(self) -> None:
        # Keep seq_len / pad_id consistent between sub-configs.
        self.data.seq_len = self.model.seq_len
        self.data.pad_id = self.model.pad_id

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return v.strip().lower() in ("1", "true", "yes", "y", "t")


def _add_reference_flags(p: argparse.ArgumentParser) -> None:
    """Reference-compatible CLI surface (train_sr.py:359-389), flag for flag
    the JAX package's."""
    p.add_argument("--epoch", type=int, default=50)
    p.add_argument("--bs", type=int, default=256)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr2", type=float, default=0.01)
    p.add_argument("--emb_dim", type=int, default=128)
    p.add_argument("--hid_dim", type=int, default=32)
    p.add_argument("--seq_len", type=int, default=20)
    p.add_argument("--long_length", type=int, default=7)
    p.add_argument("--neg_nums", type=int, default=199)
    p.add_argument("--overlap_ratio", type=float, default=0.5)
    p.add_argument("-md", "--model-dir", type=str, default="model/")
    p.add_argument("--model", type=str, default="sasrec")
    p.add_argument("-ds", "--dataset_type", type=str, default="amazon")
    p.add_argument("-dm", "--domain_type", type=str, default="movie_book")
    # Real booleans (the reference's `type=bool` made "--overlap False" truthy).
    p.add_argument("--isInC", type=_parse_bool, default=False)
    p.add_argument("--isItC", type=_parse_bool, default=False)
    p.add_argument("--ts1", type=float, default=0.5)
    p.add_argument("--ts2", type=float, default=0.5)
    p.add_argument("--comp_broadcast_quirk", type=_parse_bool, default=True,
                   help="True (default): reproduce the reference's degenerate "
                        "broadcast affinity (shared per-batch message); "
                        "False: idealized all-pairs affinity")
    p.add_argument("--overlap", type=_parse_bool, default=False)
    p.add_argument("--isDR", type=_parse_bool, default=False)
    p.add_argument("--dr_e_w", type=float, default=0.1)
    p.add_argument("--isC2DSR", type=_parse_bool, default=False,
                   help="corrupted-sequence contrastive mode "
                        "(dataset_seq.py:283-441 semantics, train/c2dsr.py)")
    p.add_argument("--cl_w", type=float, default=0.1,
                   help="C2DSR contrastive loss weight")
    p.add_argument("--data_root", type=str, default="reference")
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--seed_offset", type=int, default=0,
                   help="first seed index; seeds run in "
                        "[seed_offset, seed_offset+seeds)")
    p.add_argument("--kernels", type=str, default="auto", choices=KERNEL_CHOICES,
                   help="cuda: the hand-written kernels; torch: their plain "
                        "PyTorch versions; auto: cuda on a card, torch on the CPU")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; absent: cuda (an error without a card), "
                        "never the CPU unless 'cpu' is given")
    p.add_argument("--remat", type=_parse_bool, default=False,
                   help="rematerialize SASRec's blocks in the backward "
                        "(activation memory <-> recompute)")
    p.add_argument("--matmul_precision", type=str, default="",
                   choices=["", "bfloat16", "highest", "float32"],
                   help="matmul precision inside the model: 'bfloat16' takes bf16 "
                        "operands with fp32 sums; the others full fp32 with TF32 off")
    p.add_argument("--profile_steps", type=int, default=0)
    p.add_argument("--bf16", type=_parse_bool, default=False,
                   help="bf16-operand products inside the model where "
                        "--matmul_precision is not given")
    p.add_argument("--lazy_table_adam", type=_parse_bool, default=False)
    p.add_argument("--fast_eval", type=_parse_bool, default=True,
                   help="device-resident eval pass (a CUDA graph a batch)")
    p.add_argument("--fast_train", type=_parse_bool, default=True,
                   help="device-resident chunked train loop (a CUDA graph a step)")
    p.add_argument("--checkpoint", type=_parse_bool, default=True)
    p.add_argument("--checkpoint_async", type=_parse_bool, default=True)
    p.add_argument("--checkpoint_payload", type=str, default="full",
                   choices=["full", "bf16_moments", "params_only"])
    p.add_argument("--resume", type=_parse_bool, default=False)
    p.add_argument("--subdomain", type=int, default=-1,
                   help=">=0: single-domain mode — keep only rows of this "
                        "domain (reference SingleDomainSeqDataset)")
    p.add_argument("--data_axis", type=int, default=-1,
                   help="data-parallel axis size (-1: the ranks left); sets --mesh")
    p.add_argument("--model_axis", type=int, default=1,
                   help="model axis size: the item table's rows sharded over it")
    p.add_argument("--mesh", type=_parse_bool, default=False,
                   help="train on the data x model mesh of the world's ranks")
    p.add_argument("--mesh_impl", type=str, default="gspmd",
                   choices=("gspmd", "shard_map"),
                   help="gspmd: the single-process function of the global batch; "
                        "shard_map: per-shard random streams, dense Adam, per step")
    # Multi-node launch (parallel/distributed.py): every rank runs this same
    # CLI (torchrun, or one process a rank with the three flags below).
    p.add_argument("--distributed", type=_parse_bool, default=False,
                   help="join the torch.distributed world before training "
                        "(implies --mesh True)")
    p.add_argument("--coordinator", type=str, default="",
                   help="rank 0's address host:port (empty: torchrun's environment)")
    p.add_argument("--num_processes", type=int, default=-1)
    p.add_argument("--process_id", type=int, default=-1)


def parse_cli_with_device(
    argv: Optional[list[str]] = None, is_dr: bool = False
) -> tuple[TrainConfig, Optional[str]]:
    """(TrainConfig, device) from reference-style CLI flags; device is None
    when `--device` is absent, which every entry point reads as the card."""
    p = argparse.ArgumentParser(description="amid_tpu_torch trainer")
    _add_reference_flags(p)
    a = p.parse_args(argv)
    if a.distributed:
        from amid_tpu_torch.parallel.distributed import initialize_distributed

        initialize_distributed(
            coordinator_address=a.coordinator or None,
            num_processes=a.num_processes if a.num_processes > 0 else None,
            process_id=a.process_id if a.process_id >= 0 else None,
            device=a.device,
        )
    if a.model.lower() not in BACKBONES:
        raise ValueError(f"unknown backbone {a.model.lower()!r} (--model {a.model}); "
                         f"one of {BACKBONES}")
    model = ModelConfig(
        backbone=a.model.lower(),
        emb_dim=a.emb_dim,
        hid_dim=a.hid_dim,
        seq_len=a.seq_len,
        batch_size=a.bs,
        is_inc=a.isInC,
        is_itc=a.isItC,
        ts1=a.ts1,
        ts2=a.ts2,
        comp_broadcast_quirk=a.comp_broadcast_quirk,
        is_dr=a.isDR or is_dr,
        is_c2dsr=a.isC2DSR,
        kernels=a.kernels,
        use_bf16=a.bf16,
        matmul_precision=a.matmul_precision,
        remat=a.remat,
    )
    data = DataConfig(
        dataset_type=a.dataset_type,
        domain_type=a.domain_type,
        data_root=a.data_root,
        overlap_ratio=a.overlap_ratio,
        seq_len=a.seq_len,
        neg_nums=a.neg_nums,
        long_length=a.long_length,
    )
    cfg = TrainConfig(
        epochs=a.epoch,
        lr=a.lr,
        lr2=a.lr2,
        dr_e_w=a.dr_e_w,
        seeds=a.seeds,
        seed_offset=a.seed_offset,
        overlap_eval=a.overlap,
        model_dir=a.model_dir,
        profile_steps=a.profile_steps,
        resume=a.resume,
        subdomain=a.subdomain,
        lazy_table_adam=a.lazy_table_adam,
        fast_eval=a.fast_eval,
        fast_train=a.fast_train,
        cl_w=a.cl_w,
        checkpoint=a.checkpoint,
        checkpoint_async=a.checkpoint_async,
        checkpoint_payload=a.checkpoint_payload,
        use_mesh=a.mesh or a.model_axis != 1 or a.data_axis > 0 or a.distributed,
        mesh_impl=a.mesh_impl,
        model=model,
        data=data,
        mesh=MeshConfig(data_axis=a.data_axis, model_axis=a.model_axis),
    )
    return cfg, a.device


def parse_cli(argv: Optional[list[str]] = None, is_dr: bool = False) -> TrainConfig:
    """Build a TrainConfig from reference-style CLI flags."""
    return parse_cli_with_device(argv, is_dr)[0]
