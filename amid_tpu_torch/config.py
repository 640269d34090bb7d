"""Configuration — the port's copy of `amid_tpu/config.py`'s dataclasses
(`ModelConfig`, `DataConfig`, `MeshConfig`, `TrainConfig`).

Field names, defaults and properties are the reference's own, so a config can
be moved between the two packages field by field. These differ in what they
accept:

* `kernels` takes `auto|torch|cuda`. `cuda` sends the SASRec attention core
  through the hand-written kernel (`ops.attention.fused_attention`) at every
  sequence length; `torch` uses the plain PyTorch version; `auto` means `cuda`
  on a CUDA device and `torch` on the CPU (resolved by `build_model`).
* `use_bf16`, `matmul_precision` and `remat` are kept for field parity but
  the port runs in fp32 only and does not read them.
* `DataConfig.data_root` defaults to the relative directory `reference`; the
  caller names where the CSVs are.
* `TrainConfig` keeps the mesh, fast-loop, checkpoint, resume and profile
  fields so configs read the same; `train.loop.run_seed` raises
  `NotImplementedError` naming the field when one asks for a part that is not
  ported yet (`use_mesh`, `fast_train`, `fast_eval`, `checkpoint`, `resume`,
  `profile_steps`).

`parse_cli` arrives with the CLIs.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

# Reference hard-coded vocab constants (train_sr.py:447-450); the table is
# doubled "for pad id" (train_sr.py:456-457).
REF_USER_LENGTH = 895510
REF_ITEM_LENGTH = 447410

KERNEL_CHOICES = ("auto", "torch", "cuda")


@dataclass
class ModelConfig:
    """Model hyper-parameters (reference model_seq.py:56-58 etc.)."""

    backbone: str = "sasrec"  # this slice ports "sasrec"
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
        """Encoder input length: doubled by InnerComp's concat along time
        (model_seq.py:66,471) and by the C2DSR interleaved views."""
        mult = (2 if self.is_inc else 1) * (2 if self.is_c2dsr else 1)
        return self.seq_len * mult


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
    """Device mesh layout of the JAX package (`data` axis for batch
    parallelism, `model` axis for row-sharded tables); read by nothing in the
    port until the parallel layer is ported."""

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
    checkpoint: bool = True  # not ported yet: run_seed raises when set
    checkpoint_keep: int = 1
    checkpoint_every: int = 10
    checkpoint_async: bool = True
    checkpoint_payload: str = "full"
    profile_steps: int = 0  # not ported yet: run_seed raises when > 0
    resume: bool = False  # not ported yet: run_seed raises when set
    subdomain: int = -1  # >=0: single-domain training (dataset_seq.py:24-28)
    # Failure detection: on a non-finite train loss "halt" raises, "ignore"
    # and "restore" log and continue (the checkpoint roll-back of "restore"
    # arrives with the checkpoint manager).
    nan_policy: str = "restore"
    use_mesh: bool = False  # not ported yet: run_seed raises when set
    mesh_impl: str = "gspmd"
    # Sparse embedding updates (train/lazy.py): only touched table rows'
    # params/moments move; lazy-Adam semantics (untouched rows' moments don't
    # decay). Covers both DR phases (optimizer2 gets its own per-row moments).
    lazy_table_adam: bool = False
    cl_w: float = 0.1  # C2DSR contrastive weight (C2DSR is not ported yet)
    eval_batch_drop_last: bool = True  # reference val loader drop_last=True (train_sr.py:455)
    fast_eval: bool = True  # not ported yet: run_seed raises when set
    fast_train: bool = True  # not ported yet: run_seed raises when set
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def __post_init__(self) -> None:
        # Keep seq_len / pad_id consistent between sub-configs.
        self.data.seq_len = self.model.seq_len
        self.data.pad_id = self.model.pad_id

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)
