"""amid_tpu_torch — the PyTorch/CUDA port of amid_tpu for NVIDIA Hopper.

The JAX package `amid_tpu` is the reference; this package mirrors its module
layout and names (`config`, `ops/`, `models/`, `serve`) so each counterpart is
easy to find, and imports neither JAX nor anything under `amid_tpu`.

It serves (`models.amid.build_model`, with the JAX package's three
backbones, SASRec, BERT4Rec and GRU4Rec; `serve`: user representations and
the full-catalog top-K) and trains (`python3 -m amid_tpu_torch.train_sr_dr`
and `train_sr`, `train.loop.run` / `run_seed`: the doubly-robust trainer's
phase A, phase B and evaluation, with dense Adam or the lazy table Adam, in
the broadcast-quirk or the pairwise mode). Every op the JAX package wrote as
a TPU kernel runs as a hand-written CUDA kernel (`csrc/*.cu`): the attention
core of SASRec and BERT4Rec, forward and backward, with a second backward
path for sequences too long for the first (`ops/attention.py`), the lazy Adam's
unique-row scatters (`ops/scatter.py`), the embedding gather
(`ops/embedding.py`), the fused scoring head (`ops/scoring.py`) and the
pairwise max-affinity (`ops/affinity.py`). The trainer also runs on a
`data x model` mesh of `torch.distributed` ranks, across nodes
(`parallel/`: the item table row-sharded over `model`, the peer banks
all-gathered over `data`, the gspmd and shard_map steps). Entry points run
on `cuda` unless the caller passes `device="cpu"`.
"""

from amid_tpu_torch.config import DataConfig, MeshConfig, ModelConfig, TrainConfig

__all__ = ["DataConfig", "MeshConfig", "ModelConfig", "TrainConfig"]
