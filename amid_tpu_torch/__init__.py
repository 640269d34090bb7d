"""amid_tpu_torch — the PyTorch/CUDA port of amid_tpu for NVIDIA Hopper.

The JAX package `amid_tpu` is the reference; this package mirrors its module
layout and names (`config`, `ops/`, `models/`, `serve`) so each counterpart is
easy to find, and imports neither JAX nor anything under `amid_tpu`.

It serves (`models.amid.build_model`, `serve`: user representations and
the full-catalog top-K) and trains (`train.loop.run_seed`: the doubly-robust
trainer's phase A, phase B and evaluation, with dense Adam or the lazy table
Adam). The SASRec attention core, forward and backward, and the lazy Adam's
unique-row scatters run as hand-written CUDA kernels (`csrc/*.cu`, bound in
`ops/attention.py` and `ops/scatter.py`). Entry points run on `cuda` unless
the caller passes `device="cpu"`.
"""

from amid_tpu_torch.config import ModelConfig

__all__ = ["ModelConfig"]
