"""Train-mode randomness from explicit generators.

The JAX package threads `jax.random` keys: a step splits its key into one for
the negative sampler and one for dropout, and the trainer folds the epoch and
the step index into a root key. The port keeps that shape with integer keys:

* `fold_in(key, data)` derives a new 63-bit key from a key and an integer (a
  splitmix64 mix; the numbers are not JAX's);
* `StepRandom(key, device)` owns the generators of a step, both on the
  model's device: `sampler` (negatives) and `dropout_gen` (dropout masks, and
  the attention kernels' dropout seeds, drawn as one-element int64 tensors
  that the kernels read from device memory). `reseed(key)` seeds both from a
  step's key on the host, without touching the device, so one `StepRandom`
  serves every step of a step function: a step function owns one, reseeds it
  from each step's key, and a CUDA graph of the step registers its two
  generators (`StepRandom.generators`), whose seed and offset a replay then
  reads from device memory. Nothing here touches the process-wide
  generators: two `StepRandom`s seeded from one key give the same draws.
"""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A key derived from `key` and the integer `data`, in [0, 2^63)."""
    z = (key * 0x9E3779B97F4A7C15 + (data + 1) * 0xD1B54A32D192ED03) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


class StepRandom:
    """The generators of a training or evaluation step, seeded from its key."""

    def __init__(self, key, device) -> None:
        self.device = torch.device(device)
        self.sampler = torch.Generator(device=self.device)
        self.dropout_gen = torch.Generator(device=self.device)
        self.key = None
        if key is not None:
            self.reseed(key)

    def reseed(self, key: int) -> "StepRandom":
        """Seeds both generators from `key`, on the host."""
        self.key = int(key)
        self.sampler.manual_seed(fold_in(self.key, 0))
        self.dropout_gen.manual_seed(fold_in(self.key, 1))
        return self

    def generators(self) -> tuple[torch.Generator, torch.Generator]:
        return self.sampler, self.dropout_gen

    def attention_seed(self) -> torch.Tensor:
        """A fresh 31-bit seed for one attention call's dropout mask, drawn on
        the device: a one-element int64 tensor, read by the forward and the
        backward kernel alike, never by the host."""
        return torch.randint(0, 2**31 - 1, (1,), generator=self.dropout_gen,
                             device=self.device, dtype=torch.int64)

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """Inverted dropout of `x` with the mask drawn from `dropout_gen`."""
        if rate <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.dropout_gen, device=x.device) >= rate
        return x * keep * (1.0 / (1.0 - rate))


def apply_dropout(x: torch.Tensor, rate: float, training: bool, rng) -> torch.Tensor:
    """Dropout as a module applies it: the identity in eval mode or at rate
    0; in train mode the step's `StepRandom` is required."""
    if not training or rate <= 0.0:
        return x
    if rng is None:
        raise ValueError(
            "train-mode dropout needs the step's StepRandom (pass rng=...); the "
            "port draws no randomness from the process-wide generators"
        )
    return rng.dropout(x, rate)
