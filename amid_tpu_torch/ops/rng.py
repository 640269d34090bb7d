"""Train-mode randomness from explicit generators.

The JAX package threads `jax.random` keys: a step splits its key into one for
the negative sampler and one for dropout, and the trainer folds the epoch and
the step index into a root key. The port keeps that shape with integer keys:

* `fold_in(key, data)` derives a new 63-bit key from a key and an integer (a
  splitmix64 mix; the numbers are not JAX's);
* `StepRandom(key, device)` owns one step's generators: `sampler` and
  `dropout` on the model's device, and `host`, a CPU generator from which the
  attention kernels' dropout seeds are drawn as Python ints, so the same int
  reaches the forward and the backward launch and no device tensor is read
  back. Nothing here touches the process-wide generators: two `StepRandom`s
  built from one key give the same draws.
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
    """The generators of one training or evaluation step."""

    def __init__(self, key: int, device) -> None:
        self.key = int(key)
        self.sampler = torch.Generator(device=device).manual_seed(fold_in(self.key, 0))
        self.dropout_gen = torch.Generator(device=device).manual_seed(fold_in(self.key, 1))
        self.host = torch.Generator().manual_seed(fold_in(self.key, 2))

    def attention_seed(self) -> int:
        """A fresh 31-bit seed for one attention call's dropout mask."""
        return int(torch.randint(0, 2**31 - 1, (), generator=self.host))

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
