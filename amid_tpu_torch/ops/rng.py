"""Train-mode randomness from explicit generators.

The JAX package threads `jax.random` keys: a step splits its key into one for
the negative sampler, one for dropout and, in phase A, one for C2DSR's
corrupted items and one for its views' dropout; the trainer folds the epoch
and the step index into a root key. The port keeps that shape with integer keys:

* `fold_in(key, data)` derives a new 63-bit key from a key and an integer (a
  splitmix64 mix; the numbers are not JAX's);
* `DropoutRandom(device)` is what a model's train-mode forward reads as its
  `rng`: one generator, `dropout_gen`, for the dropout masks and the
  attention kernels' dropout seeds (drawn as one-element int64 tensors that
  the kernels read from device memory);
* `StepRandom(key, device)` owns the generators of a step, all on the
  model's device: it is the main forward's `DropoutRandom`, with `sampler`
  (negatives) beside it, and with `c2dsr=True` also `corr` (C2DSR's
  corrupted items) and `views`, the two view passes' `DropoutRandom`s.
  `reseed(key)` seeds every generator from a step's key on the host,
  without touching the device: `sampler` from fold_in(key, 0), `dropout_gen`
  from fold_in(key, 1), `corr` from fold_in(key, 2), and both views' from
  fold_in(key, 3), so the two view passes, which run the same modules at the
  same shapes, draw the same masks and seeds, as the JAX package's passes do
  from their one key. So one `StepRandom` serves every step of a step
  function: a step function owns one, reseeds it from each step's key, and a
  CUDA graph of the step registers its generators (`StepRandom.generators`),
  whose seed and offset a replay then reads from device memory (a reseed
  inside a capture would not be replayed). Nothing here touches the
  process-wide generators: two `StepRandom`s seeded from one key give the
  same draws.

On a mesh under gspmd (`parallel/`), a rank holds rows [b0, b0 + b) of a
global batch of B rows: `set_rows((b0, B))` makes every keep mask a draw at
the global shape [B, ...] from which the rank keeps its rows, and gives the
attention kernels' masks the row offset b0 (`row_offset`, read by the
encoders), so each rank draws what a single process draws for its rows.
`set_rows(None)` (the default) draws at the tensor's own shape.
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


class DropoutRandom:
    """Train-mode dropout's draws from one generator on `device`."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.dropout_gen = torch.Generator(device=self.device)
        self.rows = None  # (b0, B): this rank's first row of a global batch of B rows

    @property
    def row_offset(self) -> int:
        """The global row of the batch's row 0 (the attention masks' key)."""
        return 0 if self.rows is None else self.rows[0]

    def attention_seed(self) -> torch.Tensor:
        """A fresh 31-bit seed for one attention call's dropout mask, drawn on
        the device: a one-element int64 tensor, read by the forward and the
        backward kernel alike, never by the host."""
        return torch.randint(0, 2**31 - 1, (1,), generator=self.dropout_gen,
                             device=self.device, dtype=torch.int64)

    def keep_mask(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """A boolean keep mask of x's shape, drawn from `dropout_gen` (with
        `rows`, this rank's rows of a draw at the global batch's shape)."""
        if self.rows is None:
            return torch.rand(x.shape, generator=self.dropout_gen, device=x.device) >= rate
        b0, total = self.rows
        u = torch.rand((total, *x.shape[1:]), generator=self.dropout_gen, device=x.device)
        return u[b0:b0 + x.shape[0]] >= rate

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """Inverted dropout of `x` with the mask drawn from `dropout_gen`."""
        if rate <= 0.0:
            return x
        return x * self.keep_mask(x, rate) * (1.0 / (1.0 - rate))


class StepRandom(DropoutRandom):
    """The generators of a training or evaluation step, seeded from its key."""

    def __init__(self, key, device, c2dsr: bool = False) -> None:
        super().__init__(device)
        self.sampler = torch.Generator(device=self.device)
        self.corr = torch.Generator(device=self.device) if c2dsr else None
        self.views = (DropoutRandom(device), DropoutRandom(device)) if c2dsr else ()
        self.key = None
        if key is not None:
            self.reseed(key)

    def reseed(self, key: int) -> "StepRandom":
        """Seeds every generator from `key`, on the host."""
        self.key = int(key)
        self.sampler.manual_seed(fold_in(self.key, 0))
        self.dropout_gen.manual_seed(fold_in(self.key, 1))
        if self.corr is not None:
            self.corr.manual_seed(fold_in(self.key, 2))
        for view in self.views:
            view.dropout_gen.manual_seed(fold_in(self.key, 3))
        return self

    def set_rows(self, rows) -> "StepRandom":
        """`rows` = (b0, B) for the main forward and the view passes alike."""
        for r in (self, *self.views):
            r.rows = rows
        return self

    def generators(self) -> tuple[torch.Generator, ...]:
        extra = (self.corr, *(v.dropout_gen for v in self.views)) if self.views else ()
        return (self.sampler, self.dropout_gen, *extra)


class RegionRandom:
    """The draws of one rematerialised region (`models.encoders`, remat): the
    first pass draws from the step's `DropoutRandom` and keeps each draw (an
    attention seed, a boolean keep mask); after `replay()` the recompute
    reads them back in the same order and draws nothing. So the recompute
    sees the forward's masks and seeds, the step's generator ends where a
    step without remat leaves it, and a CUDA graph of the step needs no
    generator state of its own: inside a capture a generator cannot be
    rewound (`clone_state`'s copy is not registered with the capturing
    graph), while kept tensors are replayed like any other. The masks cost
    one byte an element, what autograd keeps of them without remat."""

    def __init__(self, rng: DropoutRandom) -> None:
        self.rng = rng
        self.draws: list = []
        self.at = None  # the next draw to read back; None while drawing

    def replay(self) -> None:
        self.at = 0

    @property
    def row_offset(self) -> int:
        return self.rng.row_offset

    def _draw(self, make):
        if self.at is None:
            self.draws.append(make())
            return self.draws[-1]
        self.at += 1
        return self.draws[self.at - 1]

    def attention_seed(self) -> torch.Tensor:
        return self._draw(self.rng.attention_seed)

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate <= 0.0:
            return x
        return x * self._draw(lambda: self.rng.keep_mask(x, rate)) * (1.0 / (1.0 - rate))


def apply_dropout(x: torch.Tensor, rate: float, training: bool, rng) -> torch.Tensor:
    """Dropout as a module applies it: the identity in eval mode or at rate
    0; in train mode the step's `StepRandom` (or a view pass's
    `DropoutRandom`) is required."""
    if not training or rate <= 0.0:
        return x
    if rng is None:
        raise ValueError(
            "train-mode dropout needs the step's StepRandom (pass rng=...); the "
            "port draws no randomness from the process-wide generators"
        )
    return rng.dropout(x, rate)
