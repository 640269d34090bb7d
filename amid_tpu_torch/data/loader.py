"""Global-batch iterator over a packed dataset — the port's own copy of
`amid_tpu/data/loader.py` (numpy only).

Replaces torch DataLoader(batch_size=256, shuffle, num_workers=8,
drop_last=True, collate_fn=collate_fn_enhance) (train_sr.py:452-455) with a
zero-copy slicing iterator over the packed arrays. Shuffling uses a seeded
numpy Generator (one permutation per epoch). Negative sampling happens inside
the step (amid_tpu_torch.data.sampler), on the device, not here.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from amid_tpu_torch.data.packed import PackedDualDomainDataset


class BatchIterator:
    def __init__(
        self,
        dataset: PackedDualDomainDataset,
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        drop_last: bool = True,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._arrays = dataset.batch_arrays()

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        nb = len(self)
        for b in range(nb):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            yield {k: v[idx] for k, v in self._arrays.items()}

    def stacked(self) -> dict[str, np.ndarray]:
        """One epoch's batches as [nb, bs, ...] arrays — the host-stacked
        twin of epoch_perm(). Draws the SAME single permutation from the
        iterator's rng that __iter__ would, so alternating
        stacked()/__iter__ epochs see identical batch streams."""
        idx = self.epoch_perm().reshape(len(self), self.batch_size)
        return {k: v[idx] for k, v in self._arrays.items()}

    def epoch_perm(self) -> np.ndarray:
        """One epoch's row order, [nb*bs] — what a device-resident loop
        would ship (4 B/row) to gather its batches on the device. Consumes
        the iterator rng exactly as __iter__ / stacked() do."""
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        return order[: len(self) * self.batch_size].astype(np.int32)

    def arrays(self) -> dict[str, np.ndarray]:
        """The full per-row arrays (for one-time device residency)."""
        return self._arrays
