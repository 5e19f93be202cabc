"""Dataset wrappers: the port's copy of
``sparse2dense_tpu/data/datasets/wrappers.py`` (det3d's
datasets/dataset_wrappers.py:8, :28). Each entry draws from the generator
of its own (seed, epoch, index) key (``waymo.SeededDataset``), so a
repeated frame is augmented anew."""
from __future__ import annotations

import numpy as np

from .waymo import SeededDataset


class ConcatDataset(SeededDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self._cum[-1])

    def get(self, idx, rng):
        d = int(np.searchsorted(self._cum, idx, side="right"))
        prev = 0 if d == 0 else int(self._cum[d - 1])
        return self.datasets[d].get(idx - prev, rng)


class RepeatDataset(SeededDataset):
    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def get(self, idx, rng):
        return self.dataset.get(idx % len(self.dataset), rng)
