"""TemporalDataLoader: chronological event batches over a
``TemporalData`` stream.

Counterpart of ``pytorch_geometric_tpu/loader/temporal.py`` (reference
``torch_geometric/loader/temporal_dataloader.py:8``); the batches and their
negative destinations are the JAX package's for the same seed.
"""

from typing import Iterator

import numpy as np


class TemporalDataLoader:
    def __init__(self, data, batch_size: int = 1,
                 neg_sampling_ratio: float = 0.0, seed: int = 0):
        self.data = data
        self.batch_size = batch_size
        self.neg_sampling_ratio = neg_sampling_ratio
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return (self.data.num_events + self.batch_size - 1) \
            // self.batch_size

    def __iter__(self) -> Iterator:
        n = self.data.num_nodes
        for batch in self.data.seq_batches(self.batch_size):
            if self.neg_sampling_ratio > 0:
                k = int(len(batch.src) * self.neg_sampling_ratio)
                batch.neg_dst = self.rng.integers(0, n, k)
            yield batch
