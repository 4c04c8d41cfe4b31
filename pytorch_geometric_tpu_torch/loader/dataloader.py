"""DataLoader: whole-graph minibatching with bucketed padding.

Counterpart of ``pytorch_geometric_tpu/loader/dataloader.py`` (reference
``torch_geometric/loader/dataloader.py:13``: Collater wraps
``Batch.from_data_list``). Batches are padded to power-of-two-ish buckets,
so the number of distinct shapes (captured graphs) stays bounded (the
reference's IPU precedent: ``transforms/pad.py``). The heterogeneous
collation goes with ROADMAP Queue 1, item 9.
"""

import math
from typing import List, Optional, Sequence

import numpy as np

from ..data.batch import Batch
from ..data.data import Data


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** math.ceil(math.log2(max(n, 1))))


class Collater:
    """(reference ``dataloader.py:13``)."""

    def __init__(self, pad: bool = True,
                 node_buckets: Optional[Sequence[int]] = None,
                 edge_buckets: Optional[Sequence[int]] = None):
        self.pad = pad
        self.node_buckets = node_buckets or [2 ** k for k in range(4, 24)]
        self.edge_buckets = edge_buckets or [2 ** k for k in range(5, 26)]

    def __call__(self, data_list: List[Data]) -> Batch:
        if not self.pad:
            return Batch.from_data_list(data_list)
        n = sum(d.num_nodes for d in data_list) + 1  # +1 dump row
        e = sum(d.num_edges for d in data_list)
        return Batch.from_data_list(
            data_list,
            pad_num_nodes=_bucket(n, self.node_buckets),
            pad_num_edges=_bucket(e, self.edge_buckets))


class DataLoader:
    """Minibatch iterator over a dataset of graphs
    (reference ``loader/dataloader.py:52``)."""

    def __init__(self, dataset, batch_size: int = 1,
                 shuffle: bool = False, drop_last: bool = False,
                 pad: bool = True, seed: int = 0, **kwargs):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collater = Collater(pad=pad, **kwargs)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = self.rng.permutation(order)
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            yield self.collater([self.dataset[int(j)] for j in idx])
