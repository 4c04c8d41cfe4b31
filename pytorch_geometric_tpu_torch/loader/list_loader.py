"""DataListLoader, DenseDataLoader, ZipLoader and the loader mixins.

Counterpart of ``pytorch_geometric_tpu/loader/list_loader.py`` (reference
``torch_geometric/loader/data_list_loader.py``, ``dense_data_loader.py``,
``zip_loader.py`` and ``mixin.py``). The order of graphs is the JAX
package's for the same seed; ``DenseDataLoader`` stacks each field's
tensors where they lie.
"""

import contextlib

import numpy as np
import torch

from ..data.data import Data, as_tensor
from ..edge_index import EdgeIndex


def _order(n: int, shuffle: bool, rng: np.random.Generator) -> np.ndarray:
    order = np.arange(n)
    return rng.permutation(order) if shuffle else order


class DataListLoader:
    """Yields plain python lists of Data (no collation) — for models
    that scatter graphs themselves (reference ``data_list_loader.py``)."""

    def __init__(self, dataset, batch_size: int = 1,
                 shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) \
            // self.batch_size

    def __iter__(self):
        order = _order(len(self.dataset), self.shuffle, self.rng)
        for i in range(0, len(order), self.batch_size):
            yield [self.dataset[int(j)]
                   for j in order[i:i + self.batch_size]]


class DenseDataLoader(DataListLoader):
    """Stacks same-sized dense graphs along a batch dim (reference
    ``dense_data_loader.py``): every field becomes ``[B, ...]``."""

    def __iter__(self):
        for graphs in super().__iter__():
            stacked = {k: torch.stack([as_tensor(
                g[k].coo if isinstance(g[k], EdgeIndex) else g[k])
                for g in graphs]) for k in graphs[0].keys()}
            yield Data(num_nodes=graphs[0].num_nodes, **stacked)


class ZipLoader:
    """Zip several loaders into one iterator
    (reference ``loader/zip_loader.py``)."""

    def __init__(self, loaders, filter_per_worker: bool = False):
        self.loaders = list(loaders)

    def __len__(self):
        return min(len(ld) for ld in self.loaders)

    def __iter__(self):
        return zip(*self.loaders)


class AffinityMixin:
    """CPU-affinity context (reference ``loader/mixin.py:15``). The
    loaders sample in threads of one process, so worker pinning is a
    no-op; kept for API parity."""

    def enable_cpu_affinity(self, loader_cores=None):
        return contextlib.nullcontext()


class MultithreadingMixin:
    """(reference ``mixin.py:78``): a no-op, as in the JAX package; a
    loader's threads are set by its ``num_workers``."""

    def enable_multithreading(self, worker_threads: int = 1):
        return contextlib.nullcontext()


class LogMemoryMixin:
    """(reference ``mixin.py:100``)."""

    def _mem_report(self):
        import resource
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print(f'peak host memory: {peak / 1024:.1f} MB')
