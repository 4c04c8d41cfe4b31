"""The Dataset / InMemoryDataset protocol.

Counterpart of ``pytorch_geometric_tpu/data/dataset.py`` (reference
``torch_geometric/data/dataset.py:30`` and ``in_memory_dataset.py:32``):
raw and processed file discovery, one ``process()`` whose result is cached
on disk, indexed and sliced access, transforms. The port keeps its own
processed file, ``data.pt``: each graph's tensors and node count, written
with ``torch.save`` and read back with ``weights_only=True``.
"""

import os
import os.path as osp
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .data import Data


class Dataset:
    """Download, process and cache (reference ``dataset.py:30``). With a
    ``root``, ``raw/`` and ``processed/`` are made under it, and
    ``process()`` runs unless every processed file is there (after
    ``download()`` where a raw file is missing)."""

    def __init__(self, root: Optional[str] = None,
                 transform: Optional[Callable] = None,
                 pre_transform: Optional[Callable] = None,
                 pre_filter: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        self.pre_transform = pre_transform
        self.pre_filter = pre_filter
        if root is not None:
            os.makedirs(self.raw_dir, exist_ok=True)
            os.makedirs(self.processed_dir, exist_ok=True)
            if not self._processed_exists():
                self._maybe_download()
                self.process()

    # -- layout --------------------------------------------------------------
    @property
    def raw_dir(self) -> str:
        return osp.join(self.root, 'raw')

    @property
    def processed_dir(self) -> str:
        return osp.join(self.root, 'processed')

    @property
    def raw_file_names(self) -> Sequence[str]:
        return []

    @property
    def processed_file_names(self) -> Sequence[str]:
        return []

    def _processed_exists(self) -> bool:
        names = self.processed_file_names
        return bool(names) and all(
            osp.exists(osp.join(self.processed_dir, f)) for f in names)

    def _raw_exists(self) -> bool:
        names = self.raw_file_names
        return bool(names) and all(
            osp.exists(osp.join(self.raw_dir, f)) for f in names)

    def _maybe_download(self):
        if not self._raw_exists():
            self.download()

    def download(self):
        raise RuntimeError(
            f'{self.__class__.__name__}: raw files missing under '
            f'{self.raw_dir}, and this package downloads nothing. Place the '
            f'raw files there.')

    def process(self):
        raise NotImplementedError

    # -- access --------------------------------------------------------------
    def len(self) -> int:
        raise NotImplementedError

    def get(self, idx: int) -> Data:
        raise NotImplementedError

    def __len__(self) -> int:
        return self.len()

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            data = self.get(int(idx))
            return data if self.transform is None else self.transform(data)
        if isinstance(idx, slice):
            idx = range(*idx.indices(len(self)))
        return [self[i] for i in idx]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def shuffle(self, seed: int = 0) -> List[Data]:
        perm = np.random.default_rng(seed).permutation(len(self))
        return [self[int(i)] for i in perm]

    def __repr__(self) -> str:
        return f'{self.__class__.__name__}({len(self)})'


def _graph_record(data: Data) -> dict:
    store = {k: (v.coo if hasattr(v, 'coo') else v).detach().cpu()
             for k, v in data.items()}
    return {'store': store, 'num_nodes': data.num_nodes}


class InMemoryDataset(Dataset):
    """Every graph cached in one processed file (reference
    ``in_memory_dataset.py:32``)."""

    _data_list: Optional[List[Data]] = None

    @property
    def processed_file_names(self) -> Sequence[str]:
        return ['data.pt']

    def _file(self) -> str:
        # the first processed file holds the graphs: one per split where
        # a subclass names one per split (PPI)
        return osp.join(self.processed_dir, self.processed_file_names[0])

    def save(self, data_list: List[Data]):
        if self.pre_filter is not None:
            data_list = [d for d in data_list if self.pre_filter(d)]
        if self.pre_transform is not None:
            data_list = [self.pre_transform(d) for d in data_list]
        torch.save([_graph_record(d) for d in data_list], self._file())
        self._data_list = data_list

    def _load(self):
        if self._data_list is None:
            records = torch.load(self._file(), weights_only=True)
            self._data_list = [Data(num_nodes=r['num_nodes'], **r['store'])
                               for r in records]
        return self._data_list

    def len(self) -> int:
        return len(self._load())

    def get(self, idx: int) -> Data:
        return self._load()[idx]

    @property
    def num_features(self) -> int:
        return self[0].num_node_features

    @property
    def num_classes(self) -> int:
        ys = [int(d.y.max()) for d in self._load() if d.y is not None]
        return max(ys) + 1 if ys else 0
