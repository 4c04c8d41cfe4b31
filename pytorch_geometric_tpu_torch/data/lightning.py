"""Data modules (reference ``data/lightning/datamodule.py``).

Counterpart of ``pytorch_geometric_tpu/data/lightning.py``. The reference
subclasses ``pytorch_lightning.LightningDataModule``; as in the JAX
package these are plain classes with the same ``setup`` / ``prepare_data``
/ ``*_dataloader`` contract, with no lightning dependency, on the port's
``DataLoader``, ``NeighborLoader`` and ``LinkNeighborLoader``. The loaders
yield host batches; the training loop moves them to the card.
"""

from typing import Optional, Sequence

import numpy as np

from .data import host
from .dataset import Dataset


class LightningDataModule:
    """Base data module (reference ``datamodule.py:26``)."""

    def __init__(self, **loader_kwargs):
        self.loader_kwargs = loader_kwargs

    def setup(self, stage: Optional[str] = None):
        pass

    def prepare_data(self):
        pass


class LightningDataset(LightningDataModule):
    """Graph-level data module over whole-graph datasets (reference
    ``datamodule.py:219``): train / val / test datasets, each through a
    ``DataLoader`` (padded batches by default)."""

    def __init__(self, train_dataset: Dataset,
                 val_dataset: Optional[Dataset] = None,
                 test_dataset: Optional[Dataset] = None,
                 batch_size: int = 1, **kwargs):
        super().__init__(batch_size=batch_size, **kwargs)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.test_dataset = test_dataset
        self.batch_size = batch_size
        self.kwargs = kwargs

    def _loader(self, dataset, shuffle):
        from ..loader import DataLoader
        return DataLoader(dataset, batch_size=self.batch_size,
                          shuffle=shuffle, **self.kwargs)

    def train_dataloader(self):
        return self._loader(self.train_dataset, True)

    def val_dataloader(self):
        if self.val_dataset is None:
            raise ValueError("no 'val_dataset' was given")
        return self._loader(self.val_dataset, False)

    def test_dataloader(self):
        if self.test_dataset is None:
            raise ValueError("no 'test_dataset' was given")
        return self._loader(self.test_dataset, False)


class LightningNodeData(LightningDataModule):
    """Node-level data module (reference ``datamodule.py:329``): one graph
    and split masks or indices, a ``NeighborLoader`` a split (or the whole
    graph with ``loader='full'``)."""

    def __init__(self, data, input_train_nodes=None, input_val_nodes=None,
                 input_test_nodes=None, loader: str = 'neighbor',
                 num_neighbors: Sequence[int] = (10,), batch_size: int = 128,
                 **kwargs):
        super().__init__()
        self.data = data
        self.loader = loader
        self.num_neighbors = list(num_neighbors)
        self.batch_size = batch_size
        self.kwargs = kwargs
        self.input_nodes = {
            'train': self._resolve(input_train_nodes, 'train_mask'),
            'val': self._resolve(input_val_nodes, 'val_mask'),
            'test': self._resolve(input_test_nodes, 'test_mask'),
        }

    def _resolve(self, nodes, mask_attr):
        if nodes is None:
            m = getattr(self.data, mask_attr, None)
            if m is None:
                return None
            return np.nonzero(host(m))[0]
        nodes = host(nodes)
        if nodes.dtype == bool:
            return np.nonzero(nodes)[0]
        return nodes

    def _split_loader(self, split, shuffle):
        nodes = self.input_nodes[split]
        if nodes is None:
            raise ValueError(f"no input nodes for split '{split}'")
        if self.loader == 'full':
            return [self.data]
        from ..loader import NeighborLoader
        return NeighborLoader(self.data, num_neighbors=self.num_neighbors,
                              input_nodes=nodes, batch_size=self.batch_size,
                              shuffle=shuffle, **self.kwargs)

    def train_dataloader(self):
        return self._split_loader('train', True)

    def val_dataloader(self):
        return self._split_loader('val', False)

    def test_dataloader(self):
        return self._split_loader('test', False)


class LightningLinkData(LightningDataModule):
    """Link-level data module (reference ``datamodule.py:522``) on
    ``LinkNeighborLoader``."""

    def __init__(self, data, input_train_edges=None, input_val_edges=None,
                 input_test_edges=None, num_neighbors: Sequence[int] = (10,),
                 batch_size: int = 128, **kwargs):
        super().__init__()
        self.data = data
        self.num_neighbors = list(num_neighbors)
        self.batch_size = batch_size
        self.kwargs = kwargs
        self.input_edges = {'train': input_train_edges,
                            'val': input_val_edges,
                            'test': input_test_edges}

    def _split_loader(self, split, shuffle):
        edges = self.input_edges[split]
        if edges is None:
            raise ValueError(f"no input edges for split '{split}'")
        from ..loader import LinkNeighborLoader
        return LinkNeighborLoader(
            self.data, num_neighbors=self.num_neighbors,
            edge_label_index=edges, batch_size=self.batch_size,
            shuffle=shuffle, **self.kwargs)

    def train_dataloader(self):
        return self._split_loader('train', True)

    def val_dataloader(self):
        return self._split_loader('val', False)

    def test_dataloader(self):
        return self._split_loader('test', False)
