"""Large single-graph benchmarks: Reddit, the GraphSAINT family and NELL.

Counterpart of ``pytorch_geometric_tpu/datasets/big_graphs.py`` (reference
``torch_geometric/datasets/reddit.py`` (npz and a scipy COO adjacency),
``reddit2.py`` / ``flickr.py`` / ``yelp.py`` / ``amazon_products.py``
(GraphSAINT's layout: ``adj_full.npz``, ``feats.npy``, ``class_map.json``,
``role.json``) and ``nell.py`` (Planetoid's pickles)), with its numpy
parsing. Raw files go under ``root/raw``; nothing is downloaded.
"""

import json
import os.path as osp
from typing import Sequence

import numpy as np

from ..data.data import Data
from ..data.dataset import InMemoryDataset
from .planetoid import Planetoid


class Reddit(InMemoryDataset):
    """(reference ``reddit.py``: ``reddit_data.npz`` with features, labels
    and node types 1 / 2 / 3 for train / val / test, and a scipy sparse
    ``reddit_graph.npz``)."""

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['reddit_data.npz', 'reddit_graph.npz']

    def process(self):
        import scipy.sparse as sp
        with np.load(osp.join(self.raw_dir, 'reddit_data.npz')) as f:
            x = f['feature'].astype(np.float32)
            y = f['label'].astype(np.int32)
            split = f['node_types']
        adj = sp.load_npz(osp.join(self.raw_dir, 'reddit_graph.npz')).tocoo()
        d = Data(x=x, edge_index=np.stack([adj.row, adj.col]).astype(
            np.int64), y=y, num_nodes=x.shape[0])
        d.train_mask = split == 1
        d.val_mask = split == 2
        d.test_mask = split == 3
        self.save([d])


class _SaintGraph(InMemoryDataset):
    """GraphSAINT's raw layout (reference ``flickr.py`` and the others):
    ``adj_full.npz`` (scipy CSR arrays), ``feats.npy``, ``class_map.json``
    (a label, or a multi-hot list where ``multilabel``) and ``role.json``
    (the ``tr`` / ``va`` / ``te`` node lists)."""

    multilabel = False

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['adj_full.npz', 'feats.npy', 'class_map.json', 'role.json']

    def process(self):
        import scipy.sparse as sp
        f = np.load(osp.join(self.raw_dir, 'adj_full.npz'))
        adj = sp.csr_matrix((f['data'], f['indices'], f['indptr']),
                            f['shape']).tocoo()
        x = np.load(osp.join(self.raw_dir, 'feats.npy')).astype(np.float32)
        with open(osp.join(self.raw_dir, 'class_map.json')) as fh:
            cmap = json.load(fh)
        with open(osp.join(self.raw_dir, 'role.json')) as fh:
            role = json.load(fh)
        n = x.shape[0]
        if self.multilabel:
            dim = len(next(iter(cmap.values())))
            y = np.zeros((n, dim), np.float32)
        else:
            y = np.zeros(n, np.int32)
        for k, v in cmap.items():
            y[int(k)] = v
        d = Data(x=x, edge_index=np.stack([adj.row, adj.col]).astype(
            np.int64), y=y, num_nodes=n)
        for name, key in (('train', 'tr'), ('val', 'va'), ('test', 'te')):
            mask = np.zeros(n, bool)
            mask[np.asarray(role[key], np.int64)] = True
            d[f'{name}_mask'] = mask
        self.save([d])


class Flickr(_SaintGraph):
    """(reference ``flickr.py``)."""


class Reddit2(_SaintGraph):
    """(reference ``reddit2.py``)."""


class Yelp(_SaintGraph):
    """(reference ``yelp.py``), multi-label."""
    multilabel = True


class AmazonProducts(_SaintGraph):
    """(reference ``amazon_products.py``), multi-label."""
    multilabel = True


class NELL(Planetoid):
    """The NELL knowledge graph (reference ``nell.py``): Planetoid's
    pickles under the name ``nell.0.001``, features densified."""

    def __init__(self, root: str, **kwargs):
        super().__init__(root, 'nell.0.001', **kwargs)
