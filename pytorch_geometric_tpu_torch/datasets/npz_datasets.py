"""npz and text dataset parsers: Amazon, Coauthor, WebKB,
WikipediaNetwork, Actor.

Counterpart of ``pytorch_geometric_tpu/datasets/npz_datasets.py``
(reference ``torch_geometric/datasets/amazon.py``, ``coauthor.py`` (both
the GNN-benchmark npz format, ``io/npz.py``), ``webkb.py``,
``wikipedia_network.py``, ``actor.py``), with its numpy and scipy parsing:
the same raw files give the JAX package's graphs bit for bit. Raw files go
under ``root/<name>/raw``; nothing is downloaded.
"""

import glob
import os.path as osp
from typing import Sequence

import numpy as np

from ..data.data import Data
from ..data.dataset import InMemoryDataset
from ..utils.coalesce import coalesce, to_undirected


def read_npz(path: str) -> Data:
    """GNN-benchmark npz format (reference ``io/npz.py``): binarised
    features, self loops removed, symmetrised."""
    import scipy.sparse as sp
    with np.load(path, allow_pickle=True) as f:
        adj = sp.csr_matrix((f['adj_data'], f['adj_indices'],
                             f['adj_indptr']), f['adj_shape']).tocoo()
        if 'attr_data' in f:
            x = sp.csr_matrix((f['attr_data'], f['attr_indices'],
                               f['attr_indptr']), f['attr_shape']).todense()
            x = np.asarray(x, np.float32)
            x[x > 0] = 1              # reference io/npz.py:22 binarises
        else:
            x = None
        y = f['labels'].astype(np.int64)
    coo = np.stack([adj.row, adj.col]).astype(np.int64)
    coo = coo[:, coo[0] != coo[1]]    # reference io/npz.py:29
    coo = to_undirected(coo, num_nodes=y.shape[0])
    return Data(x=x, edge_index=coo.astype(np.int32),
                y=y.astype(np.int32), num_nodes=y.shape[0])


def _text_edges(path: str, n: int) -> np.ndarray:
    """A geom-gcn edge file (a header, then ``src<TAB>dst`` lines),
    coalesced in its stored direction (reference ``webkb.py:119``,
    ``actor.py:98``)."""
    with open(path) as f:
        lines = f.read().split('\n')[1:-1]
    coo = np.array([[int(v) for v in line.split('\t')] for line in lines],
                   np.int64).T
    return coalesce(coo, num_nodes=n).astype(np.int32)


class Amazon(InMemoryDataset):
    """Amazon Computers / Photo (reference ``datasets/amazon.py``)."""

    def __init__(self, root: str, name: str, **kwargs):
        self.name = name.lower()
        super().__init__(osp.join(root, self.name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'amazon_electronics_{self.name}.npz']

    def process(self):
        self.save([read_npz(osp.join(self.raw_dir, self.raw_file_names[0]))])


class Coauthor(InMemoryDataset):
    """Coauthor CS / Physics (reference ``datasets/coauthor.py``)."""

    def __init__(self, root: str, name: str, **kwargs):
        self.name = name.lower()
        super().__init__(osp.join(root, self.name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        key = 'cs' if self.name == 'cs' else 'phy'
        return [f'ms_academic_{key}.npz']

    def process(self):
        self.save([read_npz(osp.join(self.raw_dir, self.raw_file_names[0]))])


class WebKB(InMemoryDataset):
    """Cornell / Texas / Wisconsin (reference ``datasets/webkb.py``):
    ``out1_node_feature_label.txt`` and ``out1_graph_edges.txt``."""

    def __init__(self, root: str, name: str, **kwargs):
        self.name = name.lower()
        super().__init__(osp.join(root, self.name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['out1_node_feature_label.txt', 'out1_graph_edges.txt']

    def process(self):
        with open(osp.join(self.raw_dir, self.raw_file_names[0])) as f:
            lines = f.read().split('\n')[1:-1]
        x = np.array([[float(v) for v in line.split('\t')[1].split(',')]
                      for line in lines], np.float32)
        y = np.array([int(line.split('\t')[2]) for line in lines], np.int32)
        coo = _text_edges(osp.join(self.raw_dir, self.raw_file_names[1]),
                          x.shape[0])
        self.save([Data(x=x, edge_index=coo, y=y, num_nodes=x.shape[0],
                        **self._load_split_masks())])

    def _load_split_masks(self):
        """The 10 geom-gcn split files stacked into ``[N, 10]`` masks
        (reference ``webkb.py:121-130``); none when the split files (a
        separate download) are absent."""
        prefix = getattr(self, 'split_prefix', None) or self.name
        paths = sorted(glob.glob(osp.join(
            self.raw_dir, f'{prefix}_split_0.6_0.2_*.npz')))
        if not paths:
            return {}
        tr, va, te = [], [], []
        for p in paths:
            z = np.load(p)
            tr.append(z['train_mask'].astype(bool))
            va.append(z['val_mask'].astype(bool))
            te.append(z['test_mask'].astype(bool))
        return {'train_mask': np.stack(tr, 1), 'val_mask': np.stack(va, 1),
                'test_mask': np.stack(te, 1)}


class WikipediaNetwork(WebKB):
    """Chameleon / Squirrel (reference ``datasets/wikipedia_network.py``;
    WebKB's text format)."""


class Actor(WebKB):
    """Actor co-occurrence (reference ``datasets/actor.py``): the raw
    feature column is a sparse index list over 932 words; split files use
    the 'film' prefix (reference ``actor.py:64``)."""
    split_prefix = 'film'

    def process(self):
        with open(osp.join(self.raw_dir, self.raw_file_names[0])) as f:
            lines = f.read().split('\n')[1:-1]
        n = len(lines)
        x = np.zeros((n, 932), np.float32)
        y = np.zeros(n, np.int32)
        for line in lines:
            idx, feats, label = line.split('\t')
            for j in feats.split(','):
                x[int(idx), int(j)] = 1.0
            y[int(idx)] = int(label)
        coo = _text_edges(osp.join(self.raw_dir, self.raw_file_names[1]), n)
        self.save([Data(x=x, edge_index=coo, y=y, num_nodes=n,
                        **self._load_split_masks())])
