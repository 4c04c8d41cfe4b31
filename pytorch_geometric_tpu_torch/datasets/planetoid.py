"""Planetoid (Cora / CiteSeer / PubMed).

Counterpart of ``pytorch_geometric_tpu/datasets/planetoid.py`` (reference
``torch_geometric/datasets/planetoid.py`` and ``torch_geometric/io/
planetoid.py``): parses the pickled ``ind.<name>.{x,tx,allx,y,ty,ally,
graph,test.index}`` files under ``root/<name>/raw`` with the same numpy
arithmetic, so the graph is the JAX package's bit for bit, edge order
included. The package downloads nothing: the raw files must be there.
"""

import os.path as osp
import pickle
from typing import Sequence

import numpy as np

from ..data.data import Data
from ..data.dataset import InMemoryDataset
from ..utils.coalesce import coalesce

PARTS = ('x', 'tx', 'allx', 'y', 'ty', 'ally', 'graph', 'test.index')


def _read_pickle(path):
    with open(path, 'rb') as f:
        return pickle.load(f, encoding='latin1')


def _to_dense(x):
    try:
        return np.asarray(x.todense())
    except AttributeError:
        return np.asarray(x)


def read_planetoid_data(folder: str, prefix: str) -> Data:
    """Parse the pickled ``ind.<prefix>.*`` files into one ``Data``
    (reference ``torch_geometric/io/planetoid.py``): features and labels of
    the training, other and test rows, the test rows moved to the places
    ``test.index`` gives (CiteSeer's isolated test nodes, missing from
    ``tx``, filled with zero rows), self loops removed and the stored
    direction coalesced, not symmetrised; the public split's masks."""
    d = {}
    for part in PARTS:
        path = osp.join(folder, f'ind.{prefix.lower()}.{part}')
        if part == 'test.index':
            with open(path) as f:
                d['test_index'] = np.array([int(line) for line in f])
        else:
            d[part] = _read_pickle(path)

    x = _to_dense(d['x']).astype(np.float32)
    tx = _to_dense(d['tx']).astype(np.float32)
    allx = _to_dense(d['allx']).astype(np.float32)
    y = np.asarray(d['y'])
    ty = np.asarray(d['ty'])
    ally = np.asarray(d['ally'])
    test_idx = d['test_index']
    sorted_test = np.sort(test_idx)

    if prefix.lower() == 'citeseer':
        # fill isolated test nodes missing from tx
        full = np.arange(sorted_test.min(), sorted_test.max() + 1)
        tx_full = np.zeros((len(full), tx.shape[1]), np.float32)
        ty_full = np.zeros((len(full), ty.shape[1]), ty.dtype)
        tx_full[sorted_test - sorted_test.min()] = tx[np.argsort(test_idx)]
        ty_full[sorted_test - sorted_test.min()] = ty[np.argsort(test_idx)]
        tx, ty = tx_full, ty_full
        test_pos = full
    else:
        order = np.argsort(test_idx)
        tx = tx[order]
        ty = ty[order]
        test_pos = sorted_test

    X = np.concatenate([allx, tx], 0)
    Y = np.concatenate([ally, ty], 0).argmax(-1)
    # reorder test rows into their global positions
    X[test_pos] = X[len(allx):]
    Y[test_pos] = Y[len(allx):]

    n = X.shape[0]
    rows, cols = [], []
    for src, nbrs in d['graph'].items():
        for dst in nbrs:
            rows.append(src)
            cols.append(dst)
    coo = np.stack([np.array(rows), np.array(cols)]).astype(np.int32)
    # reference io/planetoid.py:139-143: self loops removed, then coalesce
    # (dedupe) in the stored direction; the raw dicts are already
    # symmetric, and PubMed's and CiteSeer's hold duplicates and loops
    coo = coalesce(coo[:, coo[0] != coo[1]], num_nodes=n)

    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[:len(y)] = True
    val_mask[len(y):len(y) + 500] = True
    test_mask[test_pos] = True
    return Data(x=X, edge_index=coo, y=Y.astype(np.int32),
                train_mask=train_mask, val_mask=val_mask,
                test_mask=test_mask, num_nodes=n)


class Planetoid(InMemoryDataset):
    """Citation networks with the public fixed split (reference
    ``datasets/planetoid.py``); ``split`` is stored, and only the public
    split is built, as in the JAX package."""

    def __init__(self, root: str, name: str, split: str = 'public',
                 **kwargs):
        self.name = name.lower()
        self.split = split
        super().__init__(osp.join(root, self.name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'ind.{self.name}.{p}' for p in PARTS]

    def process(self):
        self.save([read_planetoid_data(self.raw_dir, self.name)])
