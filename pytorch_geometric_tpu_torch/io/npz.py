"""NPZ sparse-graph reader.

Counterpart of ``pytorch_geometric_tpu/io/npz.py`` (reference
``torch_geometric/io/npz.py``): ``read_npz`` is the one the npz datasets
use (``datasets/npz_datasets.py``); ``parse_npz`` parses an npz mapping
already opened."""

import numpy as np

from ..data.data import Data
from ..datasets.npz_datasets import read_npz

__all__ = ['read_npz', 'parse_npz']


def parse_npz(f, to_undirected: bool = True) -> Data:
    """The GNN-benchmark arrays of ``f`` (reference ``npz.py:16``):
    binarised features, self loops removed, and with ``to_undirected``
    both directions kept once each, sorted by ``(row, col)``."""
    import scipy.sparse as sp
    x = np.asarray(sp.csr_matrix(
        (f['attr_data'], f['attr_indices'], f['attr_indptr']),
        f['attr_shape']).todense(), np.float32)
    x[x > 0] = 1
    adj = sp.csr_matrix(
        (f['adj_data'], f['adj_indices'], f['adj_indptr']),
        f['adj_shape']).tocoo()
    row, col = adj.row.astype(np.int64), adj.col.astype(np.int64)
    keep = row != col
    row, col = row[keep], col[keep]
    if to_undirected:
        r = np.concatenate([row, col])
        c = np.concatenate([col, row])
        _, idx = np.unique(r * x.shape[0] + c, return_index=True)
        row, col = r[idx], c[idx]
    y = f['labels'].astype(np.int64)
    return Data(x=x, edge_index=np.stack([row, col]), y=y,
                num_nodes=x.shape[0])
