"""Synthetic dataset generators (reference ``datasets/fake.py:13,111``).

Counterpart of ``pytorch_geometric_tpu/datasets/fake.py``, with its numpy
generator: one seed gives the same graphs as the JAX package's, edge order
included. ``FakeDataset`` makes random homogeneous graphs whose labels are
learnable (class-correlated features, half of the edges inside a class),
so a training test can expect its loss to fall without any download.
"""

from typing import List

import numpy as np

from ..data.data import Data


class FakeDataset:
    """``num_graphs`` random graphs of about ``avg_num_nodes`` nodes and
    ``avg_degree`` edges a node, ``num_channels`` features, and
    ``num_classes`` node labels (``task='node'``) or one graph label
    (``task='graph'``)."""

    def __init__(self, num_graphs: int = 1, avg_num_nodes: int = 1000,
                 avg_degree: int = 10, num_channels: int = 64,
                 num_classes: int = 10, task: str = 'node', seed: int = 0,
                 edge_dim: int = 0, transform=None):
        self.num_classes = num_classes
        self.task = task
        self.transform = transform
        rng = np.random.default_rng(seed)
        self._graphs: List[Data] = []
        for _ in range(num_graphs):
            n = max(2, int(rng.normal(avg_num_nodes, avg_num_nodes * 0.1)))
            e = n * avg_degree
            y = rng.integers(0, num_classes, n)
            centers = rng.standard_normal((num_classes, num_channels)) * 2.0
            x = centers[y] + rng.standard_normal((n, num_channels))
            # half uniform edges, half between neighbours in class order
            row_r = rng.integers(0, n, e // 2)
            col_r = rng.integers(0, n, e // 2)
            perm = rng.permutation(n)
            order = np.argsort(y[perm], kind='stable')
            sorted_nodes = perm[order]
            pos = rng.integers(0, n - 1, e - e // 2)
            row_h = sorted_nodes[pos]
            col_h = sorted_nodes[np.minimum(pos + 1, n - 1)]
            edge_index = np.stack([np.concatenate([row_r, row_h]),
                                   np.concatenate([col_r, col_h])])
            kwargs = {}
            if edge_dim > 0:
                kwargs['edge_attr'] = rng.standard_normal(
                    (edge_index.shape[1], edge_dim)).astype(np.float32)
            label = (np.array([int(y.sum()) % num_classes])
                     if task == 'graph' else y)
            self._graphs.append(Data(x=x.astype(np.float32),
                                     edge_index=edge_index.astype(np.int32),
                                     y=label, num_nodes=n, **kwargs))

    def __len__(self) -> int:
        return len(self._graphs)

    def __getitem__(self, idx):
        if isinstance(idx, (list, np.ndarray)):
            out = FakeDataset.__new__(FakeDataset)
            out.num_classes = self.num_classes
            out.task = self.task
            out.transform = self.transform
            out._graphs = [self._graphs[i] for i in idx]
            return out
        d = self._graphs[idx]
        return d if self.transform is None else self.transform(d)

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def planetoid_like(num_nodes: int = 2708, num_edges: int = 10556,
                   num_features: int = 1433, num_classes: int = 7,
                   train_per_class: int = 20, num_val: int = 500,
                   num_test: int = 1000, seed: int = 0) -> Data:
    """A Cora-shaped synthetic citation graph with Planetoid's train / val
    / test masks (reference ``datasets/planetoid.py``'s split)."""
    ds = FakeDataset(1, avg_num_nodes=num_nodes, avg_degree=max(
        1, num_edges // num_nodes), num_channels=num_features,
        num_classes=num_classes, seed=seed)
    data = ds[0]
    n = data.num_nodes
    y = data.y.numpy()
    rng = np.random.default_rng(seed)
    train_mask = np.zeros(n, bool)
    for c in range(num_classes):
        idx = np.where(y == c)[0]
        pick = rng.choice(idx, min(train_per_class, len(idx)), replace=False)
        train_mask[pick] = True
    rest = np.where(~train_mask)[0]
    rng.shuffle(rest)
    val_mask = np.zeros(n, bool)
    val_mask[rest[:num_val]] = True
    test_mask = np.zeros(n, bool)
    test_mask[rest[num_val:num_val + num_test]] = True
    return data.replace(train_mask=train_mask, val_mask=val_mask,
                        test_mask=test_mask)
