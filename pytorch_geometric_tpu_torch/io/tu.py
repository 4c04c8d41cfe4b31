"""The TUDataset text format, read on its own.

Counterpart of ``pytorch_geometric_tpu/io/tu.py`` (reference
``torch_geometric/io/tu.py::read_tu_data``): returns ``(data_list,
sizes)``, a ``Data`` a graph and the feature counts, as the JAX package's
does (the reference's collated ``(data, slices, sizes)`` is a storage
detail). Node features are the attributes, then the one-hot labels; edge
features likewise; ``y`` is the graph label less the smallest, or the
graph attributes. ``datasets/tu_dataset.py``'s ``TUDataset`` builds its
features in another order (labels first, attributes on request) and
renumbers the labels, as the JAX package's does, and shares :func:`read`
with this reader."""

import os.path as osp
from typing import Dict, List, Tuple

import numpy as np

from ..data.data import Data


def read(folder: str, prefix: str, suffix: str, dtype=np.int64,
         optional: bool = False):
    """``folder/<prefix>_<suffix>.txt`` as a 2-D array (comma separated);
    None for a missing ``optional`` file."""
    path = osp.join(folder, f'{prefix}_{suffix}.txt')
    if not osp.exists(path):
        if optional:
            return None
        raise FileNotFoundError(path)
    return np.loadtxt(path, delimiter=',', dtype=dtype, ndmin=2)


def _one_hot(labels, width):
    return np.eye(width, dtype=np.float32)[(labels - labels.min())[:, 0]]


def read_tu_data(folder: str, prefix: str
                 ) -> Tuple[List[Data], Dict[str, int]]:
    edges = read(folder, prefix, 'A') - 1                 # 1-based
    indicator = read(folder, prefix, 'graph_indicator')[:, 0] - 1
    graph_labels = read(folder, prefix, 'graph_labels', optional=True)
    graph_attrs = read(folder, prefix, 'graph_attributes', np.float32, True)
    node_labels = read(folder, prefix, 'node_labels', optional=True)
    node_attrs = read(folder, prefix, 'node_attributes', np.float32, True)
    edge_labels = read(folder, prefix, 'edge_labels', optional=True)
    edge_attrs = read(folder, prefix, 'edge_attributes', np.float32, True)

    def width(labels):
        return (0 if labels is None
                else int(labels.max() - labels.min()) + 1)

    sizes = {
        'num_node_labels': width(node_labels),
        'num_node_attributes': (0 if node_attrs is None
                                else node_attrs.shape[1]),
        'num_edge_labels': width(edge_labels),
        'num_edge_attributes': (0 if edge_attrs is None
                                else edge_attrs.shape[1]),
    }
    feats = [a for a in (node_attrs,) if a is not None]
    if node_labels is not None:
        feats.append(_one_hot(node_labels, sizes['num_node_labels']))
    x = np.concatenate(feats, 1) if feats else None
    efeats = [a for a in (edge_attrs,) if a is not None]
    if edge_labels is not None:
        efeats.append(_one_hot(edge_labels, sizes['num_edge_labels']))
    edge_attr = np.concatenate(efeats, 1) if efeats else None

    num_graphs = int(indicator.max()) + 1
    node_counts = np.bincount(indicator, minlength=num_graphs)
    node_offsets = np.concatenate([[0], np.cumsum(node_counts)])
    egraph = indicator[edges[:, 0]]
    eorder = np.argsort(egraph, kind='stable')
    eptr = np.searchsorted(egraph[eorder], np.arange(num_graphs + 1))

    data_list = []
    for g in range(num_graphs):
        lo, hi = node_offsets[g], node_offsets[g + 1]
        eidx = eorder[eptr[g]:eptr[g + 1]]
        kwargs = {}
        if x is not None:
            kwargs['x'] = x[lo:hi]
        if edge_attr is not None:
            kwargs['edge_attr'] = edge_attr[eidx]
        if graph_labels is not None:
            kwargs['y'] = np.asarray(
                [graph_labels[g, 0] - graph_labels.min()], np.int64)
        elif graph_attrs is not None:
            kwargs['y'] = graph_attrs[g]
        data_list.append(Data(edge_index=(edges[eidx] - lo).T.astype(
            np.int64), num_nodes=int(hi - lo), **kwargs))
    return data_list, sizes
