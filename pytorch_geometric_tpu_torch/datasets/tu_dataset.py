"""TUDataset, the graph-kernel benchmark collection.

Counterpart of ``pytorch_geometric_tpu/datasets/tu_dataset.py`` (reference
``torch_geometric/datasets/tu_dataset.py`` and ``torch_geometric/io/tu.py``):
the ``DS_A.txt``, ``DS_graph_indicator.txt``, ``DS_graph_labels.txt``,
``DS_node_labels.txt``, ``DS_node_attributes.txt`` and
``DS_edge_labels.txt`` text files under ``root/name/raw``, parsed with the
same numpy arithmetic. Node features are the one-hot node labels, then
the node attributes when ``use_node_attr``; graph labels are renumbered
from 0 in sorted order; edge labels become one-hot ``edge_attr``. The files
are read by ``io/tu.py::read``, which ``io.read_tu_data`` reads with too.
"""

import os.path as osp
from typing import Sequence

import numpy as np

from ..data.data import Data
from ..data.dataset import InMemoryDataset
from ..io.tu import read


class TUDataset(InMemoryDataset):
    def __init__(self, root: str, name: str, use_node_attr: bool = False,
                 **kwargs):
        self.name = name
        self.use_node_attr = use_node_attr
        super().__init__(osp.join(root, name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.name}_A.txt', f'{self.name}_graph_indicator.txt']

    def _read(self, suffix, dtype=np.int64, optional=False):
        return read(self.raw_dir, self.name, suffix, dtype, optional)

    def process(self):
        edges = self._read('A') - 1                        # 1-based
        indicator = self._read('graph_indicator')[:, 0] - 1
        graph_labels = self._read('graph_labels', optional=True)
        node_labels = self._read('node_labels', optional=True)
        node_attrs = self._read('node_attributes', dtype=np.float32,
                                optional=True)
        edge_labels = self._read('edge_labels', optional=True)

        num_graphs = int(indicator.max()) + 1
        node_offsets = np.zeros(num_graphs + 1, np.int64)
        np.add.at(node_offsets, indicator + 1, 1)
        node_offsets = np.cumsum(node_offsets)

        feats = []
        if node_labels is not None:
            nl = node_labels - node_labels.min()
            width = int(nl.max()) + 1
            feats.append(np.eye(width, dtype=np.float32)[nl[:, 0]])
        if node_attrs is not None and self.use_node_attr:
            feats.append(node_attrs)
        x_all = np.concatenate(feats, -1) if feats else None

        egraph = indicator[edges[:, 0]]
        if graph_labels is not None:
            gl = graph_labels[:, 0]
            remap = {v: i for i, v in enumerate(np.unique(gl))}
            gl = np.array([remap[v] for v in gl], np.int32)

        data_list = []
        edge_order = np.argsort(egraph, kind='stable')
        edges_sorted = edges[edge_order]
        e_ptr = np.searchsorted(egraph[edge_order], np.arange(num_graphs + 1))
        for g in range(num_graphs):
            lo, hi = node_offsets[g], node_offsets[g + 1]
            el, eh = e_ptr[g], e_ptr[g + 1]
            kwargs = {}
            if x_all is not None:
                kwargs['x'] = x_all[lo:hi]
            if graph_labels is not None:
                kwargs['y'] = np.array([gl[g]])
            if edge_labels is not None:
                eo = edge_labels[edge_order][el:eh]
                width = int(edge_labels.max() - edge_labels.min()) + 1
                kwargs['edge_attr'] = np.eye(width, dtype=np.float32)[
                    (eo - edge_labels.min())[:, 0]]
            coo = (edges_sorted[el:eh] - lo).T.astype(np.int32)
            data_list.append(Data(edge_index=coo, num_nodes=int(hi - lo),
                                  **kwargs))
        self.save(data_list)
