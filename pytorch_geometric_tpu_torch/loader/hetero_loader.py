"""Heterogeneous NeighborLoader / HGTLoader.

Counterpart of ``pytorch_geometric_tpu/loader/hetero_loader.py`` (reference
``torch_geometric/loader/neighbor_loader.py``'s hetero path and
``hgt_loader.py:11``): the loader walks seed batches of one node type, runs
the host sampler and joins the per-type features (``_filter_hetero``) into
a fixed-shape padded :class:`HeteroData`. The last batch is padded with
seed 0 to the full batch size, as in the JAX package. The batches equal the
JAX package's field for field and dtype for dtype, as host tensors; a
joined feature table is gathered where it lies (on the card for a table on
the card).

A batch's relations keep the JAX package's padding: a padded edge's two
endpoints both hold the source type's node budget, which can be a valid
destination row; ``edge_mask`` tells the real edges.
:func:`batch_edge_index_dict` turns them into :class:`EdgeIndex` es whose
padded edges point past both ends, for the sparse kernels.
"""

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .neighbor_loader import _rows
from .scan_train import batch_edge_index
from ..backend import resolve_device
from ..data.hetero_data import HeteroData
from ..edge_index import EdgeIndex
from ..sampler.base import NodeSamplerInput
from ..sampler.hetero import (HeteroNeighborSampler, HeteroSamplerOutput,
                              HGTSampler)

EdgeType = Tuple[str, str, str]


def _filter_hetero(data: HeteroData, out: HeteroSamplerOutput) -> HeteroData:
    """Per-type feature join (reference ``loader/utils.py:
    filter_hetero_data``)."""
    sub = HeteroData()
    for t in out.node.keys():
        nodes = out.node[t]
        mask = out.node_mask[t]
        safe = np.where(mask, nodes, 0)
        x = data[t].x
        if x is not None:
            sub[t].x = _rows(x, safe, mask)
        y = data[t].y
        if y is not None:
            sub[t].y = _rows(y, safe)
        sub[t].n_id = nodes
        sub[t].node_mask = mask
    for et in out.row.keys():
        coo = np.stack([out.row[et], out.col[et]])
        n_src = len(out.node[et[0]])
        coo = np.where(coo < 0, n_src, coo)
        sub[et].edge_index = coo.astype(np.int32)
        sub[et].e_id = out.edge[et]
        sub[et].edge_mask = out.edge_mask[et]
    sub[out.input_type].batch_size = np.asarray(out.batch_size)
    return sub


def batch_edge_index_dict(batch: HeteroData, device=None
                          ) -> Dict[EdgeType, EdgeIndex]:
    """A loader batch's relations as :class:`EdgeIndex` es on ``device``
    (None: the card), each padded edge past both ends and each type's node
    budget its size (``loader.scan_train.batch_edge_index``)."""
    dev = resolve_device(device)
    return {et: batch_edge_index(
        coo.to(dev), batch[et].edge_mask.to(dev),
        int(batch[et[0]].n_id.shape[0]), int(batch[et[2]].n_id.shape[0]))
        for et, coo in batch.edge_index_dict.items()}


class HeteroNeighborLoader:
    """(reference ``neighbor_loader.py`` with ``(type, indices)``
    ``input_nodes``)."""

    def __init__(self, data: HeteroData, num_neighbors: Sequence[int],
                 input_nodes: Tuple[str, Optional[np.ndarray]],
                 batch_size: int = 1, shuffle: bool = False,
                 sampler_cls=HeteroNeighborSampler, seed: int = 0):
        self.data = data
        self.input_type, idx = input_nodes
        if idx is None:
            idx = np.arange(data[self.input_type].num_nodes)
        self.input_nodes = np.asarray(idx, np.int64)
        self.sampler = sampler_cls(data, num_neighbors, seed=seed)
        self.sampler.batch_size = batch_size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return (len(self.input_nodes) + self.batch_size - 1) \
            // self.batch_size

    def __iter__(self):
        order = (self.rng.permutation(len(self.input_nodes))
                 if self.shuffle else np.arange(len(self.input_nodes)))
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if len(idx) < self.batch_size:
                idx = np.concatenate(
                    [idx, np.zeros(self.batch_size - len(idx), np.int64)])
            seeds = self.input_nodes[idx]
            out = self.sampler.sample_from_nodes(
                self.input_type, NodeSamplerInput(node=seeds))
            yield _filter_hetero(self.data, out)


class HGTLoader(HeteroNeighborLoader):
    """(reference ``hgt_loader.py:11``)."""

    def __init__(self, data, num_samples, input_nodes, **kw):
        super().__init__(data, num_samples, input_nodes,
                         sampler_cls=HGTSampler, **kw)
