"""Disjoint-union batching of graphs, padding-first.

Counterpart of ``pytorch_geometric_tpu/data/batch.py`` (reference
``torch_geometric/data/batch.py:57`` + ``collate.py:37``): concatenate
attributes along ``cat_dim``, offset index-like attributes by cumulative node
counts, build the ``batch`` assignment vector and ``ptr``.

Batching happens on the host (numpy) because graph sizes vary; the result is
optionally padded to static (num_nodes, num_edges) budgets, so consecutive
batches share one shape (one captured graph). Padding convention: padded
nodes are all-zero rows appended at the end; padded edges point both
endpoints at ``num_nodes`` (segment ops drop them). The fields are host
tensors with the JAX package's dtypes (:func:`.data.as_tensor`);
``edge_index`` is a host :class:`EdgeIndex`.
"""

from typing import List, Optional, Sequence

import numpy as np
import torch

from .data import Data, as_tensor, host
from ..edge_index import EdgeIndex


class Batch(Data):
    """A Data holding a disjoint union, plus ``batch`` / ``ptr`` vectors."""

    @classmethod
    def from_data_list(cls, data_list: Sequence[Data],
                       pad_num_nodes: Optional[int] = None,
                       pad_num_edges: Optional[int] = None,
                       follow_batch: Sequence[str] = ()) -> 'Batch':
        if len(data_list) == 0:
            raise ValueError('Cannot batch an empty list')

        num_graphs = len(data_list)
        node_counts = [d.num_nodes for d in data_list]
        edge_counts = [d.num_edges for d in data_list]
        total_nodes = int(sum(node_counts))
        total_edges = int(sum(edge_counts))
        pad_n = pad_num_nodes if pad_num_nodes is not None else total_nodes
        pad_e = pad_num_edges if pad_num_edges is not None else total_edges
        if pad_n < total_nodes or pad_e < total_edges:
            raise ValueError(
                f'Padding budget too small: need ({total_nodes} nodes, '
                f'{total_edges} edges), got ({pad_n}, {pad_e})')

        keys = set()
        for d in data_list:
            keys |= set(d.keys())

        out = {}
        node_offsets = np.cumsum([0] + node_counts)
        for key in keys:
            vals = []
            for i, d in enumerate(data_list):
                v = d[key]
                if v is None:
                    raise ValueError(f"Attribute '{key}' missing on graph "
                                     f"{i}; all graphs must share keys")
                v = host(v)
                if (Data.cat_dim(key, v) == 1 or key == 'edge_index'
                        or 'index' in key):
                    v = v + node_offsets[i]
                vals.append(v)
            dim = 1 if (key == 'edge_index' or (vals[0].ndim == 2
                        and key == 'face')) else 0
            cat = np.concatenate(vals, axis=dim)

            # pad to budget
            if key == 'edge_index' or key == 'face':
                if cat.shape[1] < pad_e and key == 'edge_index':
                    pad = np.full((2, pad_e - cat.shape[1]), pad_n, cat.dtype)
                    cat = np.concatenate([cat, pad], axis=1)
            elif cat.shape[0] == total_edges and total_edges != total_nodes:
                if cat.shape[0] < pad_e:
                    pad = np.zeros((pad_e - cat.shape[0],) + cat.shape[1:],
                                   cat.dtype)
                    cat = np.concatenate([cat, pad], axis=0)
            elif cat.shape[0] == total_nodes:
                if cat.shape[0] < pad_n:
                    pad = np.zeros((pad_n - cat.shape[0],) + cat.shape[1:],
                                   cat.dtype)
                    cat = np.concatenate([cat, pad], axis=0)
            out[key] = as_tensor(cat)

        batch_vec = np.repeat(np.arange(num_graphs), node_counts)
        if pad_n > total_nodes:
            # padded nodes go to a dump graph id == num_graphs
            batch_vec = np.concatenate(
                [batch_vec, np.full(pad_n - total_nodes, num_graphs)])

        obj = object.__new__(cls)
        store = dict(out)
        store['batch'] = as_tensor(batch_vec.astype(np.int32))
        store['ptr'] = as_tensor(node_offsets.astype(np.int32))
        if 'edge_index' in store:
            store['edge_index'] = EdgeIndex(store['edge_index'],
                                            (pad_n, pad_n),
                                            num_real_edges=total_edges)
        obj._store = store
        obj._num_nodes = pad_n
        obj._num_graphs = num_graphs
        obj._num_real_nodes = total_nodes
        obj._num_real_edges = total_edges
        return obj

    @property
    def num_graphs(self) -> int:
        return self._num_graphs

    @property
    def num_real_nodes(self) -> int:
        return self._num_real_nodes

    @property
    def num_real_edges(self) -> int:
        return self._num_real_edges

    @property
    def node_mask(self) -> torch.Tensor:
        """Validity mask over (possibly padded) node rows."""
        return torch.arange(self.num_nodes) < self._num_real_nodes

    def to_data_list(self) -> List[Data]:
        """Split back into individual graphs (host-side; reference
        ``separate.py``)."""
        ptr = host(self.ptr)
        coo = host(self.edge_index)
        out = []
        for g in range(self._num_graphs):
            lo, hi = int(ptr[g]), int(ptr[g + 1])
            emask = ((coo[0] >= lo) & (coo[0] < hi) if coo.size else
                     np.zeros(0, bool))
            sub = {}
            for k, v in self._store.items():
                if k in ('batch', 'ptr'):
                    continue
                va = host(v)
                if k == 'edge_index':
                    sub[k] = va[:, emask] - lo
                elif va.ndim >= 1 and va.shape[0] == self.num_nodes:
                    sub[k] = va[lo:hi]
                elif va.ndim >= 1 and va.shape[0] == coo.shape[1]:
                    sub[k] = va[emask]
                elif va.ndim >= 1 and va.shape[0] == self._num_graphs:
                    sub[k] = va[g:g + 1]
                else:
                    sub[k] = va
            out.append(Data(num_nodes=hi - lo, **sub))
        return out
