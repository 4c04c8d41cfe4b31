"""Heterogeneous batching, padding-first.

Counterpart of ``pytorch_geometric_tpu/data/hetero_batch.py`` (reference
``data/batch.py`` + ``data/collate.py``'s hetero path: collation walks the
typed stores and offsets each edge type by its endpoint types' cumulative
node counts).

The same design as :class:`~.batch.Batch`: per-node-type and per-edge-type
budgets, so consecutive batches share one shape (one captured graph).
Padded edges point both endpoints at the padded node counts (segment ops
drop them); padded nodes carry a dump batch id. The fields are host tensors
with the JAX package's dtypes (:func:`.data.as_tensor`); ``edge_index`` is a
host :class:`EdgeIndex`.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .data import as_tensor, host
from .hetero_data import HeteroData, _Store
from ..edge_index import EdgeIndex

EdgeType = Tuple[str, str, str]


class HeteroBatch(HeteroData):
    """Disjoint union of HeteroData graphs; ``batch['paper'].batch`` is the
    per-type graph-assignment vector, ``batch['paper'].ptr`` the cumulative
    node counts."""

    @classmethod
    def from_hetero_list(cls, data_list: Sequence[HeteroData],
                         pad_num_nodes: Optional[Dict[str, int]] = None,
                         pad_num_edges: Optional[Dict[EdgeType, int]] = None
                         ) -> 'HeteroBatch':
        if len(data_list) == 0:
            raise ValueError('Cannot batch an empty list')
        node_types = data_list[0].node_types
        edge_types = data_list[0].edge_types
        for d in data_list[1:]:
            if d.node_types != node_types or d.edge_types != edge_types:
                raise ValueError('All graphs must share metadata')

        obj = object.__new__(cls)
        object.__setattr__(obj, '_node', {})
        object.__setattr__(obj, '_edge', {})
        object.__setattr__(obj, '_global', {})
        obj._num_graphs = len(data_list)
        obj._num_real = {}

        # graph-level attributes stack along a new leading graph axis
        gkeys = set()
        for d in data_list:
            gkeys |= set(d._global.keys())
        for k in gkeys:
            obj._global[k] = as_tensor(np.stack(
                [host(d._global[k]) for d in data_list], 0))

        counts: Dict[str, List[int]] = {}
        offsets: Dict[str, np.ndarray] = {}
        for t in node_types:
            counts[t] = [d[t].num_nodes or 0 for d in data_list]
            offsets[t] = np.cumsum([0] + counts[t])
            total = int(offsets[t][-1])
            pad = (pad_num_nodes or {}).get(t, total)
            if pad < total:
                raise ValueError(f"node budget for '{t}' too small: "
                                 f'need {total}, got {pad}')
            store: Dict[str, torch.Tensor] = {}
            keys = set()
            for d in data_list:
                keys |= set(d[t].keys())
            for k in keys:
                cat = np.concatenate([host(d[t].get(k)) for d in data_list],
                                     0)
                if cat.shape[0] == total and pad > total:
                    z = np.zeros((pad - total,) + cat.shape[1:], cat.dtype)
                    cat = np.concatenate([cat, z], 0)
                store[k] = as_tensor(cat)
            bvec = np.repeat(np.arange(len(data_list)), counts[t])
            if pad > total:
                bvec = np.concatenate(
                    [bvec, np.full(pad - total, len(data_list))])
            store['batch'] = as_tensor(bvec.astype(np.int32))
            store['ptr'] = as_tensor(offsets[t].astype(np.int32))
            obj._node[t] = store
            obj._num_real[t] = total

        for et in edge_types:
            src_t, _, dst_t = et
            total_e = int(sum(d[et].num_edges for d in data_list))
            pad_e = (pad_num_edges or {}).get(et, total_e)
            if pad_e < total_e:
                raise ValueError(f'edge budget for {et} too small: '
                                 f'need {total_e}, got {pad_e}')
            n_src = (pad_num_nodes or {}).get(src_t,
                                              int(offsets[src_t][-1]))
            n_dst = (pad_num_nodes or {}).get(dst_t,
                                              int(offsets[dst_t][-1]))
            store = {}
            keys = set()
            for d in data_list:
                keys |= set(d[et].keys())
            for k in keys:
                if k == 'edge_index':
                    coos = [host(d[et].edge_index) + np.array(
                        [[offsets[src_t][i]], [offsets[dst_t][i]]])
                        for i, d in enumerate(data_list)]
                    cat = (np.concatenate(coos, 1) if coos
                           else np.zeros((2, 0), np.int64))
                    if pad_e > total_e:
                        fill = np.array([[n_src], [n_dst]], cat.dtype)
                        cat = np.concatenate(
                            [cat, np.repeat(fill, pad_e - total_e, 1)], 1)
                    store[k] = EdgeIndex(as_tensor(cat), (n_src, n_dst),
                                         num_real_edges=total_e)
                else:
                    cat = np.concatenate(
                        [host(d[et].get(k)) for d in data_list], 0)
                    if cat.shape[0] == total_e and pad_e > total_e:
                        z = np.zeros((pad_e - total_e,) + cat.shape[1:],
                                     cat.dtype)
                        cat = np.concatenate([cat, z], 0)
                    store[k] = as_tensor(cat)
            store['edge_mask'] = torch.arange(pad_e) < total_e
            obj._edge[et] = store
            obj._num_real[et] = total_e
        return obj

    @property
    def num_graphs(self) -> int:
        return self._num_graphs

    def node_mask_dict(self) -> Dict[str, torch.Tensor]:
        """Per-type validity masks over (possibly padded) rows."""
        out = {}
        for t, s in self._node.items():
            n = _Store(s).num_nodes
            out[t] = torch.arange(n) < self._num_real[t]
        return out

    def to_hetero_list(self) -> List[HeteroData]:
        """Split back into individual graphs (host-side)."""
        out = []
        for g in range(self._num_graphs):
            h = HeteroData()
            for k, v in self._global.items():
                setattr(h, k, host(v)[g])
            for t, s in self._node.items():
                ptr = host(s['ptr'])
                lo, hi = int(ptr[g]), int(ptr[g + 1])
                for k, v in s.items():
                    if k in ('batch', 'ptr'):
                        continue
                    setattr(h[t], k, host(v)[lo:hi])
            for et, s in self._edge.items():
                src_t, _, dst_t = et
                sptr = host(self._node[src_t]['ptr'])
                slo, shi = int(sptr[g]), int(sptr[g + 1])
                dlo = int(host(self._node[dst_t]['ptr'])[g])
                coo = host(s['edge_index'])
                em = host(s['edge_mask']) & (coo[0] >= slo) & (coo[0] < shi)
                h[et].edge_index = np.stack(
                    [coo[0][em] - slo, coo[1][em] - dlo])
                for k, v in s.items():
                    if k in ('edge_index', 'edge_mask'):
                        continue
                    va = host(v)
                    if va.ndim >= 1 and va.shape[0] == em.shape[0]:
                        setattr(h[et], k, va[em])
            out.append(h)
        return out
