"""Legacy GraphSAGE-style ``NeighborSampler`` loader.

Counterpart of ``pytorch_geometric_tpu/loader/legacy.py`` (reference
``torch_geometric/loader/neighbor_sampler.py:31``), on the port's sampler
(``sampler/neighbor_sampler.py``, native where it builds): the same seed
gives the JAX package's batches. Yields ``(batch_size, n_id, adjs)`` where
``adjs`` is one bipartite ``EdgeIndexAdj(edge_index, e_id, size)`` per
layer in *reverse* order: messages flow from the largest node set down to
the seed nodes (reference ``:168-193`` ``sample``).

One ``sample_from_nodes`` call covers all layers; per-layer adjacencies are
carved out of the per-hop edge slots and trimmed to their real counts, on
the host. The fixed-shape path for a captured step is ``NeighborLoader``.
"""

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..data.data import Data, host
from ..sampler import NodeSamplerInput
from ..sampler.neighbor_sampler import NeighborSampler as _Sampler

__all__ = ['NeighborSampler', 'EdgeIndexAdj']


class EdgeIndexAdj(NamedTuple):
    """One bipartite layer: local ``[2, E]`` edge_index, global edge ids,
    and ``(num_src, num_dst)`` size (reference ``EdgeIndex`` NamedTuple,
    ``loader/neighbor_sampler.py:9``)."""
    edge_index: np.ndarray
    e_id: Optional[np.ndarray]
    size: Tuple[int, int]

    def to(self, *args, **kwargs):  # device-move parity no-op
        return self


class NeighborSampler:
    """Iterable over seed-node batches yielding layered bipartite graphs
    (reference ``loader/neighbor_sampler.py:31``)."""

    def __init__(self, edge_index, sizes: Sequence[int],
                 node_idx: Optional[np.ndarray] = None,
                 num_nodes: Optional[int] = None,
                 return_e_id: bool = True,
                 transform: Optional[Callable] = None,
                 batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, **kwargs):
        if isinstance(edge_index, Data):
            data = edge_index
            num_nodes = data.num_nodes
        else:
            coo = host(edge_index)
            if num_nodes is None:
                num_nodes = int(coo.max()) + 1 if coo.size else 0
            data = (coo, num_nodes)
        self.sizes = list(sizes)
        self.return_e_id = return_e_id
        self.transform = transform
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._sampler = _Sampler(data, num_neighbors=self.sizes,
                                 seed=seed)
        if node_idx is None:
            node_idx = np.arange(num_nodes, dtype=np.int64)
        else:
            node_idx = host(node_idx)
            if node_idx.dtype == bool:
                node_idx = np.nonzero(node_idx)[0]
        self.node_idx = node_idx.astype(np.int64)

    def sample(self, batch) -> tuple:
        seeds = np.asarray(batch, np.int64)
        out = self._sampler.sample_from_nodes(NodeSamplerInput(seeds))
        n_counts = np.cumsum(out.num_sampled_nodes)
        edge_caps = self._sampler.num_neighbors.edge_budget(len(seeds))
        adjs: List[EdgeIndexAdj] = []
        e_off = 0
        for hop, cap in enumerate(edge_caps):
            real = out.num_sampled_edges[hop]
            sl = slice(e_off, e_off + real)
            # sampler rows are src, cols are dst — stacked in the
            # reference's (src, dst) row order
            edge_index = np.stack([out.row[sl], out.col[sl]])
            e_id = out.edge[sl] if self.return_e_id else None
            size = (int(n_counts[hop + 1]), int(n_counts[hop]))
            adjs.append(EdgeIndexAdj(edge_index, e_id, size))
            e_off += cap
        adjs = adjs[0] if len(adjs) == 1 else adjs[::-1]
        n_id = out.node[:int(n_counts[-1])]
        result = (len(seeds), n_id, adjs)
        return self.transform(*result) if self.transform else result

    def __iter__(self):
        order = self.node_idx
        if self.shuffle:
            order = self._rng.permutation(order)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            yield self.sample(chunk)

    def __len__(self) -> int:
        n = len(self.node_idx)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __repr__(self) -> str:
        return f'{self.__class__.__name__}(sizes={self.sizes})'
