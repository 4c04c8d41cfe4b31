"""GraphSAINT samplers, ShaDowKHopSampler and the small sampling loaders.

Counterpart of ``pytorch_geometric_tpu/loader/graph_saint.py`` (reference
``torch_geometric/loader/graph_saint.py:11-199``, ``shadow.py:11``,
``random_node_loader.py``, ``imbalanced_sampler.py``,
``dynamic_batch_sampler.py``). The node sets, normalisers and batch order
are the JAX package's for the same seed, drawn on the host in numpy (the
random walks in the port's native ``random_walk`` where it builds); a
batch's node features, labels and masks are gathered where the ``Data``
holds them, on the card for a table kept there.
"""

from typing import Iterator, Optional

import numpy as np

from ..data.batch import Batch
from ..data.data import Data, host
from ..nn.models.node2vec import _CSR, random_walk
from .neighbor_loader import _rows


def _induced(data: Data, nodes: np.ndarray, coo: np.ndarray,
             node_norm=None, edge_norm_full=None) -> Data:
    """The subgraph of ``data`` induced by ``nodes`` (in that order): its
    COO relabelled, ``n_id`` / ``e_id``, the node and edge fields gathered
    where they lie, and the normalisers' entries when given."""
    keep = np.zeros(data.num_nodes, bool)
    keep[nodes] = True
    local = np.full(data.num_nodes, -1, np.int64)
    local[nodes] = np.arange(len(nodes))
    emask = keep[coo[0]] & keep[coo[1]]
    eidx = np.nonzero(emask)[0]
    sub = local[coo[:, eidx]].astype(np.int32)
    kwargs = {}
    if data.x is not None:
        kwargs['x'] = _rows(data.x, nodes)
    if data.y is not None and data.y.shape[0] == data.num_nodes:
        kwargs['y'] = _rows(data.y, nodes)
    for k in ('train_mask', 'val_mask', 'test_mask'):
        if data[k] is not None:
            kwargs[k] = _rows(data[k], nodes)
    if node_norm is not None:
        kwargs['node_norm'] = node_norm[nodes]
    if edge_norm_full is not None:
        kwargs['edge_norm'] = edge_norm_full[eidx]
    return Data(edge_index=sub, num_nodes=len(nodes), n_id=nodes,
                e_id=eidx, **kwargs)


class GraphSAINTSampler:
    """Base: pre-estimates node/edge sampling statistics for the
    unbiasedness normalisers (reference ``graph_saint.py:11``)."""

    def __init__(self, data: Data, batch_size: int,
                 num_steps: int = 1, sample_coverage: int = 0,
                 seed: int = 0):
        self.data = data
        self.batch_size = batch_size
        self.num_steps = num_steps
        self.sample_coverage = sample_coverage
        self.rng = np.random.default_rng(seed)
        self.coo = host(data.edge_index)
        self.node_norm = None
        self.edge_norm = None
        if sample_coverage > 0:
            self._estimate_norms()

    def _sample_nodes(self) -> np.ndarray:
        raise NotImplementedError

    def _estimate_norms(self):
        """Sample until every node was drawn ``sample_coverage`` times on
        average; ``edge_norm = clip(edge count / node count[dst], 0, 1e4)``
        and ``node_norm = samples / node count / N`` (reference)."""
        n = self.data.num_nodes
        e = self.coo.shape[1]
        node_cnt = np.zeros(n)
        edge_cnt = np.zeros(e)
        total = 0
        target = self.sample_coverage * n
        while node_cnt.sum() < target:
            nodes = np.unique(self._sample_nodes())
            node_cnt[nodes] += 1
            keep = np.zeros(n, bool)
            keep[nodes] = True
            edge_cnt[keep[self.coo[0]] & keep[self.coo[1]]] += 1
            total += 1
        node_cnt = np.maximum(node_cnt, 1)
        self.edge_norm = np.clip(
            edge_cnt / node_cnt[self.coo[1]], 0, 1e4).astype(np.float32)
        self.node_norm = (total / node_cnt / n).astype(np.float32)

    def __len__(self):
        return self.num_steps

    def __iter__(self) -> Iterator[Data]:
        for _ in range(self.num_steps):
            nodes = np.unique(self._sample_nodes())
            yield _induced(self.data, nodes, self.coo, self.node_norm,
                           self.edge_norm)


class GraphSAINTNodeSampler(GraphSAINTSampler):
    """(reference ``graph_saint.py:166``)."""

    def _sample_nodes(self):
        edge_sample = self.rng.integers(0, self.coo.shape[1],
                                        self.batch_size)
        return self.coo[0][edge_sample]


class GraphSAINTEdgeSampler(GraphSAINTSampler):
    """Degree-biased edge sampling (reference ``graph_saint.py:177``)."""

    def _sample_nodes(self):
        n = self.data.num_nodes
        deg = np.bincount(self.coo[0], minlength=n) \
            + np.bincount(self.coo[1], minlength=n)
        deg = np.maximum(deg, 1)
        p = 1.0 / deg[self.coo[0]] + 1.0 / deg[self.coo[1]]
        p = p / p.sum()
        es = self.rng.choice(self.coo.shape[1], self.batch_size, p=p)
        return np.concatenate([self.coo[0][es], self.coo[1][es]])


class GraphSAINTRandomWalkSampler(GraphSAINTSampler):
    """(reference ``graph_saint.py:199``): the nodes of ``batch_size``
    walks of ``walk_length`` steps from uniform roots. The graph's CSR is
    built once, not at every walk."""

    def __init__(self, data: Data, batch_size: int, walk_length: int = 2,
                 **kwargs):
        self.walk_length = walk_length
        self._csr = _CSR(data.edge_index, data.num_nodes)
        super().__init__(data, batch_size, **kwargs)

    def _sample_nodes(self):
        start = self.rng.integers(0, self.data.num_nodes,
                                  self.batch_size)
        walks = random_walk(self.rng, self._csr, self.data.num_nodes,
                            start, self.walk_length)
        return walks.reshape(-1)


class ShaDowKHopSampler:
    """Ego-subgraphs per seed (reference ``loader/shadow.py:11``)."""

    def __init__(self, data: Data, depth: int, num_neighbors: int,
                 node_idx: Optional[np.ndarray] = None,
                 batch_size: int = 1, shuffle: bool = False,
                 seed: int = 0):
        self.data = data
        self.depth = depth
        self.num_neighbors = num_neighbors
        self.coo = host(data.edge_index)
        n = data.num_nodes
        order = np.argsort(self.coo[1], kind='stable')
        self.row_sorted = self.coo[0][order]
        self.colptr = np.searchsorted(self.coo[1][order],
                                      np.arange(n + 1))
        if node_idx is None:
            node_idx = np.arange(n)
        else:
            node_idx = host(node_idx)
            if node_idx.dtype == bool:
                node_idx = np.nonzero(node_idx)[0]
        self.node_idx = node_idx
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def _ego(self, seed_node: int) -> np.ndarray:
        nodes = [seed_node]
        frontier = [seed_node]
        seen = {seed_node}
        for _ in range(self.depth):
            nxt = []
            for v in frontier:
                nbrs = self.row_sorted[self.colptr[v]:self.colptr[v + 1]]
                if len(nbrs) > self.num_neighbors:
                    nbrs = self.rng.choice(nbrs, self.num_neighbors,
                                           replace=False)
                for u in nbrs:
                    if int(u) not in seen:
                        seen.add(int(u))
                        nodes.append(int(u))
                        nxt.append(int(u))
            frontier = nxt
        return np.array(nodes, np.int64)

    def __len__(self):
        return (len(self.node_idx) + self.batch_size - 1) \
            // self.batch_size

    def __iter__(self):
        order = (self.rng.permutation(len(self.node_idx))
                 if self.shuffle else np.arange(len(self.node_idx)))
        for i in range(0, len(order), self.batch_size):
            graphs = []
            for j in order[i:i + self.batch_size]:
                nodes = self._ego(int(self.node_idx[j]))
                g = _induced(self.data, nodes, self.coo)
                graphs.append(g.replace(root_n_id=np.asarray([0])))
            yield Batch.from_data_list(graphs)


class RandomNodeLoader:
    """Random node-split induced subgraphs (reference
    ``random_node_loader.py``)."""

    def __init__(self, data: Data, num_parts: int, shuffle: bool = False,
                 seed: int = 0):
        self.data = data
        self.num_parts = num_parts
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.coo = host(data.edge_index)

    def __len__(self):
        return self.num_parts

    def __iter__(self):
        n = self.data.num_nodes
        order = self.rng.permutation(n)
        size = (n + self.num_parts - 1) // self.num_parts
        for i in range(0, n, size):
            nodes = np.sort(order[i:i + size])
            yield _induced(self.data, nodes, self.coo)


class ImbalancedSampler:
    """Class-balanced sampling weights (reference
    ``imbalanced_sampler.py``)."""

    def __init__(self, y, num_samples: Optional[int] = None,
                 seed: int = 0):
        y = host(y).reshape(-1)
        counts = np.bincount(y)
        self.weights = (1.0 / counts[y]).astype(np.float64)
        self.weights /= self.weights.sum()
        self.num_samples = num_samples or len(y)
        self.rng = np.random.default_rng(seed)
        self.n = len(y)

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        return iter(self.rng.choice(self.n, self.num_samples,
                                    p=self.weights))


class DynamicBatchSampler:
    """Token-budget batching (reference ``dynamic_batch_sampler.py:8``):
    groups graphs until ``max_num`` nodes (or edges) is reached."""

    def __init__(self, dataset, max_num: int, mode: str = 'node',
                 shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.max_num = max_num
        self.mode = mode
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = self.rng.permutation(order)
        batch, acc = [], 0
        for i in order:
            d = self.dataset[int(i)]
            size = d.num_nodes if self.mode == 'node' else d.num_edges
            if batch and acc + size > self.max_num:
                yield batch
                batch, acc = [], 0
            batch.append(int(i))
            acc += size
        if batch:
            yield batch
