"""IBMB: influence-based mini-batching (reference
``torch_geometric/loader/ibmb_loader.py:555,702``, Gasteiger et al.,
"Influence-Based Mini-Batching for GNNs").

Counterpart of ``pytorch_geometric_tpu/loader/ibmb.py``: the batches, their
output nodes and their order are the JAX package's for the same seed, built
on the host in numpy and scipy; a batch's node features, labels and masks
are gathered where the ``Data`` holds them (``graph_saint._induced``).

Node-wise: per-output top-k PPR auxiliary sets (``topk_ppr_matrix``),
outputs merged by pairwise PPR mass (``prime_orient_merge`` union-find
sweep + ``prime_post_process`` heap merge). Batch-wise: graph
partitions seed the batches; auxiliary nodes come from topic-sensitive
PPR power iteration over each partition's outputs
(``create_batchwise_out_aux_pairs``). Batch ordering: pairwise KL
divergence between batch label distributions, consumed by a greedy
nearest-neighbour tour ('order'; the reference calls python_tsp's
simulated annealing) or distance-weighted sampling ('sample').
"""

from heapq import heapify, heappop, heappush
from typing import Iterator, List, Optional

import numpy as np

from ..data.data import Data, host
from ..utils.extra import ppr
from .cluster import partition_graph
from .graph_saint import _induced


# ---------------------------------------------------------------- order
def get_pair_wise_distance(ys: List[np.ndarray], num_classes: int,
                           dist_type: str = 'kl') -> np.ndarray:
    """Pairwise symmetric KL (or L1) between batch label distributions
    (reference ``ibmb_loader.py:99-134``)."""
    nb = len(ys)
    counts = np.zeros((nb, num_classes), np.float64)
    for i, y in enumerate(ys):
        u, c = np.unique(np.asarray(y).astype(np.int64),
                         return_counts=True)
        counts[i, u] = c
    counts += 1
    counts /= counts.sum(1, keepdims=True)
    dist = np.zeros((nb, nb))
    for i in range(nb - 1):
        for j in range(i + 1, nb):
            p, q = counts[i], counts[j]
            if dist_type == 'l1':
                dist[i, j] = np.abs(p - q).sum()
            else:
                dist[i, j] = (p * np.log(p / q)).sum() \
                    + (q * np.log(q / p)).sum()
    dist += dist.T
    dist += 1e-5
    np.fill_diagonal(dist, 0.0)
    return dist


def _order_batches(ys, num_classes, batch_order, rng):
    """Index order per epoch (reference ``define_sampler``,
    ``ibmb_loader.py:189-212``)."""
    nb = len(ys)
    if nb <= 2 or batch_order == 'rand':
        return rng.permutation(nb)
    dist = get_pair_wise_distance(ys, num_classes)
    if batch_order == 'order':
        # greedy nearest-neighbor tour over the KL distances (stand-in
        # for the reference's python_tsp simulated annealing)
        left = set(range(nb))
        cur = 0
        tour = [cur]
        left.remove(cur)
        while left:
            cur = min(left, key=lambda j: dist[cur, j])
            tour.append(cur)
            left.remove(cur)
        return np.array(tour)
    # 'sample': next batch drawn with prob ~ distance from the last
    # (reference IBMBWeightedSampler)
    order = [int(rng.integers(nb))]
    left = set(range(nb)) - set(order)
    while left:
        cand = np.array(sorted(left))
        w = dist[order[-1], cand]
        w = w / w.sum()
        order.append(int(rng.choice(cand, p=w)))
        left.remove(order[-1])
    return np.array(order)


# ---------------------------------------------------------------- merge
def get_pairs(ppr_sub) -> np.ndarray:
    """Output-pair list sorted by symmetrized PPR mass, heaviest first
    (reference ``get_pairs``, ``ibmb_loader.py:292``). Accepts a dense
    array or a ``scipy.sparse`` matrix (the reference works on sparse
    PPR matrices throughout — dense is O(N^2) host memory)."""
    import scipy.sparse as sp
    if sp.issparse(ppr_sub):
        m = (ppr_sub + ppr_sub.T).tocoo()
        keep = (m.row < m.col) & (m.data > 0)
        row, col, vals = m.row[keep], m.col[keep], m.data[keep]
    else:
        m = ppr_sub + ppr_sub.T
        iu = np.triu_indices(m.shape[0], k=1)
        vals = m[iu]
        nz = vals > 0
        row, col, vals = iu[0][nz], iu[1][nz], vals[nz]
    order = np.argsort(vals)[::-1]
    return np.stack([row[order], col[order]], 1)


def prime_orient_merge(ppr_pairs: np.ndarray, primes_per_batch: int,
                       num_nodes: int) -> List[List[int]]:
    """Union-find sweep over the heaviest PPR pairs under the batch-size
    cap (reference ``_prime_orient_merge``, ``ibmb_loader.py:326``)."""
    groups = [[i] for i in range(num_nodes)]
    owner = np.arange(num_nodes)
    for i, j in ppr_pairs:
        a, b = owner[i], owner[j]
        if a > b:
            a, b = b, a
        if a != b and len(groups[a]) + len(groups[b]) \
                <= primes_per_batch:
            groups[a].extend(groups[b])
            for v in groups[b]:
                owner[v] = a
            groups[b] = []
    return [g for g in groups if g]


def prime_post_process(groups: List[List[int]],
                       merge_max_size: int) -> List[List[int]]:
    """Heap-merge small groups up to the cap (reference
    ``prime_post_process``, ``ibmb_loader.py:356``)."""
    h = [(len(p), i, p) for i, p in enumerate(groups)]
    heapify(h)
    nxt = len(groups)
    while len(h) > 1:
        l1, _, p1 = heappop(h)
        l2, _, p2 = heappop(h)
        if l1 + l2 <= merge_max_size:
            heappush(h, (l1 + l2, nxt, p1 + p2))
            nxt += 1
        else:
            heappush(h, (l1, nxt, p1))
            heappush(h, (l2, nxt + 1, p2))
            break
    return [p for _, _, p in sorted(h)]


def ppr_power_method(adj_rw, sets: List[np.ndarray],
                     topk: int, num_iter: int,
                     alpha: float) -> List[np.ndarray]:
    """Topic-sensitive PPR for several teleport sets at once (reference
    ``ppr_power_method``, ``ibmb_loader.py:223``); adj_rw is the
    row-normalised transposed adjacency (dense or ``scipy.sparse`` —
    the iterate stays dense ``[N, num_sets]`` either way)."""
    n = adj_rw.shape[0]
    logits = np.zeros((n, len(sets)))
    for i, s in enumerate(sets):
        logits[s, i] = 1.0 / len(s)
    new = logits.copy()
    for _ in range(num_iter):
        new = np.asarray(adj_rw @ new) * (1 - alpha) + alpha * logits
    out = []
    for i in range(len(sets)):
        nz = int(min((new[:, i] > 0).sum(), topk))
        out.append(np.argsort(new[:, i])[-nz:])
    return out


# -------------------------------------------------------------- loaders
class IBMBNodeLoader:
    """Node-wise IBMB (reference ``ibmb_loader.py:702``): per-output
    top-``num_auxiliary_nodes`` PPR neighbors; outputs merged into
    batches of ``num_nodes_per_batch`` by pairwise PPR mass."""

    def __init__(self, data: Data, batch_order: str = 'order',
                 output_indices: Optional[np.ndarray] = None,
                 input_nodes: Optional[np.ndarray] = None,
                 num_nodes_per_batch: int = 64,
                 num_auxiliary_nodes: int = 128,
                 alpha: float = 0.2, eps: float = 1e-5, seed: int = 0):
        assert batch_order in ('rand', 'sample', 'order')
        self.data = data
        self.coo = host(data.edge_index)
        self.batch_order = batch_order
        n = data.num_nodes
        if output_indices is None:
            output_indices = (np.arange(n) if input_nodes is None
                              else host(input_nodes))
        self.output_indices = host(output_indices)
        self.rng = np.random.default_rng(seed)

        import scipy.sparse as sp
        coo_p, vals = ppr(self.coo, n, alpha=alpha, eps=eps)
        # sparse PPR matrix throughout (the reference's topk_ppr_matrix
        # is scipy CSR; a dense [N, N] would be O(N^2) host memory)
        mat = sp.csr_matrix((vals, (coo_p[0], coo_p[1])), shape=(n, n))

        # per-output top-k auxiliary sets (reference topk_ppr_matrix)
        rows = mat[self.output_indices]
        k = min(num_auxiliary_nodes, n)
        self._neighbors = []
        for i in range(len(self.output_indices)):
            r0, r1 = rows.indptr[i], rows.indptr[i + 1]
            cols, dat = rows.indices[r0:r1], rows.data[r0:r1]
            order = np.argsort(dat)[-k:]
            top = cols[order][dat[order] > 0]
            self._neighbors.append(
                np.union1d(top, [self.output_indices[i]]))

        pairs = get_pairs(rows[:, self.output_indices])
        groups = prime_orient_merge(pairs, num_nodes_per_batch,
                                    len(self.output_indices))
        groups = prime_post_process(groups, num_nodes_per_batch)
        self._pairs = []
        for g in groups:
            outs = self.output_indices[g]
            aux = np.unique(np.concatenate(
                [self._neighbors[i] for i in g]))
            self._pairs.append((outs, aux))
        covered = np.unique(np.concatenate(
            [o for o, _ in self._pairs]))
        assert np.array_equal(covered, np.unique(self.output_indices))
        self._ys = ([host(data.y)[o] for o, _ in self._pairs]
                    if data.y is not None else None)

    def __len__(self):
        return len(self._pairs)

    def _iter_order(self):
        if self._ys is None or self.batch_order == 'rand':
            return self.rng.permutation(len(self._pairs))
        num_classes = int(max(int(host(self.data.y).max()) + 1, 2))
        return _order_batches(self._ys, num_classes, self.batch_order,
                              self.rng)

    def __iter__(self) -> Iterator[Data]:
        for bi in self._iter_order():
            outs, aux = self._pairs[bi]
            nodes = np.unique(np.concatenate([outs, aux]))
            batch = _induced(self.data, nodes, self.coo)
            local = {int(v): kk for kk, v in enumerate(nodes)}
            out_local = np.array([local[int(v)] for v in outs], np.int64)
            yield batch.replace(output_node_mask=np.isin(
                np.arange(len(nodes)), out_local))


class IBMBBatchLoader:
    """Batch-wise IBMB (reference ``ibmb_loader.py:555``): METIS-style
    partitions seed the batches; each batch = one partition's output
    nodes + the top-``ceil(expand * N / P)`` topic-sensitive-PPR nodes
    of that output set (power iteration, reference
    ``create_batchwise_out_aux_pairs``)."""

    def __init__(self, data: Data, batch_order: str = 'order',
                 num_partitions: int = 4,
                 input_nodes: Optional[np.ndarray] = None,
                 batch_expand_ratio: float = 1.0,
                 metis_input_node_weight: Optional[float] = None,
                 alpha: float = 0.2,
                 approximate_ppr_iterations: int = 50, seed: int = 0):
        assert batch_order in ('rand', 'sample', 'order')
        self.data = data
        self.coo = host(data.edge_index)
        self.batch_order = batch_order
        n = data.num_nodes
        if input_nodes is None:
            input_nodes = np.arange(n)
        elif host(input_nodes).dtype == bool:
            input_nodes = np.nonzero(host(input_nodes))[0]
        self.input_nodes = host(input_nodes)
        self.rng = np.random.default_rng(seed)

        # metis_input_node_weight biases METIS toward balancing the
        # output nodes; our LDG/multilevel partitioner balances node
        # counts only — the weight is accepted for API parity and the
        # balance bias is approximated by partitioning as usual (the
        # output sets below still cover every input node exactly once)
        parts = partition_graph(self.coo, n, num_partitions, seed=seed)
        in_set = np.zeros(n, bool)
        in_set[self.input_nodes] = True
        part_outputs = [np.nonzero((parts == p) & in_set)[0]
                        for p in range(num_partitions)]
        part_outputs = [o for o in part_outputs if len(o)]

        # row-normalised transposed adjacency for the power method
        # (reference create_adj_from_edge_index(normalization='rw')) —
        # scipy CSR, not dense: O(E) host memory at the graph scales
        # IBMB targets
        import math

        import scipy.sparse as sp
        A = sp.csr_matrix(
            (np.ones(self.coo.shape[1]), (self.coo[1], self.coo[0])),
            shape=(n, n))
        deg = np.asarray(A.sum(1)).ravel()
        adj_rw = sp.diags(1.0 / np.maximum(deg, 1)) @ A
        topk = math.ceil(batch_expand_ratio * n / num_partitions)
        nbrs = ppr_power_method(adj_rw, part_outputs, topk,
                                approximate_ppr_iterations, alpha)
        self._pairs = [(outs, np.union1d(outs, aux))
                       for outs, aux in zip(part_outputs, nbrs)]
        self._ys = ([host(data.y)[o] for o, _ in self._pairs]
                    if data.y is not None else None)

    def __len__(self):
        return len(self._pairs)

    def _iter_order(self):
        if self._ys is None or self.batch_order == 'rand':
            return self.rng.permutation(len(self._pairs))
        num_classes = int(max(int(host(self.data.y).max()) + 1, 2))
        return _order_batches(self._ys, num_classes, self.batch_order,
                              self.rng)

    def __iter__(self) -> Iterator[Data]:
        for bi in self._iter_order():
            outs, aux = self._pairs[bi]
            nodes = np.unique(np.concatenate([outs, aux]))
            batch = _induced(self.data, nodes, self.coo)
            local = {int(v): kk for kk, v in enumerate(nodes)}
            out_local = np.array([local[int(v)] for v in outs], np.int64)
            yield batch.replace(output_node_mask=np.isin(
                np.arange(len(nodes)), out_local))
