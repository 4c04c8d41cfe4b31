"""ClusterData / ClusterLoader (Cluster-GCN) and the graph partitioner.

Counterpart of ``pytorch_geometric_tpu/loader/cluster.py`` (reference
``torch_geometric/loader/cluster.py:31,235``, which partitions through
METIS). The partitioner is the JAX package's: a multilevel scheme
(heavy-edge-matching coarsening, LDG streaming on the coarsest graph,
boundary refinement projected back level by level) run by the port's build
of ``csrc/partition.cpp`` (``csrc.partition_library``), with the numpy
pipeline kept for hosts without ``g++`` and for
``PGT_DISABLE_NATIVE_PARTITION``, the switch the JAX package reads. For one
graph and seed both paths give the JAX package's partition of the same path,
bit for bit.

``ClusterData.subgraph`` stitches the batch on the host (node and edge ids,
the batch's COO) and gathers ``x``, ``y``, ``edge_attr`` and the masks where
the ``Data`` holds them: a feature table on the card is gathered there by
``n_id`` and never copied to the host.
"""

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .. import csrc
from ..data.data import Data, host
from .neighbor_loader import _rows


def _sym_csr(coo, num_nodes):
    """Symmetrised weighted CSR (multi-edges collapse into weights)."""
    row = np.concatenate([coo[0], coo[1]])
    col = np.concatenate([coo[1], coo[0]])
    keep = row != col                        # self-loops never cut
    row, col = row[keep], col[keep]
    key = row.astype(np.int64) * num_nodes + col
    uniq, w = np.unique(key, return_counts=True)
    row = (uniq // num_nodes).astype(np.int64)
    col = (uniq % num_nodes).astype(np.int64)
    ptr = np.searchsorted(row, np.arange(num_nodes + 1))
    return ptr, col, w.astype(np.float64)


def _ldg_sweep(ptr, col, w, parts, num_parts, cap, num_passes, rng,
               num_nodes):
    """Sequential LDG streaming passes over a weighted CSR."""
    counts = np.bincount(parts, minlength=num_parts).astype(np.float64)
    for _ in range(num_passes):
        for v in rng.permutation(num_nodes):
            lo, hi = ptr[v], ptr[v + 1]
            if lo == hi:
                continue
            score = np.zeros(num_parts)
            np.add.at(score, parts[col[lo:hi]], w[lo:hi])
            score *= (1.0 - counts / cap)
            best = int(np.argmax(score))
            old = parts[v]
            if best != old and counts[best] < cap:
                counts[old] -= 1
                counts[best] += 1
                parts[v] = best
    return parts


def partition_graph(edge_index, num_nodes: int, num_parts: int,
                    num_passes: int = 4, seed: int = 0,
                    method: str = 'multilevel') -> np.ndarray:
    """Balanced edge-cut node partition: int32 ``[num_nodes]`` part ids.

    ``method='multilevel'`` (default): heavy-edge-matching coarsening, LDG
    on the coarsest graph and boundary refinement at every level, natively
    where the partitioner library builds; ``method='ldg'``: single-level LDG
    streaming. ``edge_index`` is a ``[2, E]`` array or tensor, or an
    ``EdgeIndex``."""
    coo = host(edge_index)
    rng = np.random.default_rng(seed)
    ptr, col, w = _sym_csr(coo, num_nodes)
    cap = 1.05 * num_nodes / num_parts
    if method == 'ldg' or num_nodes <= num_parts:
        parts = rng.integers(0, num_parts, num_nodes).astype(np.int32)
        return _ldg_sweep(ptr, col, w, parts, num_parts, cap,
                          num_passes, rng, num_nodes)
    native = _native_multilevel(ptr, col, w, num_nodes, num_parts, seed)
    if native is not None:
        return native
    return _multilevel(ptr, col, w, num_nodes, num_parts, rng)


def _native_multilevel(ptr, col, w, n, num_parts, seed):
    """The multilevel pipeline in ``csrc/partition.cpp`` (fine-node-weight
    aware balance); ``None`` when ``PGT_DISABLE_NATIVE_PARTITION`` is set or
    the library cannot be built (the numpy pipeline runs instead)."""
    if os.environ.get('PGT_DISABLE_NATIVE_PARTITION'):
        return None
    lib = csrc.partition_library()
    if lib is None:
        return None
    import ctypes
    ptr64 = np.ascontiguousarray(ptr, np.int64)
    col64 = np.ascontiguousarray(col, np.int64)
    wf = np.ascontiguousarray(w, np.float64)
    out = np.empty(n, np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.multilevel_partition(
        ptr64.ctypes.data_as(i64p), col64.ctypes.data_as(i64p),
        wf.ctypes.data_as(f64p), n, num_parts, seed if seed else 0,
        1.05, out.ctypes.data_as(i32p))
    return out


def _heavy_edge_matching(ptr, col, w, n, rng):
    """Greedy heavy-edge matching: visit nodes in random order, match
    each unmatched node with its heaviest unmatched neighbor. Returns
    [n] coarse-node id per fine node."""
    matched = np.full(n, -1, np.int64)
    order = rng.permutation(n)
    for v in order:
        if matched[v] >= 0:
            continue
        lo, hi = ptr[v], ptr[v + 1]
        nbrs = col[lo:hi]
        ww = w[lo:hi]
        free = matched[nbrs] < 0
        if free.any():
            u = nbrs[free][int(np.argmax(ww[free]))]
            matched[v] = v
            matched[u] = v
        else:
            matched[v] = v
    # compact coarse ids
    reps = np.unique(matched)
    cmap = np.zeros(n, np.int64)
    cmap[reps] = np.arange(len(reps))
    return cmap[matched], len(reps)


def _coarsen(ptr, col, w, cmap, nc, n):
    """Contract the weighted CSR along a matching."""
    row = np.repeat(np.arange(n), np.diff(ptr))
    crow, ccol = cmap[row], cmap[col]
    keep = crow != ccol
    key = crow[keep] * nc + ccol[keep]
    uniq, inv = np.unique(key, return_inverse=True)
    cw = np.bincount(inv, weights=w[keep])
    crow = uniq // nc
    ccol = uniq % nc
    cptr = np.searchsorted(crow, np.arange(nc + 1))
    return cptr, ccol, cw


def _refine(ptr, col, w, parts, num_parts, cap, rounds=4):
    """Boundary refinement: each round, every node's connectivity to each
    part (``S[v, p]``), then the positive-gain nodes moved greedily, the
    largest gain first, under the balance cap."""
    n = len(parts)
    row = np.repeat(np.arange(n), np.diff(ptr))
    for _ in range(rounds):
        S = np.zeros((n, num_parts))
        np.add.at(S, (row, parts[col]), w)
        cur = S[np.arange(n), parts]
        best = np.argmax(S, axis=1).astype(np.int32)
        gain = S[np.arange(n), best] - cur
        cand = np.nonzero((gain > 0) & (best != parts))[0]
        if len(cand) == 0:
            break
        cand = cand[np.argsort(-gain[cand], kind='stable')]
        counts = np.bincount(parts, minlength=num_parts).astype(
            np.float64)
        moved = 0
        for v in cand:
            b, o = best[v], parts[v]
            if counts[b] < cap and counts[o] > 1:
                counts[o] -= 1
                counts[b] += 1
                parts[v] = b
                moved += 1
        if moved == 0:
            break
    return parts


def _multilevel(ptr, col, w, n, num_parts, rng,
                coarsest: Optional[int] = None):
    """Multilevel scheme: HEM-coarsen until small, LDG-partition the
    coarsest graph, project back with boundary refinement per level."""
    coarsest = coarsest or max(64 * num_parts, 256)
    levels = []
    cur = (ptr, col, w, n)
    while cur[3] > coarsest and len(levels) < 30:
        cptr, ccol, cw, cn = cur
        cmap, nc = _heavy_edge_matching(cptr, ccol, cw, cn, rng)
        if nc >= cn * 0.95:          # matching stalled
            break
        levels.append((cur, cmap))
        cur = (*_coarsen(cptr, ccol, cw, cmap, nc, cn), nc)
    cptr, ccol, cw, cn = cur
    cap_c = 1.05 * cn / num_parts
    parts = rng.integers(0, num_parts, cn).astype(np.int32)
    parts = _ldg_sweep(cptr, ccol, cw, parts, num_parts, cap_c, 4, rng,
                       cn)
    parts = _refine(cptr, ccol, cw, parts, num_parts, cap_c)
    for (fptr, fcol, fw, fn), cmap in reversed(levels):
        parts = parts[cmap]
        parts = _refine(fptr, fcol, fw, parts, num_parts,
                        1.05 * fn / num_parts)
    if n <= 200_000 and levels:
        # one fine-level LDG polish pass: closes the gap on graphs
        # where HEM coarsening obscures fine structure (expanders)
        fptr, fcol, fw, fn = levels[0][0]
        parts = _ldg_sweep(fptr, fcol, fw, parts, num_parts,
                           1.05 * fn / num_parts, 1, rng, fn)
        parts = _refine(fptr, fcol, fw, parts, num_parts,
                        1.05 * fn / num_parts, rounds=2)
    return parts.astype(np.int32)


def _degrees(coo, num_nodes):
    return (np.bincount(coo[0], minlength=num_nodes)
            + np.bincount(coo[1], minlength=num_nodes))


def select_hubs(edge_index, num_nodes: int, hub_frac: float = 0.01,
                hub_threshold: Optional[int] = None) -> np.ndarray:
    """Boolean hub mask: the top ``hub_frac`` of nodes by (undirected)
    degree, or every node with degree > ``hub_threshold``."""
    deg = _degrees(host(edge_index), num_nodes)
    mask = np.zeros(num_nodes, bool)
    if hub_threshold is not None:
        mask[deg > hub_threshold] = True
        return mask
    k = max(int(hub_frac * num_nodes), 1)
    mask[np.argpartition(-deg, min(k, num_nodes - 1))[:k]] = True
    return mask


def partition_graph_hubs(edge_index, num_nodes: int, num_parts: int,
                         hub_frac: float = 0.01,
                         hub_threshold: Optional[int] = None,
                         seed: int = 0, method: str = 'multilevel'):
    """Hub-aware partition for power-law graphs: ``(parts, hub_mask)``.

    Hub-incident edges leave the cut objective (the partition-parallel
    step replicates hub features to every device); the residual graph is
    partitioned, then each hub, biggest first, joins the part holding most
    of its neighbours under the balance cap."""
    coo = host(edge_index)
    hub = select_hubs(coo, num_nodes, hub_frac, hub_threshold)
    resid = coo[:, ~hub[coo[0]] & ~hub[coo[1]]]
    parts = partition_graph(resid, num_nodes, num_parts, seed=seed,
                            method=method)
    hubs = np.nonzero(hub)[0]
    deg = _degrees(coo, num_nodes)
    hubs = hubs[np.argsort(-deg[hubs], kind='stable')]
    counts = np.bincount(parts, minlength=num_parts).astype(np.float64)
    counts -= np.bincount(parts[hubs], minlength=num_parts)  # re-place
    cap = 1.05 * num_nodes / num_parts
    # per-hub neighbor-part histogram from hub-incident edges
    inc = hub[coo[0]] | hub[coo[1]]
    hsrc, hdst = coo[0][inc], coo[1][inc]
    nbr_of = np.concatenate([np.where(hub[hsrc], hdst, hsrc),
                             np.where(hub[hdst], hsrc, hdst)])
    hub_of = np.concatenate([np.where(hub[hsrc], hsrc, hdst),
                             np.where(hub[hdst], hdst, hsrc)])
    ok = ~hub[nbr_of]
    nbr_of, hub_of = nbr_of[ok], hub_of[ok]
    order = np.argsort(hub_of, kind='stable')
    nbr_of, hub_of = nbr_of[order], hub_of[order]
    starts = np.searchsorted(hub_of, hubs)
    ends = np.searchsorted(hub_of, hubs, side='right')
    for i, v in enumerate(hubs):
        score = np.bincount(parts[nbr_of[starts[i]:ends[i]]],
                            minlength=num_parts).astype(np.float64)
        score[counts >= cap] = -1
        best = int(np.argmax(score))
        parts[v] = best
        counts[best] += 1
    return parts.astype(np.int32), hub


def effective_edge_cut(edge_index, parts, hub_mask) -> float:
    """Edge cut with hub-incident edges counted local (their features are
    replicated to every device); the denominator is every non-loop edge,
    as in :func:`edge_cut`."""
    coo = host(edge_index)
    keep = coo[0] != coo[1]
    if keep.sum() == 0:
        return 0.0
    cut = (parts[coo[0]] != parts[coo[1]]) & keep
    cut &= ~hub_mask[coo[0]] & ~hub_mask[coo[1]]
    return float(cut.sum() / keep.sum())


def edge_cut(edge_index, parts) -> float:
    """Fraction of (directed, non-loop) edges whose endpoints lie in
    different parts: the quality METIS minimises."""
    coo = host(edge_index)
    keep = coo[0] != coo[1]
    if keep.sum() == 0:
        return 0.0
    return float((parts[coo[0][keep]] != parts[coo[1][keep]]).mean())


@dataclass
class Partition:
    """(reference ``cluster.py:22``)."""
    partptr: np.ndarray    # [P+1] node offsets in permuted order
    node_perm: np.ndarray  # [N] permuted -> original node id
    parts: np.ndarray      # [N] original node -> part


class ClusterData:
    """Partition a graph into clusters (reference ``cluster.py:31``)."""

    def __init__(self, data: Data, num_parts: int,
                 keep_inter_cluster_edges: bool = False, seed: int = 0):
        self.data = data
        self.num_parts = num_parts
        self.keep_inter_cluster_edges = keep_inter_cluster_edges
        n = data.num_nodes
        coo = host(data.edge_index)
        parts = partition_graph(coo, n, num_parts, seed=seed)
        node_perm = np.argsort(parts, kind='stable')
        partptr = np.searchsorted(parts[node_perm],
                                  np.arange(num_parts + 1))
        self.partition = Partition(partptr, node_perm, parts)
        self._coo = coo
        # inverse: original -> permuted position
        self._inv = np.empty(n, np.int64)
        self._inv[node_perm] = np.arange(n)

    def __len__(self):
        return self.num_parts

    def subgraph(self, part_ids: List[int]) -> Data:
        """The subgraph induced by a set of clusters (reference
        ``cluster.py:235``, ``ClusterLoader.__collate__``): ids, COO and
        edge mask on the host, node and edge features gathered where they
        lie."""
        p = self.partition
        data = self.data
        n = data.num_nodes
        nodes = np.concatenate([p.node_perm[p.partptr[i]:p.partptr[i + 1]]
                                for i in part_ids])
        keep_mask = np.zeros(n, bool)
        keep_mask[nodes] = True
        local = np.full(n, -1, np.int64)
        local[nodes] = np.arange(len(nodes))
        coo = self._coo
        emask = keep_mask[coo[0]] & keep_mask[coo[1]]
        eidx = np.nonzero(emask)[0]
        sub = local[coo[:, eidx]].astype(np.int32)
        kwargs = {}
        if data.x is not None:
            kwargs['x'] = _rows(data.x, nodes)
        if data.y is not None and data.y.shape[0] == n:
            kwargs['y'] = _rows(data.y, nodes)
        if data.edge_attr is not None:
            kwargs['edge_attr'] = _rows(data.edge_attr, eidx)
        for k in ('train_mask', 'val_mask', 'test_mask'):
            if data[k] is not None:
                kwargs[k] = _rows(data[k], nodes)
        return Data(edge_index=sub, num_nodes=len(nodes),
                    n_id=nodes, e_id=eidx, **kwargs)

    def __getitem__(self, idx: int) -> Data:
        return self.subgraph([idx])


class ClusterLoader:
    """Random cluster combinations per batch (reference
    ``cluster.py:235``)."""

    def __init__(self, cluster_data: ClusterData, batch_size: int = 1,
                 shuffle: bool = False, seed: int = 0):
        self.cluster_data = cluster_data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        p = self.cluster_data.num_parts
        return (p + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        p = self.cluster_data.num_parts
        order = (self.rng.permutation(p) if self.shuffle
                 else np.arange(p))
        for i in range(0, p, self.batch_size):
            yield self.cluster_data.subgraph(
                [int(j) for j in order[i:i + self.batch_size]])
