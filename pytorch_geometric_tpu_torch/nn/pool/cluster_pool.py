"""Cluster-based pooling: graclus, avg_pool / max_pool, EdgePooling,
ASAPooling, MemPooling and ClusterPooling.

Counterpart of ``pytorch_geometric_tpu/nn/pool/cluster_pool.py`` (reference
``torch_geometric/nn/pool/graclus.py``, ``avg_pool.py``, ``max_pool.py``,
``edge_pool.py``, ``asap.py``, ``mem_pool.py`` and ``cluster_pool.py``).
The greedy matchings, the merges and the union-find run on the host in
numpy, as in the JAX package, with the same arithmetic: one seed gives the
same clusters, bit for bit. The scores they read come from the device,
and the learned parts run on the device of their input.
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..inits import linear
from ...backend import resolve_device
from ...data.data import host
from ...ops import scatter, softmax as segment_softmax


def _coo(edge_index):
    return edge_index.coo if hasattr(edge_index, 'coo') else edge_index


def graclus(edge_index, num_nodes: int, edge_weight=None,
            seed: int = 0) -> np.ndarray:
    """Greedy heavy-edge matching on the host (reference ``graclus.py`` ->
    torch-cluster): nodes in a seeded random order each take their
    heaviest unmatched neighbour. Returns the cluster ids (not made
    consecutive)."""
    coo = host(edge_index)
    w = (host(edge_weight) if edge_weight is not None
         else np.ones(coo.shape[1]))
    rng = np.random.default_rng(seed)
    cluster = np.full(num_nodes, -1, np.int64)
    order = rng.permutation(num_nodes)
    by_src = {}
    for e in range(coo.shape[1]):
        by_src.setdefault(int(coo[0, e]), []).append(
            (int(coo[1, e]), float(w[e])))
    nxt = 0
    for v in order:
        if cluster[v] >= 0:
            continue
        best, best_w = -1, -1.0
        for u, wt in by_src.get(int(v), ()):
            if cluster[u] < 0 and u != v and wt > best_w:
                best, best_w = u, wt
        cluster[v] = nxt
        if best >= 0:
            cluster[best] = nxt
        nxt += 1
    return cluster


def _consecutive(cluster: np.ndarray) -> Tuple[np.ndarray, int]:
    uniq, inv = np.unique(cluster, return_inverse=True)
    return inv, len(uniq)


def avg_pool(cluster, data):
    """The graph coarsened by ``cluster`` with mean features (reference
    ``avg_pool.py``), on the host; returns a ``Data``."""
    return _pool(cluster, data, 'mean')


def max_pool(cluster, data):
    """As :func:`avg_pool` with max features (reference ``max_pool.py``); a
    cluster without rows gets 0."""
    return _pool(cluster, data, 'max')


def _pool(cluster, data, reduce):
    from ...data.data import Data
    from ...utils.coalesce import coalesce
    cluster, k = _consecutive(host(cluster))
    x = host(data.x)
    out = np.zeros((k, x.shape[1]), x.dtype)
    if reduce == 'mean':
        cnt = np.bincount(cluster, minlength=k)
        np.add.at(out, cluster, x)
        out = out / np.maximum(cnt[:, None], 1)
    else:
        out[:] = -np.inf
        np.maximum.at(out, cluster, x)
        out[~np.isfinite(out)] = 0
    new_coo = cluster[host(data.edge_index)]
    keep = new_coo[0] != new_coo[1]
    new_coo = coalesce(new_coo[:, keep], num_nodes=k) if keep.any() \
        else np.zeros((2, 0), np.int64)
    kwargs = {}
    if data.pos is not None:
        pos = host(data.pos)
        ps = np.zeros((k, pos.shape[1]))
        np.add.at(ps, cluster, pos)
        kwargs['pos'] = (ps / np.maximum(
            np.bincount(cluster, minlength=k)[:, None], 1)).astype(
                np.float32)
    return Data(x=out, edge_index=new_coo.astype(np.int32),
                num_nodes=k, cluster=cluster, **kwargs)


def avg_pool_x(cluster: torch.Tensor, x: torch.Tensor,
               num_clusters: int) -> torch.Tensor:
    """Mean of x's rows per cluster (reference ``avg_pool.py:avg_pool_x``)."""
    return scatter(x, cluster, num_clusters, 'mean')


def max_pool_x(cluster: torch.Tensor, x: torch.Tensor,
               num_clusters: int) -> torch.Tensor:
    """Max of x's rows per cluster (reference ``max_pool.py:max_pool_x``)."""
    return scatter(x, cluster, num_clusters, 'max')


def _edge_score(raw, method, dst, n):
    if method == 'softmax':
        return segment_softmax(raw, dst, n)
    if method == 'tanh':
        return torch.tanh(raw)
    return torch.sigmoid(raw)


class EdgePooling(nn.Module):
    """Edge-contraction pooling (reference ``edge_pool.py``): each edge
    scored on the device from its two ends (``lin`` over ``[x_src,
    x_dst]``, then a per-destination softmax, ``tanh`` or ``sigmoid``,
    plus ``add_to_edge_score``), then the highest-scoring edges that share
    no node merged greedily on the host (:meth:`merge`)."""

    def __init__(self, in_channels: int, edge_score_method: str = 'softmax',
                 add_to_edge_score: float = 0.5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.edge_score_method = edge_score_method
        self.add_to_edge_score = add_to_edge_score
        self.lin = linear(2 * in_channels, 1, device=resolve_device(device),
                          generator=generator)

    def compute_edge_score(self, x, edge_index) -> torch.Tensor:
        coo = _coo(edge_index).long()
        raw = self.lin(torch.cat([x[coo[0]], x[coo[1]]], -1))[:, 0]
        score = _edge_score(raw, self.edge_score_method, coo[1], x.shape[0])
        return score + self.add_to_edge_score

    def forward(self, x, edge_index) -> torch.Tensor:
        return self.compute_edge_score(x, edge_index)

    @staticmethod
    def merge(x, edge_index, score):
        """Greedy contraction on the host (reference
        ``edge_pool.py:_merge_edges``): edges in the order of a stable sort
        of ``-score``, each taken when neither end is merged yet (a self
        edge may be taken); left-over nodes stay alone with score 1.
        Returns numpy ``(new_x, new_edge_index, cluster)``: the merged rows
        summed and scaled by their edge's score, the edges relabelled and
        coalesced, self loops kept."""
        from ...utils.coalesce import coalesce
        x, coo, score = host(x), host(edge_index), host(score)
        n = x.shape[0]
        order = np.argsort(-score, kind='stable')
        cluster = np.full(n, -1, np.int64)
        nxt = 0
        chosen_score = []
        for e in order:
            s, d = int(coo[0, e]), int(coo[1, e])
            if cluster[s] >= 0 or cluster[d] >= 0:
                continue
            cluster[s] = cluster[d] = nxt
            chosen_score.append(float(score[e]))
            nxt += 1
        for v in range(n):
            if cluster[v] < 0:
                cluster[v] = nxt
                chosen_score.append(1.0)
                nxt += 1
        chosen = np.asarray(chosen_score, x.dtype)
        new_x = np.zeros((nxt, x.shape[1]), x.dtype)
        np.add.at(new_x, cluster, x)
        new_x = new_x * chosen[:, None]
        new_coo = coalesce(cluster[coo], num_nodes=nxt)
        return new_x, new_coo.astype(np.int32), cluster


class ASAPooling(nn.Module):
    """Adaptive structure-aware pooling (reference ``asap.py:84-165``), as
    the JAX package computes it with static shapes: every node gets one
    appended self loop whose weight is that of its last existing loop edge
    (by edge position), or 1; ego-network attention from a max-pooled
    master query (``lin``, ``att``); ``LEConv`` fitness (``gnn_score``);
    ``SelectTopK(1)`` (``select``); the coarsened adjacency ``S_sel^T (A
    S_sel)`` dense ``[B*k, B*k]``. That product is a plain matrix product
    in the JAX package too (no Pallas body), so it is ``torch.matmul``
    here.

    Returns ``(x, adj, batch, mask, perm, fitness)``."""

    def __init__(self, in_channels: int, ratio: float = 0.5,
                 negative_slope: float = 0.2,
                 add_self_loops_out: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from .select import SelectTopK
        from ..conv.graph_conv import LEConv
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.ratio, self.negative_slope = ratio, negative_slope
        self.add_self_loops_out = add_self_loops_out
        self.lin = linear(in_channels, in_channels, **kw)
        self.att = linear(2 * in_channels, 1, **kw)
        self.gnn_score = LEConv(in_channels, 1, **kw)
        self.select = SelectTopK(1, ratio, **kw)

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None, batch=None,
                batch_size: int = 1,
                max_nodes_per_graph: Optional[int] = None,
                edge_mask: Optional[torch.Tensor] = None):
        n = x.shape[0]
        if batch is None:
            batch = torch.zeros(n, dtype=torch.long, device=x.device)
        L = max_nodes_per_graph or n
        coo = _coo(edge_index).long()
        src0, dst0 = coo[0].clamp(max=n - 1), coo[1].clamp(max=n - 1)
        e = src0.shape[0]
        w0 = (edge_weight if edge_weight is not None
              else x.new_ones(e))
        m0 = (edge_mask if edge_mask is not None
              else torch.ones(e, dtype=torch.bool, device=x.device))
        # each node's appended loop takes the weight of its LAST loop edge
        # (by position), the reference's assignment order
        is_loop = (src0 == dst0) & m0
        pos = torch.arange(e, device=x.device)
        e_pos = torch.where(is_loop, pos, -1)
        last_pos = torch.full((n + 1,), -1, dtype=torch.long,
                              device=x.device).scatter_reduce(
            0, torch.where(is_loop, src0, n), e_pos, 'amax')[:n]
        loop_w = torch.where(last_pos >= 0, w0[last_pos.clamp(min=0)],
                             x.new_ones(()))
        ar = torch.arange(n, device=x.device)
        src = torch.cat([src0, ar])
        dst = torch.cat([dst0, ar])
        w = torch.cat([w0, loop_w])
        emask = torch.cat([m0 & ~is_loop,
                           torch.ones(n, dtype=torch.bool, device=x.device)])

        # master query: the max over incoming x_j, then the attention score
        x_pool_j = x[src]
        x_q = scatter(x_pool_j, dst, n, 'max', mask=emask)
        x_q = self.lin(x_q)[dst]
        score = F.leaky_relu(self.att(torch.cat([x_q, x_pool_j], -1))[:, 0],
                             self.negative_slope)
        score = segment_softmax(score, dst, n, mask=emask)
        score = torch.where(emask, score, 0.0)
        xc = scatter(score[:, None] * x[src], dst, n, 'sum', mask=emask)

        fitness = torch.sigmoid(self.gnn_score(
            xc, torch.stack([src, dst]), edge_mask=emask)[:, 0])
        sel = self.select(fitness[:, None], batch, batch_size, L)
        safe = sel.node_index.clamp(max=n - 1)
        new_x = xc[safe] * fitness[safe][:, None]
        new_x = torch.where(sel.mask[:, None], new_x, 0.0)

        # A' = S^T A S, S[i, j] = score(i -> j), columns at the kept nodes
        wv = torch.where(emask, w, 0.0)
        A = x.new_zeros((n, n)).index_put((src, dst), wv, accumulate=True)
        S = x.new_zeros((n, n)).index_put((src, dst), score,
                                          accumulate=True)
        S_sel = S[:, safe] * sel.mask[None, :]
        adj = S_sel.T @ (A @ S_sel)
        k = adj.shape[0]
        eye = torch.eye(k, dtype=torch.bool, device=x.device)
        if self.add_self_loops_out:
            diag = torch.diagonal(adj)
            fill = torch.where((diag == 0) & sel.mask, 1.0, diag)
            adj = torch.where(eye, fill[:, None] * eye, adj)
        else:
            adj = torch.where(eye, 0.0, adj)
        return new_x, adj, sel.batch, sel.mask, sel.node_index, fitness


class MemPooling(nn.Module):
    """Memory-based soft clustering (reference ``mem_pool.py``): a
    Student-t assignment of every node to ``num_clusters`` learned keys in
    each of ``heads`` heads, the heads mixed by ``head_mix`` (``[H]``) and
    a softmax over the clusters; the pooled rows ``S^T X`` through ``lin``
    (no bias). A node list ``[N, F]`` is first laid out as the JAX package
    lays it, ``[batch_size, N, F]`` (every graph padded to the whole
    batch's node count); the squared distances are taken one head at a
    time, ``[B, N, K, F]`` each, rather than as one ``[B, N, H, K, F]``
    difference. Returns ``(out [B, K, out_channels], S [B, N, K])``."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 4,
                 num_clusters: int = 2, tau: float = 1.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.heads, self.num_clusters, self.tau = heads, num_clusters, tau
        keys = torch.randn((heads, num_clusters, in_channels),
                           generator=generator)
        self.keys = nn.Parameter(keys.to(device))
        self.head_mix = nn.Parameter(
            (torch.randn(heads, generator=generator) * 0.5).to(device))
        self.lin = linear(in_channels, out_channels, bias=False,
                          device=device, generator=generator)

    def forward(self, x, batch=None, batch_size: int = 1,
                mask: Optional[torch.Tensor] = None):
        from ...utils.dense import to_dense_batch
        if x.dim() == 2:
            dense, valid = to_dense_batch(x, batch, batch_size, x.shape[0])
        else:
            dense = x
            valid = (mask if mask is not None else torch.ones(
                x.shape[:2], dtype=torch.bool, device=x.device))
        d2 = torch.stack([((dense[:, :, None, :] - self.keys[h]) ** 2
                           ).sum(-1) for h in range(self.heads)], 2)
        s = (1 + d2 / self.tau) ** (-(self.tau + 1) / 2)
        s = s / s.sum(-1, keepdim=True).clamp(min=1e-12)
        s = torch.einsum('bnhk,h->bnk', s, self.head_mix)
        s = torch.softmax(s, -1)
        s = torch.where(valid[..., None], s, 0.0)
        xk = torch.einsum('bnk,bnf->bkf', s, dense)
        return self.lin(xk), s

    @staticmethod
    def kl_loss(s: torch.Tensor) -> torch.Tensor:
        """Sharpening KL loss (reference ``mem_pool.py:kl_loss``): ``P =
        S^2 / colsum``, row-normalised (a padded node's row keeps
        denominator 1), then batchmean ``KL(P || S)``."""
        eps = 1e-15
        s2 = s ** 2 / s.sum(1, keepdim=True).clamp(min=eps)
        denom = s2.sum(-1, keepdim=True)
        denom = torch.where(s.sum(-1, keepdim=True) == 0.0, 1.0, denom)
        p = (s2 / denom).clamp(min=eps)
        s = s.clamp(min=eps)
        return (p * (torch.log(p) - torch.log(s))).sum() / s.shape[0]


class ClusterPooling(nn.Module):
    """Edge-based graph component pooling (reference
    ``nn/pool/cluster_pool.py:21``): each edge scored from its two ends
    (``lin``), the edges above a threshold kept (read back to the host),
    their connected components found by a host union-find with min-root
    numbering (scipy's first-encounter numbering), and each component's
    nodes summed with their edge scores as weights.

    Returns ``(x_pooled [N, F], cluster [N], edge_index', edge_mask',
    num_clusters)``; the pooled rows past ``num_clusters`` are 0."""

    def __init__(self, in_channels: int, edge_score_method: str = 'tanh',
                 threshold: Optional[float] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.edge_score_method = edge_score_method
        self.threshold = threshold
        self.lin = linear(2 * in_channels, 1, device=resolve_device(device),
                          generator=generator)

    def forward(self, x, edge_index,
                edge_mask: Optional[torch.Tensor] = None):
        n = x.shape[0]
        dev = x.device
        coo = host(_coo(edge_index)).astype(np.int64)
        # the reference drops self loops before scoring; here they are
        # masked, so the shapes stay
        not_loop = coo[0] != coo[1]
        if edge_mask is not None:
            not_loop = not_loop & host(edge_mask)
        src = torch.as_tensor(np.minimum(coo[0], n - 1), device=dev)
        dst = torch.as_tensor(np.minimum(coo[1], n - 1), device=dev)
        raw = self.lin(torch.cat([x[src], x[dst]], -1))[:, 0]
        not_loop_t = torch.as_tensor(not_loop, device=dev)
        th = self.threshold
        if self.edge_score_method == 'sigmoid':
            score = torch.sigmoid(raw)
            th = 0.5 if th is None else th
        elif self.edge_score_method == 'log_softmax':
            score = torch.log_softmax(
                torch.where(not_loop_t, raw, -torch.inf), 0)
            th = 0.0 if th is None else th
        else:
            score = torch.tanh(raw)
            th = 0.0 if th is None else th
        keep = host(score > th) & not_loop

        parent = np.arange(n)

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for s, d in zip(coo[0][keep], coo[1][keep]):
            rs, rd = find(int(s)), find(int(d))
            if rs != rd:
                parent[max(rs, rd)] = min(rs, rd)
        roots = np.asarray([find(v) for v in range(n)])
        uniq, cluster = np.unique(roots, return_inverse=True)
        k = len(uniq)

        # x_out[c] = sum_j (sum_{i in c} S[j, i]) x[j], a node that no kept
        # edge touches weighted 1 in its own cluster. row_w stays the dense
        # [N, N] of the JAX package: its sums (and their order) are the
        # same, and these graphs are small
        cl = torch.as_tensor(cluster, device=dev)
        sv = torch.where(not_loop_t, score, 0.0)
        touched = np.zeros(n, bool)
        touched[coo[0][keep]] = True
        touched[coo[1][keep]] = True
        single = torch.as_tensor(~touched, device=dev)
        row_w = x.new_zeros((n, n)).index_put((src, cl[dst]), sv,
                                              accumulate=True)
        row_w = row_w + single[:, None] * F.one_hot(cl, n).to(x.dtype)
        pooled = row_w.T @ x

        new_coo = np.stack([cluster[coo[0]], cluster[coo[1]]])
        new_mask = (new_coo[0] != new_coo[1]) & not_loop
        return (pooled, cl, torch.as_tensor(new_coo, device=dev),
                torch.as_tensor(new_mask, device=dev), k)
