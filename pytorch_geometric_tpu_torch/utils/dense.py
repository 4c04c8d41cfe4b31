"""Ragged to padded conversions.

Counterpart of ``pytorch_geometric_tpu/utils/dense.py`` (reference
``torch_geometric/utils/_to_dense_batch.py`` and ``_to_dense_adj.py``):
``batch_size`` and ``max_num_nodes`` are given, so the shapes are static.
"""

from typing import Optional, Tuple

import torch


def node_positions(batch: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Each node's rank among the nodes of its graph, in row order: the
    JAX package's ``cumsum(one_hot(batch, batch_size))[i, batch[i]] - 1``,
    computed by a stable sort instead of the ``[N, batch_size]`` running
    count. As there, only rows with ``0 <= batch < batch_size`` are
    counted; a row outside that range reads the count of the graph its
    index is clamped to (``batch_size - 1`` past the end; a negative index
    first wraps once, as a JAX gather's does), and gets -1 where that graph
    has no counted row up to it."""
    batch = batch.long()
    n = batch.shape[0]
    counted = (batch >= 0) & (batch < batch_size)
    graph = torch.where(batch < 0, batch + batch_size, batch).clamp(
        0, max(batch_size - 1, 0))
    order = torch.argsort(graph, stable=True)
    sorted_graph = graph[order]
    running = torch.cumsum(counted[order].long(), 0)
    per_graph = torch.zeros(max(batch_size, 1), dtype=torch.long,
                            device=batch.device).index_add_(
        0, graph, counted.long())
    before = torch.cumsum(per_graph, 0) - per_graph
    pos = torch.empty(n, dtype=torch.long, device=batch.device)
    pos[order] = running - before[sorted_graph] - 1
    return pos


def to_dense_batch(x: torch.Tensor, batch: Optional[torch.Tensor],
                   batch_size: int, max_num_nodes: int,
                   fill_value: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Node rows ``[N, ...]`` into ``[B, N_max, ...]`` and a bool mask of
    the filled places. A node's place is its rank among the nodes of its
    graph (in row order); a node past ``max_num_nodes``, or of a graph at
    or past ``batch_size``, is dropped."""
    n = x.shape[0]
    if batch is None:
        batch = torch.zeros(n, dtype=torch.long, device=x.device)
    batch = batch.long()
    inside = (batch >= 0) & (batch < batch_size)
    pos = node_positions(batch, batch_size)
    valid = inside & (pos < max_num_nodes)
    dump = batch_size * max_num_nodes
    flat = torch.where(valid, batch * max_num_nodes + pos, dump)
    out = x.new_full((dump + 1,) + tuple(x.shape[1:]), fill_value)
    out = out.index_put((flat,), x)[:-1]
    mask = torch.zeros(dump + 1, dtype=torch.bool, device=x.device)
    mask = mask.index_put((flat,), valid)[:-1]
    return (out.view((batch_size, max_num_nodes) + tuple(x.shape[1:])),
            mask.view(batch_size, max_num_nodes))


def to_dense_adj(edge_index, batch: Optional[torch.Tensor],
                 batch_size: int, max_num_nodes: int,
                 edge_attr: Optional[torch.Tensor] = None,
                 num_nodes: Optional[int] = None) -> torch.Tensor:
    """The padded dense adjacency ``[B, N_max, N_max(, F)]``: each edge
    adds its ``edge_attr`` (1 without) at its graph's local ``(src,
    dst)``; an edge with an endpoint past ``max_num_nodes`` is dropped."""
    coo = edge_index.coo if hasattr(edge_index, 'coo') else edge_index
    src, dst = coo[0].long(), coo[1].long()
    if batch is None:
        b = torch.zeros_like(src)
        pos_src, pos_dst = src, dst
    else:
        batch = batch.long()
        b = batch[src]
        count = torch.zeros(batch_size, dtype=torch.long,
                            device=src.device).index_add_(
            0, batch, torch.ones_like(batch))
        start = torch.cumsum(count, 0) - count
        pos_src = src - start[b]
        pos_dst = dst - start[batch[dst]]
    valid = (pos_src < max_num_nodes) & (pos_dst < max_num_nodes)
    dump = batch_size * max_num_nodes * max_num_nodes
    flat = torch.where(valid, (b * max_num_nodes + pos_src) * max_num_nodes
                       + pos_dst, dump)
    if edge_attr is None:
        vals = torch.ones(coo.shape[1], dtype=torch.float32,
                          device=src.device)
    else:
        vals = edge_attr
    out = vals.new_zeros((dump + 1,) + tuple(vals.shape[1:]))
    out = out.index_add(0, flat, vals)[:-1]
    return out.view((batch_size, max_num_nodes, max_num_nodes)
                    + tuple(vals.shape[1:]))


def dense_to_sparse(adj: torch.Tensor, mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``[N, N]`` (or ``[B, N, N]``, graphs stacked block-diagonally,
    graph ``b``'s node ``i`` numbered ``b * N + i``) to ``(coo [2, nnz]
    int64, values)`` on ``adj``'s device, in row-major order; the values
    carry ``adj``'s gradient. With ``mask`` (``[B, N]``, as
    ``to_dense_batch`` gives it) only the rows of real nodes count, and
    nodes are numbered by their rank among the real ones (the inverse of
    ``to_dense_batch`` / ``to_dense_adj``, real nodes first in each graph;
    reference ``utils/sparse.py:dense_to_sparse``)."""
    if adj.dim() == 2:
        if mask is not None:
            raise ValueError('a mask needs a batched [B, N, N] adjacency')
        coo = adj.nonzero().t()
        return coo, adj[coo[0], coo[1]]
    if adj.dim() != 3:
        raise ValueError(f'adj of {adj.dim()} dims, not 2 or 3')
    b, n = adj.shape[0], adj.shape[1]
    rows = adj.reshape(b * n, adj.shape[2])
    if mask is None:
        offset = torch.arange(b, device=adj.device).repeat_interleave(n) * n
    else:
        if mask.shape != (b, n):
            raise ValueError(f'mask of shape {tuple(mask.shape)} for an '
                             f'adjacency of {b} graphs of {n} nodes')
        rows = rows[mask.reshape(-1)]
        count = mask.sum(1)
        offset = (torch.cumsum(count, 0) - count).repeat_interleave(count)
    r, c = rows.nonzero().unbind(1)
    return torch.stack([r, c + offset[r]]), rows[r, c]
