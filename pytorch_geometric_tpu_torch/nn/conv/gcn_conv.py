"""GCNConv (Kipf & Welling).

Counterpart of ``pytorch_geometric_tpu/nn/conv/gcn_conv.py``: ``gcn_norm``
computes the symmetric normalisation D^-1/2 (A + I) D^-1/2 as per-edge
weights with a static node count; ``cache_gcn_norm`` computes it once on
the host and carries it on the EdgeIndex.
"""

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..inits import linear
from ..message_passing import MessagePassing
from ...backend import resolve_device
from ...edge_index import EdgeIndex
from ...ops import spmm
from ...utils.loop import add_remaining_self_loops


def gcn_norm(edge_index, edge_weight: Optional[torch.Tensor] = None,
             num_nodes: Optional[int] = None, improved: bool = False,
             add_self_loops: bool = True, flow: str = 'source_to_target',
             dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (edge_index, edge_weight) with D^-1/2 A_hat D^-1/2 weights."""
    if isinstance(edge_index, EdgeIndex):
        num_nodes = edge_index.num_src_nodes
        coo = edge_index.coo
    else:
        coo = edge_index
        if num_nodes is None:
            raise ValueError('gcn_norm requires static num_nodes')

    if edge_weight is None:
        edge_weight = torch.ones(coo.shape[1], dtype=dtype,
                                 device=coo.device)
    if add_self_loops:
        coo, edge_weight = add_remaining_self_loops(
            coo, edge_weight, fill_value=2.0 if improved else 1.0,
            num_nodes=num_nodes)

    idx = (coo[1] if flow == 'source_to_target' else coo[0]).long()
    # padded edges (endpoint == num_nodes) must not contribute to degrees
    w = torch.where(idx < num_nodes, edge_weight, 0)
    deg = torch.zeros(num_nodes, dtype=dtype, device=coo.device).index_add_(
        0, idx.clamp(max=num_nodes - 1), w.to(dtype))
    # zero-degree rows get 0
    deg_inv_sqrt = torch.where(deg > 0, deg.clamp(min=1e-12).rsqrt(), 0.0)
    src = coo[0].long().clamp(max=num_nodes - 1)
    dst = coo[1].long().clamp(max=num_nodes - 1)
    return coo, deg_inv_sqrt[src] * w * deg_inv_sqrt[dst]


def cache_gcn_norm(edge_index: EdgeIndex, improved: bool = False,
                   add_self_loops: bool = True,
                   block_sparse: Optional[bool] = None, cache_dtype=None,
                   auto: bool = False) -> EdgeIndex:
    """``GCNConv(cached=True)`` as a one-time transform: compute
    D^-1/2 (A+I) D^-1/2 once on the host and cache it through
    ``fill_cache(dense_weight=..., block_sparse=..., cache_dtype=...)``:
    baked into a dense adjacency while ``N * N`` is within the dense cap
    and ``block_sparse`` is not set (float32, or ``cache_dtype``
    ``torch.bfloat16`` or ``torch.int8``), else into the block-sparse
    cache (``block_sparse=True``, or a graph past the cap whose blocks
    pay; bf16 blocks with ``cache_dtype=torch.bfloat16``), else carried as
    the EdgeIndex's ``weight``. Use with ``GCNConv(..., normalize=False,
    add_self_loops=False)``. The auto cache of the JAX package is not
    ported yet (``fill_cache`` raises for ``auto``)."""
    coo = edge_index.coo.cpu().numpy()
    n = edge_index.num_src_nodes
    row, col = coo[0].astype(np.int64), coo[1].astype(np.int64)
    valid = (row < n) & (col < n)
    row, col = row[valid], col[valid]
    if add_self_loops:
        # one loop per node; nodes that already had one keep its weight
        # (1 here), the rest get fill_value
        had_loop = np.zeros(n, bool)
        had_loop[row[row == col]] = True
        keep = row != col
        row, col = row[keep], col[keep]
        loops = np.arange(n, dtype=np.int64)
        loop_w = np.where(had_loop, 1.0, 2.0 if improved else 1.0)
        row = np.concatenate([row, loops])
        col = np.concatenate([col, loops])
        w = np.concatenate([np.ones(len(row) - n, np.float64), loop_w])
    else:
        w = np.ones(len(row), np.float64)
    deg = np.bincount(col, weights=w, minlength=n)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    norm = (dinv[row] * w * dinv[col]).astype(np.float32)
    coo_n = np.stack([row, col]).astype(np.int32)
    return EdgeIndex(coo_n, (n, n), device=edge_index.device).fill_cache(
        dense_weight=norm, block_sparse=block_sparse,
        cache_dtype=cache_dtype, auto=auto)


class GCNConv(MessagePassing):
    """x' = D^-1/2 (A+I) D^-1/2 x W + b.

    ``propagate_first``: A(xW) == (Ax)W, so the SpMM can run on the
    narrower side; ``None`` means propagate first iff ``in_channels <=
    out_channels`` and the aggregation is linear."""

    def __init__(self, in_channels: int, out_channels: int,
                 improved: bool = False, add_self_loops: bool = True,
                 normalize: bool = True, use_bias: bool = True,
                 aggr: str = 'sum', propagate_first: Optional[bool] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.improved = improved
        self.add_self_loops = add_self_loops
        self.normalize = normalize
        self.aggr = aggr
        self.propagate_first = propagate_first
        self.lin = linear(in_channels, out_channels, bias=False,
                          init='glorot_uniform', device=device,
                          generator=generator)
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        num_nodes = x.shape[0]
        if self.normalize:
            edge_index, edge_weight = gcn_norm(
                edge_index, edge_weight, num_nodes, self.improved,
                self.add_self_loops)
            if edge_mask is not None:
                # grown by N self-loop edges, all valid
                edge_mask = torch.cat([edge_mask, edge_mask.new_ones(
                    num_nodes)])
        prop_first = self.propagate_first
        if prop_first is None:
            # reassociation only commutes with LINEAR aggregations
            prop_first = (x.shape[-1] <= self.out_channels
                          and self._aggr() in ('sum', 'mean'))
        size = (num_nodes, num_nodes)
        if prop_first:
            out = self.lin(self.propagate(edge_index, x=x,
                                          edge_weight=edge_weight,
                                          size=size, edge_mask=edge_mask))
        else:
            out = self.propagate(edge_index, x=self.lin(x),
                                 edge_weight=edge_weight, size=size,
                                 edge_mask=edge_mask)
        if self.bias is not None:
            out = out + self.bias
        return out

    def message(self, x_j, edge_weight=None):
        if edge_weight is None:
            return x_j
        return edge_weight[:, None] * x_j

    def message_and_aggregate(self, edge_index, x=None, edge_weight=None,
                              **kwargs):
        # fused SpMM when the CSC is cached
        if not isinstance(edge_index, EdgeIndex) or edge_index.csc is None:
            return NotImplemented
        return spmm(edge_index, x, edge_weight, reduce=self._aggr())
