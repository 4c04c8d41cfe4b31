"""GraphConv and ClusterGCNConv.

Counterpart of ``GraphConv`` and ``ClusterGCNConv`` in
``pytorch_geometric_tpu/nn/conv/graph_conv.py`` (reference
``torch_geometric/nn/conv/graph_conv.py`` and ``cluster_gcn_conv.py``); the
file's other convolutions are ROADMAP Queue 1, item 11. Both aggregate
through ``MessagePassing``: over an ``EdgeIndex`` with its CSC cached, a
weighted SpMM (``ops.spmm``, kernel 1 on the card); over a raw COO, a
gather and a scatter. Submodules are named as the flax modules name them
(``lin_rel``, ``lin_root``, ``lin_out``), so ``convert.flax_to_state_dict``
carries their parameters across.
"""

from typing import Optional, Tuple, Union

import torch

from ..inits import linear
from ..message_passing import MessagePassing
from ...backend import resolve_device
from ...edge_index import EdgeIndex
from ...ops import scatter, spmm


def _coo(edge_index):
    return edge_index.coo if isinstance(edge_index, EdgeIndex) else edge_index


class _WeightedAggregation(MessagePassing):
    """Messages ``w_ij x_j`` (``x_j`` without weights), fused into one
    weighted SpMM over a cached CSC."""

    def message(self, x_j, edge_weight=None):
        return x_j if edge_weight is None else edge_weight[:, None] * x_j

    def message_and_aggregate(self, edge_index, x=None, edge_weight=None,
                              **kwargs):
        if not isinstance(edge_index, EdgeIndex) or edge_index.csc is None:
            return NotImplemented
        x_src, _ = x if isinstance(x, tuple) else (x, x)
        return spmm(edge_index, x_src, edge_weight=edge_weight,
                    reduce=self._aggr())


class GraphConv(_WeightedAggregation):
    """x'_i = W1 x_i + W2 aggr_{j in N(i)} w_ij x_j (reference
    ``graph_conv.py``): ``lin_rel`` (with bias) after the aggregation,
    ``lin_root`` (no bias) on the destination's own features.
    ``in_channels`` is an int or ``(in_src, in_dst)``."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, aggr: str = 'add',
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst = (in_channels if isinstance(in_channels, tuple)
                          else (in_channels, in_channels))
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.aggr = aggr
        self.lin_rel = linear(in_src, out_channels, bias=use_bias,
                              device=device, generator=generator)
        self.lin_root = linear(in_dst, out_channels, bias=False,
                               device=device, generator=generator)

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        if size is None:
            size = (x_src.shape[0], x_dst.shape[0])
        out = self.propagate(edge_index, x=(x_src, x_dst),
                             edge_weight=edge_weight, size=size,
                             edge_mask=edge_mask)
        out = self.lin_rel(out)
        if x_dst is not None:
            out = out + self.lin_root(x_dst)
        return out


class ClusterGCNConv(_WeightedAggregation):
    """Cluster-GCN's conv (reference ``cluster_gcn_conv.py``): ``lin_out((A'
    + diag_lambda * diag(A')) X) + lin_root(X)``, ``A'`` the adjacency with
    one self loop a node (existing loops dropped) normalised by in-degree.

    The self loops are not appended to the edges: their messages
    ``deg_inv[i] * x_i`` are added after the aggregation, so an
    ``EdgeIndex`` keeps its cached CSC and the aggregation runs as one
    weighted SpMM over it (the JAX package appends ``N`` loop edges and
    aggregates over ``E + N``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 diag_lambda: float = 0.0, add_self_loops: bool = True,
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.diag_lambda = diag_lambda
        self.add_self_loops = add_self_loops
        self.lin_out = linear(in_channels, out_channels, bias=use_bias,
                              device=device, generator=generator)
        self.lin_root = linear(in_channels, out_channels, bias=False,
                               device=device, generator=generator)

    def forward(self, x, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo = _coo(edge_index)
        loop = coo[0] == coo[1]
        w = (x.new_ones(coo.shape[1]) if edge_mask is None
             else edge_mask.to(x.dtype))
        if self.add_self_loops:
            # reference :100-102: existing loops removed, one fresh loop
            # of weight 1 a node
            w = torch.where(loop, 0.0, w)
        dst = coo[1]
        deg = scatter(w, dst, n, 'sum')
        if self.add_self_loops:
            deg = deg + 1.0
        deg_inv = 1.0 / deg.clamp(min=1.0)
        ew = deg_inv[dst.long().clamp(0, max(n - 1, 0))] * w
        diag = scatter(torch.where(loop, ew, 0.0), dst, n, 'sum')
        out = self.propagate(edge_index, x=x, edge_weight=ew, size=(n, n))
        if self.add_self_loops:
            diag = diag + deg_inv
            out = out + deg_inv[:, None] * x
        out = out + self.diag_lambda * diag[:, None] * x
        # reference cluster_gcn_conv.py:61-63: lin_out + root skip
        return self.lin_out(out) + self.lin_root(x)
