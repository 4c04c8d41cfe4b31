"""TopKPooling, SAGPooling and PANPooling.

Counterpart of ``pytorch_geometric_tpu/nn/pool/topk_pool.py`` (reference
``nn/pool/topk_pool.py:11``, ``sag_pool.py``, ``pan_pool.py``), on the
static-shape Select/Connect of ``select.py``."""

from typing import NamedTuple, Optional

import torch
from torch import nn

from .select import SelectOutput, SelectTopK, filter_edges, select_topk
from ..inits import constant
from ...backend import resolve_device


class PoolOutput(NamedTuple):
    x: torch.Tensor           # [B*k, F] gated features of kept slots
    edge_index: torch.Tensor  # [2, E] relabeled (dropped edges -> dump row)
    edge_mask: torch.Tensor   # [E]
    batch: torch.Tensor       # [B*k]
    node_mask: torch.Tensor   # [B*k]
    perm: torch.Tensor        # [B*k] original node rows
    score: torch.Tensor       # [B*k]


def _gather_pool(x, edge_index, select: SelectOutput, num_nodes,
                 multiplier: float = 1.0) -> PoolOutput:
    safe_rows = select.node_index.clamp(max=num_nodes - 1)
    new_x = x[safe_rows] * select.weight[:, None]
    new_x = torch.where(select.mask[:, None], new_x, 0) * multiplier
    new_coo, keep = filter_edges(edge_index, select, num_nodes)
    return PoolOutput(new_x, new_coo, keep, select.batch, select.mask,
                      select.node_index, select.weight)


def _defaults(x, batch, max_nodes_per_graph):
    n = x.shape[0]
    if batch is None:
        batch = torch.zeros(n, dtype=torch.long, device=x.device)
    return n, batch, max_nodes_per_graph or n


class TopKPooling(nn.Module):
    """Gao & Ji's Graph U-Nets pooling (reference ``topk_pool.py:11``):
    ``SelectTopK`` (named ``select``), then the kept rows gated by their
    score."""

    def __init__(self, in_channels: int, ratio: float = 0.5,
                 min_score: Optional[float] = None, multiplier: float = 1.0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.multiplier = multiplier
        self.select = SelectTopK(in_channels, ratio, min_score,
                                 device=device, generator=generator)

    def forward(self, x, edge_index, batch=None, batch_size: int = 1,
                max_nodes_per_graph: Optional[int] = None,
                node_mask: Optional[torch.Tensor] = None) -> PoolOutput:
        n, batch, L = _defaults(x, batch, max_nodes_per_graph)
        select = self.select(x, batch, batch_size, L, node_mask)
        return _gather_pool(x, edge_index, select, n, self.multiplier)


class SAGPooling(nn.Module):
    """Self-attention pooling (reference ``nn/pool/sag_pool.py``): scores
    from a ``GraphConv`` to one channel (``gnn``) routed through
    ``SelectTopK(1)`` (reference ``sag_pool.py:90``)."""

    def __init__(self, in_channels: int, ratio: float = 0.5,
                 min_score: Optional[float] = None, multiplier: float = 1.0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        from ..conv import GraphConv
        self.multiplier = multiplier
        self.gnn = GraphConv(in_channels, 1, device=device,
                             generator=generator)
        self.select = SelectTopK(1, ratio, min_score, device=device,
                                 generator=generator)

    def forward(self, x, edge_index, batch=None, batch_size: int = 1,
                max_nodes_per_graph: Optional[int] = None,
                node_mask: Optional[torch.Tensor] = None) -> PoolOutput:
        n, batch, L = _defaults(x, batch, max_nodes_per_graph)
        attn = self.gnn(x, edge_index)
        select = self.select(attn, batch, batch_size, L, node_mask)
        return _gather_pool(x, edge_index, select, n, self.multiplier)


class PANPooling(nn.Module):
    """PAN pooling (reference ``nn/pool/pan_pool.py:14``) as the JAX
    package computes it: ``score = beta_0 (x p) + beta_1 diag``, ``diag``
    each node's count of self-loop edges (the JAX package's stand-in for
    the MET matrix's diagonal), through ``tanh`` unless ``min_score``,
    then the per-graph top-k."""

    def __init__(self, in_channels: int, ratio: float = 0.5,
                 min_score: Optional[float] = None, multiplier: float = 1.0,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.ratio, self.min_score = ratio, min_score
        self.multiplier = multiplier
        self.p = constant((in_channels,), 1.0, device)
        self.beta = constant((2,), 1.0, device)

    def forward(self, x, edge_index, batch=None, batch_size: int = 1,
                max_nodes_per_graph: Optional[int] = None,
                node_mask: Optional[torch.Tensor] = None) -> PoolOutput:
        n, batch, L = _defaults(x, batch, max_nodes_per_graph)
        coo = edge_index.coo if hasattr(edge_index, 'coo') else edge_index
        src = coo[0].long().clamp(max=n - 1)
        dst = coo[1].long().clamp(max=n - 1)
        diag = x.new_zeros(n).index_add_(0, dst, (src == dst).to(x.dtype))
        score = self.beta[0] * (x @ self.p) + self.beta[1] * diag
        score = torch.tanh(score) if self.min_score is None else score
        select = select_topk(score, batch, batch_size, self.ratio, L,
                             self.min_score, node_mask)
        return _gather_pool(x, edge_index, select, n, self.multiplier)
