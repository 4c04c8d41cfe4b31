"""GIN and GINE convolutions.

Counterpart of ``pytorch_geometric_tpu/nn/conv/gin_conv.py``.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from ..inits import linear
from ..message_passing import MessagePassing
from ...edge_index import EdgeIndex
from ...ops import spmm


class GINConv(MessagePassing):
    """x' = mlp((1 + eps) x + sum_j x_j).

    ``mlp``: any module (e.g. :class:`~..models.MLP`). ``train_eps`` makes
    eps a learned parameter initialised at ``eps_init``."""

    def __init__(self, mlp: nn.Module, eps_init: float = 0.0,
                 train_eps: bool = False, aggr: str = 'sum'):
        super().__init__()
        self.mlp = mlp
        self.aggr = aggr
        if train_eps:
            device = next(mlp.parameters()).device
            self.eps = nn.Parameter(torch.tensor(float(eps_init),
                                                 device=device))
        else:
            self.eps = eps_init

    def forward(self, x, edge_index,
                edge_mask: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        if size is None:
            size = (x_src.shape[0], x_dst.shape[0])
        out = self.propagate(edge_index, x=(x_src, x_dst), size=size,
                             edge_mask=edge_mask)
        if x_dst is not None:
            out = out + (1 + self.eps) * x_dst
        return self.mlp(out)

    def message_and_aggregate(self, edge_index, x=None, **kwargs):
        # fused sum-SpMM (the message is the identity x_j)
        if not isinstance(edge_index, EdgeIndex) or edge_index.csc is None:
            return NotImplemented
        x_src, _ = x if isinstance(x, tuple) else (x, x)
        return spmm(edge_index, x_src, reduce=self._aggr())


class GINEConv(MessagePassing):
    """GIN with edge features: x' = mlp((1 + eps) x + sum_j relu(x_j +
    e_ji)). With ``edge_dim`` other than the node width, the edge features
    first go through ``lin_edge`` (a Linear ``edge_dim -> in_channels``);
    ``in_channels`` defaults to the input width of ``mlp``'s first Linear.
    Messages take the gather path (they depend on the edge)."""

    def __init__(self, mlp: nn.Module, eps_init: float = 0.0,
                 train_eps: bool = False, edge_dim: Optional[int] = None,
                 in_channels: Optional[int] = None, aggr: str = 'sum',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = mlp
        self.aggr = aggr
        device = next(mlp.parameters()).device
        if in_channels is None:
            in_channels = next(m.in_features for m in mlp.modules()
                               if isinstance(m, nn.Linear))
        self.lin_edge = (linear(edge_dim, in_channels, device=device,
                                generator=generator)
                         if edge_dim is not None and edge_dim != in_channels
                         else None)
        if train_eps:
            self.eps = nn.Parameter(torch.tensor(float(eps_init),
                                                 device=device))
        else:
            self.eps = eps_init

    def forward(self, x, edge_index, edge_attr: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        if size is None:
            size = (x_src.shape[0], x_dst.shape[0])
        if self.lin_edge is not None:
            edge_attr = self.lin_edge(edge_attr)
        out = self.propagate(edge_index, x=(x_src, x_dst),
                             edge_attr=edge_attr, size=size,
                             edge_mask=edge_mask)
        if x_dst is not None:
            out = out + (1 + self.eps) * x_dst
        return self.mlp(out)

    def message(self, x_j, edge_attr):
        return torch.relu(x_j + edge_attr)
