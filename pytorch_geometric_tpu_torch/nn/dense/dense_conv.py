"""Dense (padded-batch) convolutions over ``x [B, N, F]`` and ``adj [B, N,
N]``: GCN, GraphSAGE, GIN, GraphConv and GAT.

Counterpart of ``pytorch_geometric_tpu/nn/dense/dense_conv.py`` (reference
``torch_geometric/nn/dense/dense_gcn_conv.py``, ``dense_sage_conv.py``,
``dense_gin_conv.py``, ``dense_graph_conv.py`` and ``dense_gat_conv.py``).
Each is a few batched matrix products, plain PyTorch, as the JAX package's
are XLA with no Pallas body.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..inits import constant, glorot, linear
from ...backend import resolve_device


def _mask_x(x, mask):
    return x if mask is None else x * mask[..., None]


class DenseGCNConv(nn.Module):
    """``D^-1/2 (A + I) D^-1/2 X W + b``, the loops weighted 2 when
    ``improved`` (reference ``dense_gcn_conv.py``); ``lin`` without bias,
    then ``bias``."""

    def __init__(self, in_channels: int, out_channels: int,
                 improved: bool = False, use_bias: bool = True,
                 device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.improved = improved
        self.lin = linear(in_channels, out_channels, bias=False,
                          device=device, generator=generator)
        self.bias = (constant((out_channels,), 0.0, device) if use_bias
                     else None)

    def forward(self, x, adj, mask: Optional[torch.Tensor] = None,
                add_loop: bool = True) -> torch.Tensor:
        n = x.shape[1]
        if add_loop:
            eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
            adj = adj * (1 - eye) + (2.0 if self.improved else 1.0) * eye
        x = self.lin(x)
        dis = torch.rsqrt(adj.sum(-1).clamp(min=1e-12))
        out = (dis[..., None] * adj * dis[..., None, :]) @ x
        if self.bias is not None:
            out = out + self.bias
        return _mask_x(out, mask)


class DenseSAGEConv(nn.Module):
    """``lin_rel(mean_j x_j) + lin_root(x)`` (the bias on ``lin_root``),
    L2-normalised when ``normalize`` (reference ``dense_sage_conv.py``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 normalize: bool = False, use_bias: bool = True,
                 device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.normalize = normalize
        self.lin_rel = linear(in_channels, out_channels, bias=False, **kw)
        self.lin_root = linear(in_channels, out_channels, bias=use_bias,
                               **kw)

    def forward(self, x, adj, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        mean = (adj @ x) / adj.sum(-1, keepdim=True).clamp(min=1.0)
        out = self.lin_rel(mean) + self.lin_root(x)
        if self.normalize:
            out = out / torch.linalg.norm(out, dim=-1,
                                          keepdim=True).clamp(min=1e-12)
        return _mask_x(out, mask)


class DenseGINConv(nn.Module):
    """``nn(A x + (1 + eps) x)`` (reference ``dense_gin_conv.py``); ``eps``
    a parameter when ``train_eps``."""

    def __init__(self, nn: nn.Module, eps: float = 0.0,
                 train_eps: bool = False, device=None):
        super().__init__()
        self.nn = nn
        self.eps_init = eps
        self.eps = (constant((), eps, resolve_device(device)) if train_eps
                    else None)

    def forward(self, x, adj, mask: Optional[torch.Tensor] = None,
                add_loop: bool = True) -> torch.Tensor:
        out = adj @ x
        if add_loop:
            eps = self.eps if self.eps is not None else self.eps_init
            out = out + (1 + eps) * x
        return _mask_x(self.nn(out), mask)


class DenseGraphConv(nn.Module):
    """``lin_rel(A x)`` (mean over the row's weight with ``aggr='mean'``)
    ``+ lin_root(x)`` (reference ``dense_graph_conv.py``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 aggr: str = 'add', use_bias: bool = True,
                 device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.aggr = aggr
        self.lin_rel = linear(in_channels, out_channels, bias=use_bias,
                              **kw)
        self.lin_root = linear(in_channels, out_channels, bias=False, **kw)

    def forward(self, x, adj, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        agg = adj @ x
        if self.aggr == 'mean':
            agg = agg / adj.sum(-1, keepdim=True).clamp(min=1.0)
        return _mask_x(self.lin_rel(agg) + self.lin_root(x), mask)


class DenseGATConv(nn.Module):
    """GAT over a dense adjacency (reference ``dense_gat_conv.py``):
    ``alpha[b, i, j, h]`` the softmax over the j with ``adj[b, i, j] > 0``
    (a loop on every node when ``add_loop``) of ``leaky_relu(<h_i,
    att_dst> + <h_j, att_src>)``; heads concatenated or averaged, then
    ``bias``."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.heads, self.out_channels = heads, out_channels
        self.concat, self.negative_slope = concat, negative_slope
        self.lin = linear(in_channels, heads * out_channels, bias=False,
                          device=device, generator=generator)
        self.att_src = glorot((1, 1, heads, out_channels), device, generator)
        self.att_dst = glorot((1, 1, heads, out_channels), device, generator)
        self.bias = (constant((heads * out_channels if concat
                               else out_channels,), 0.0, device)
                     if use_bias else None)

    def forward(self, x, adj, mask: Optional[torch.Tensor] = None,
                add_loop: bool = True) -> torch.Tensor:
        B, N, _ = x.shape
        H, C = self.heads, self.out_channels
        if add_loop:
            adj = torch.maximum(adj, torch.eye(N, dtype=adj.dtype,
                                               device=adj.device))
        h = self.lin(x).reshape(B, N, H, C)
        e_src = (h * self.att_src).sum(-1)
        e_dst = (h * self.att_dst).sum(-1)
        e = F.leaky_relu(e_dst[:, :, None, :] + e_src[:, None, :, :],
                         self.negative_slope)
        edge = (adj > 0)[..., None]
        e = torch.where(edge, e, torch.finfo(e.dtype).min)
        alpha = torch.where(edge, torch.softmax(e, 2), 0.0)
        out = torch.einsum('bijh,bjhc->bihc', alpha, h)
        out = out.reshape(B, N, H * C) if self.concat else out.mean(2)
        if self.bias is not None:
            out = out + self.bias
        return _mask_x(out, mask)
