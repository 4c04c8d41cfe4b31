"""Continuous-kernel convolutions: GMMConv, SplineConv, NNConv, CGConv,
FeaStConv.

Counterpart of ``pytorch_geometric_tpu/nn/conv/kernel_conv.py`` (reference
``nn/conv/gmm_conv.py`` (MoNet's gaussian mixtures), ``spline_conv.py``
(B-spline kernels; the reference calls pyg-lib's ``spline_basis`` /
``spline_weighting``), ``nn_conv.py`` (edge conditioned), ``cg_conv.py``
(crystal graphs), ``feast_conv.py``). Messages are gathered and reduced
with ``ops.scatter``, as the JAX package computes them in XLA; endpoints
are clamped into range as there, so an edge at the padding sentinel needs
the edge mask to drop it.

SplineConv computes the JAX package's function in another order. The JAX
body gathers ``weight[idx_c]`` into an ``[E, F_in, F_out]`` tensor for each
of the ``(degree + 1)^dim`` corners (JAX ``kernel_conv.py:131-142``): at
FAUST's mesh (41,328 edges, 64 x 64, degree 1 in 3 dims) 677 MB a corner and
5.4 GB a layer, which autograd keeps. The port multiplies every node by
every kernel first, ``h = x @ weight`` as ``[N, K^dim, F_out]`` (220 MB
there), and the message sums ``w_c * h[src, idx_c]`` over the corners,
gathered at once: the same products, rounded in another order.
"""

from typing import Optional, Tuple, Union

import torch
from torch import nn as tnn

from ..inits import constant, glorot, linear
from ..message_passing import MessagePassing, _pair
from ...backend import resolve_device
from ...ops import scatter
from .graph_conv import _coo
from .point_conv import _with_self_loops


def _endpoints(edge_index, n_src: int, n_dst: int):
    coo = _coo(edge_index)
    return (coo[0].long().clamp(max=n_src - 1),
            coo[1].long().clamp(max=n_dst - 1))


class GMMConv(MessagePassing):
    """MoNet: messages weighted by ``K`` gaussian kernels over the
    pseudo-coordinates ``edge_attr`` (reference ``gmm_conv.py``): ``w_k =
    exp(-0.5 sum_d (e_d - mu_kd)^2 / (1e-15 + sigma_kd^2))``, ``msg =
    sum_k w_k lin(x_j)_k``; mean by default, plus ``root(x_i)`` and a
    bias."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, dim: int = 2, kernel_size: int = 3,
                 aggr: str = 'mean', root_weight: bool = True,
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst = _pair(in_channels)
        kw = dict(device=device, generator=generator)
        self.out_channels, self.dim, self.kernel_size = (out_channels, dim,
                                                         kernel_size)
        self.aggr = aggr
        self.mu = tnn.Parameter(torch.randn((kernel_size, dim),
                                            generator=generator).to(device))
        self.sigma = constant((kernel_size, dim), 1.0, device)
        self.lin = linear(in_src, kernel_size * out_channels, bias=False,
                          **kw)
        self.root = (linear(in_dst, out_channels, bias=False, **kw)
                     if root_weight else None)
        self.bias = constant((out_channels,), 0.0, device) if use_bias \
            else None

    def forward(self, x, edge_index, edge_attr: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = _pair(x)
        n = x_dst.shape[0]
        src, dst = _endpoints(edge_index, x_src.shape[0], n)
        h = self.lin(x_src).reshape(-1, self.kernel_size, self.out_channels)
        d = edge_attr[:, None, :] - self.mu[None]           # [E, K, dim]
        w = torch.exp((-0.5 * d ** 2
                       / (1e-15 + self.sigma[None] ** 2)).sum(-1))  # [E, K]
        msg = (h[src] * w[..., None]).sum(1)                 # [E, C]
        out = scatter(msg, dst, n, self._aggr(), mask=edge_mask)
        if self.root is not None:
            out = out + self.root(x_dst)
        if self.bias is not None:
            out = out + self.bias
        return out


def _bspline_basis(pseudo: torch.Tensor, kernel_size: int,
                   degree: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Open uniform B-spline basis per dimension: ``(weights [E, dim,
    degree+1], indices [E, dim, degree+1])``, the counterpart of pyg-lib's
    ``spline_basis`` (JAX ``kernel_conv.py:61``). The tap weights of the
    uniform Cox-de Boor recursion, ``N_j^m = ((f+m-j)/m) N_{j-1}^{m-1} +
    ((1-f+j)/m) N_j^{m-1}``, unrolled for the static degree."""
    m = degree
    k = kernel_size - m
    if m < 1:
        raise ValueError(f'spline degree must be >= 1, got {m}')
    v = pseudo.clamp(0, 1) * max(k, 1)
    lo = torch.floor(v).long().clamp(max=max(k - 1, 0))
    f = v - lo
    ws = [torch.ones_like(f)]
    for mm in range(1, m + 1):
        prev = ws
        ws = []
        for j in range(mm + 1):
            term = torch.zeros_like(f)
            if 0 <= j - 1 < len(prev):
                term = term + ((f + mm - j) / mm) * prev[j - 1]
            if j < len(prev):
                term = term + ((1 - f + j) / mm) * prev[j]
            ws.append(term)
    w = torch.stack(ws, -1)                                  # [E, dim, m+1]
    idx = lo[..., None] + torch.arange(m + 1, device=pseudo.device)
    # corners past the last knot carry zero basis weight; their index is
    # clamped and their weight zeroed
    w = torch.where(idx < kernel_size, w, 0.0)
    return w, idx.clamp(max=kernel_size - 1)


class SplineConv(MessagePassing):
    """B-spline kernel conv (reference ``spline_conv.py``; open splines,
    degree 1-3): a weight bank ``[K^dim, F_in, F_out]`` (``K =
    kernel_size``) and per-edge weights from the tensor-product basis over
    the ``(degree + 1)^dim`` corners of ``edge_attr[:, :dim]`` in
    ``[0, 1]``; mean by default, plus ``root(x_i)`` and a bias. Computed
    as ``x @ weight`` for every node and kernel first, then one gather of
    every corner's rows (the module's docstring)."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, dim: int = 2, kernel_size: int = 3,
                 degree: int = 1, aggr: str = 'mean',
                 root_weight: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst = _pair(in_channels)
        self.out_channels, self.dim = out_channels, dim
        self.kernel_size, self.degree = kernel_size, degree
        self.aggr = aggr
        self.weight = glorot((kernel_size ** dim, in_src, out_channels),
                             device, generator)
        self.root = (linear(in_dst, out_channels, bias=False, device=device,
                            generator=generator) if root_weight else None)
        self.bias = constant((out_channels,), 0.0, device)

    def forward(self, x, edge_index, edge_attr: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = _pair(x)
        n = x_dst.shape[0]
        K, dim = self.kernel_size, self.dim
        total = K ** dim
        src, dst = _endpoints(edge_index, x_src.shape[0], n)
        wb, ib = _bspline_basis(edge_attr[:, :dim], K, self.degree)
        # every node times every kernel, [N * K^dim, F_out]
        h = torch.einsum('nf,kfo->nko', x_src, self.weight).reshape(
            -1, self.out_channels)
        base = self.degree + 1
        weights, rows = [], []
        for corner in range(base ** dim):
            bits, c = [], corner
            for _ in range(dim):
                bits.append(c % base)
                c //= base
            w_c = torch.ones_like(wb[:, 0, 0])
            idx_c = torch.zeros_like(ib[:, 0, 0])
            for d, b in enumerate(bits):
                w_c = w_c * wb[:, d, b]
                idx_c = idx_c * K + ib[:, d, b]
            weights.append(w_c)
            rows.append(src * total + idx_c)
        # every corner's rows in one gather, so the backward adds into one
        # [N * K^dim, F_out] gradient rather than one a corner
        picked = h.index_select(0, torch.cat(rows)).view(
            len(rows), -1, self.out_channels)
        msg = (torch.stack(weights)[..., None] * picked).sum(0)
        out = scatter(msg, dst, n, self._aggr(), mask=edge_mask)
        if self.root is not None:
            out = out + self.root(x_dst)
        return out + self.bias


class NNConv(MessagePassing):
    """Edge-conditioned conv (reference ``nn_conv.py``): each edge's
    ``[F_in, F_out]`` matrix from ``nn(edge_attr)``, ``msg = x_j W_e``;
    sum by default, plus ``root(x_i)``. The ``[E, F_in, F_out]`` tensor is
    the edge network's output, inherent to the conv."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, nn: tnn.Module, aggr: str = 'add',
                 root_weight: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst = _pair(in_channels)
        self.in_channels, self.out_channels = in_src, out_channels
        self.nn = nn
        self.aggr = aggr
        self.root = (linear(in_dst, out_channels, bias=False, device=device,
                            generator=generator) if root_weight else None)

    def forward(self, x, edge_index, edge_attr: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = _pair(x)
        n = x_dst.shape[0]
        src, dst = _endpoints(edge_index, x_src.shape[0], n)
        w_edge = self.nn(edge_attr).reshape(-1, self.in_channels,
                                            self.out_channels)
        msg = torch.einsum('ef,efo->eo', x_src[src], w_edge)
        out = scatter(msg, dst, n, self._aggr(), mask=edge_mask)
        if self.root is not None:
            out = out + self.root(x_dst)
        return out


class CGConv(MessagePassing):
    """Crystal graph conv (reference ``cg_conv.py``): ``x' = x + sum_j
    sigmoid(lin_f(z)) * softplus(lin_s(z))``, ``z = [x_i, x_j, e]``."""

    def __init__(self, channels: Union[int, Tuple[int, int]], dim: int = 0,
                 aggr: str = 'add', device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        c_src, c_dst = _pair(channels)
        kw = dict(device=device, generator=generator)
        self.aggr = aggr
        self.lin_f = linear(c_dst + c_src + dim, c_dst, **kw)
        self.lin_s = linear(c_dst + c_src + dim, c_dst, **kw)

    def forward(self, x, edge_index,
                edge_attr: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = _pair(x)
        n = x_dst.shape[0]
        src, dst = _endpoints(edge_index, x_src.shape[0], n)
        z = [x_dst[dst], x_src[src]]
        if edge_attr is not None:
            z.append(edge_attr)
        z = torch.cat(z, -1)
        f = torch.sigmoid(self.lin_f(z))
        s = torch.nn.functional.softplus(self.lin_s(z))
        return x_dst + scatter(f * s, dst, n, self._aggr(), mask=edge_mask)


class FeaStConv(MessagePassing):
    """Feature-steered conv (reference ``feast_conv.py``): attention over
    ``heads`` weight heads from feature differences, ``q = softmax(u(x_j -
    x_i))``, ``msg = sum_h q_h lin(x_j)_h``; self loops replaced by fresh
    ones and the messages averaged (reference ``feast_conv.py:55``), plus a
    bias."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 add_self_loops: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.out_channels, self.heads = out_channels, heads
        self.add_self_loops = add_self_loops
        self.u = linear(in_channels, heads, **kw)
        self.lin = linear(in_channels, heads * out_channels, bias=False, **kw)
        self.bias = constant((out_channels,), 0.0, device)

    def forward(self, x, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = _pair(x)
        n = x_dst.shape[0]
        if self.add_self_loops:
            edge_index, edge_mask = _with_self_loops(edge_index, edge_mask, n)
        src, dst = _endpoints(edge_index, x_src.shape[0], n)
        x_j = x_src[src]
        q = torch.softmax(self.u(x_j - x_dst[dst]), -1)     # [E, H]
        h = self.lin(x_j).reshape(-1, self.heads, self.out_channels)
        msg = (h * q[..., None]).sum(1)
        return scatter(msg, dst, n, 'mean', mask=edge_mask) + self.bias
