"""Spectral and multi-hop propagation convolutions: ChebConv, ARMAConv,
SGConv, SSGConv, TAGConv, APPNP and MixHopConv.

Counterpart of ``pytorch_geometric_tpu/nn/conv/spectral_conv.py``
(reference ``torch_geometric/nn/conv/cheb_conv.py``, ``arma_conv.py``,
``sg_conv.py``, ``ssg_conv.py``, ``tag_conv.py``, ``appnp.py``,
``mixhop_conv.py``). As there, every conv strips an ``EdgeIndex`` to its
COO and propagates by gather and scatter (``MessagePassing``'s plain path):
no port kernel runs here. The K-hop recurrences are Python loops.

Submodules are named as the flax modules name theirs: a per-hop ``lin_k``
is ``lins.k`` (a ``ModuleDict`` keyed by power for MixHopConv), and
ARMAConv's ``stack_{k}_w_{t}`` / ``stack_{k}_w_shared`` are
``stacks.k.w_t`` / ``stacks.k.w_shared`` (``convert.flax_to_state_dict``
maps both).
"""

from typing import Optional, Sequence

import torch
from torch import nn

from ..inits import constant, linear
from ...backend import resolve_device
from ...ops import scatter
from .gcn_conv import gcn_norm
from .graph_conv import _WeightedGather as _Propagation, _coo


def _grown(edge_mask, n, grown: bool):
    """``edge_mask`` extended by ``n`` valid self-loop edges when the
    normalisation appended them."""
    if edge_mask is None or not grown:
        return edge_mask
    return torch.cat([edge_mask, edge_mask.new_ones(n)])


def _bias(channels: int, use_bias: bool, device):
    return constant((channels,), 0.0, device) if use_bias else None


class ChebConv(_Propagation):
    """Chebyshev spectral conv of order ``K`` (reference ``cheb_conv.py``):
    ``sum_k W_k T_k(L_hat) x``, ``L_hat = 2 L / lambda_max - I``.

    The Laplacian's weights (JAX ``spectral_conv.py:40-62``): self loops
    removed, degrees over the **source** endpoint (the reference's
    ``get_laplacian`` scatters over the row), and the ``-I`` shift folded
    into one diagonal term ``2 / lambda_max - 1`` added after each
    propagation. An edge at the padding sentinel is clamped to the last node
    and counts toward its degree unless ``edge_mask`` drops it, as in the
    JAX package."""

    def __init__(self, in_channels: int, out_channels: int, K: int = 2,
                 normalization: str = 'sym', use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.K = K
        self.normalization = normalization
        self.lins = nn.ModuleList(
            linear(in_channels, out_channels, bias=False, device=device,
                   generator=generator) for _ in range(K))
        self.bias = _bias(out_channels, use_bias, device)

    def _norm(self, coo, n, edge_weight, lambda_max, edge_mask, dtype):
        w = (torch.ones(coo.shape[1], dtype=dtype, device=coo.device)
             if edge_weight is None else edge_weight)
        if edge_mask is not None:
            w = torch.where(edge_mask, w, 0)
        w = torch.where(coo[0] == coo[1], 0, w)
        src = coo[0].long().clamp(max=n - 1)
        dst = coo[1].long().clamp(max=n - 1)
        deg = scatter(w, src, n, 'sum')
        if self.normalization == 'sym':
            dis = torch.where(deg > 0, deg.clamp(min=1e-12).rsqrt(), 0.0)
            lw = -dis[src] * w * dis[dst]
        else:   # 'rw'
            dinv = torch.where(deg > 0, 1.0 / deg.clamp(min=1e-12), 0.0)
            lw = -dinv[dst] * w
        return (2.0 / lambda_max) * lw

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                lambda_max: float = 2.0,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo = _coo(edge_index)
        lw = self._norm(coo, n, edge_weight, lambda_max, edge_mask, x.dtype)
        diag = 2.0 / lambda_max - 1.0

        def lhat(v):
            return (self.propagate(coo, x=v, edge_weight=lw, size=(n, n),
                                   edge_mask=edge_mask) + diag * v)

        tx0 = x
        out = self.lins[0](tx0)
        if self.K > 1:
            tx1 = lhat(x)
            out = out + self.lins[1](tx1)
            for k in range(2, self.K):
                tx2 = 2 * lhat(tx1) - tx0
                out = out + self.lins[k](tx2)
                tx0, tx1 = tx1, tx2
        if self.bias is not None:
            out = out + self.bias
        return out


class ARMAConv(_Propagation):
    """ARMA_K filter stacks (reference ``arma_conv.py``): ``x_k^(t+1) =
    act(A_hat x_k^t W + x^(0) V)``, the output the mean over the stacks;
    ``A_hat`` the GCN normalisation without self loops. With
    ``shared_weights`` every layer after the first of a stack reuses one
    ``w_shared`` / ``v_shared`` pair. ``dropout`` is kept for the signature
    and, as in the JAX package, not applied."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_stacks: int = 1, num_layers: int = 1,
                 shared_weights: bool = False, act: str = 'relu',
                 dropout: float = 0.0, use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.num_stacks, self.num_layers = num_stacks, num_layers
        self.shared_weights = shared_weights
        self.act = getattr(torch.nn.functional, act)
        self.dropout = dropout
        self.stacks = nn.ModuleList()
        for _ in range(num_stacks):
            stack = nn.ModuleDict()
            for t in range(num_layers):
                key = 'shared' if shared_weights and t > 0 else str(t)
                if f'w_{key}' in stack:
                    continue
                stack[f'w_{key}'] = linear(
                    in_channels if t == 0 else out_channels, out_channels,
                    bias=False, device=device, generator=generator)
                stack[f'v_{key}'] = linear(in_channels, out_channels,
                                           bias=use_bias, device=device,
                                           generator=generator)
            self.stacks.append(stack)

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo, ew = gcn_norm(_coo(edge_index), edge_weight, n,
                           add_self_loops=False, dtype=x.dtype)
        outs = []
        for stack in self.stacks:
            h = x
            for t in range(self.num_layers):
                key = 'shared' if self.shared_weights and t > 0 else str(t)
                h = self.propagate(coo, x=stack[f'w_{key}'](h),
                                   edge_weight=ew, size=(n, n),
                                   edge_mask=edge_mask)
                h = self.act(h + stack[f'v_{key}'](x))
            outs.append(h)
        return torch.stack(outs, 0).mean(0)


class SGConv(_Propagation):
    """Simplified GCN (reference ``sg_conv.py``): ``W (A_hat^K x)``."""

    def __init__(self, in_channels: int, out_channels: int, K: int = 1,
                 add_self_loops: bool = True, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.K = K
        self.add_self_loops = add_self_loops
        self.lin = linear(in_channels, out_channels, bias=use_bias,
                          device=device, generator=generator)

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo, ew = gcn_norm(_coo(edge_index), edge_weight, n,
                           add_self_loops=self.add_self_loops, dtype=x.dtype)
        edge_mask = _grown(edge_mask, n, self.add_self_loops)
        for _ in range(self.K):
            x = self.propagate(coo, x=x, edge_weight=ew, size=(n, n),
                               edge_mask=edge_mask)
        return self.lin(x)


class SSGConv(_Propagation):
    """Simple spectral GCN (reference ``ssg_conv.py``): ``W (alpha x +
    (1 - alpha) / K sum_k A_hat^k x)``."""

    def __init__(self, in_channels: int, out_channels: int,
                 alpha: float = 0.1, K: int = 1, add_self_loops: bool = True,
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.alpha, self.K = alpha, K
        self.add_self_loops = add_self_loops
        self.lin = linear(in_channels, out_channels, bias=use_bias,
                          device=device, generator=generator)

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo, ew = gcn_norm(_coo(edge_index), edge_weight, n,
                           add_self_loops=self.add_self_loops, dtype=x.dtype)
        edge_mask = _grown(edge_mask, n, self.add_self_loops)
        h, acc = x, torch.zeros_like(x)
        for _ in range(self.K):
            h = self.propagate(coo, x=h, edge_weight=ew, size=(n, n),
                               edge_mask=edge_mask)
            acc = acc + h
        return self.lin(self.alpha * x + (1 - self.alpha) * acc / self.K)


class TAGConv(_Propagation):
    """Topology-adaptive GCN (reference ``tag_conv.py``): ``sum_k W_k
    A_hat^k x``, ``A_hat`` the GCN normalisation without self loops when
    ``normalize``, else the raw (weighted) adjacency."""

    def __init__(self, in_channels: int, out_channels: int, K: int = 3,
                 normalize: bool = True, use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.K = K
        self.normalize = normalize
        self.lins = nn.ModuleList(
            linear(in_channels, out_channels, bias=False, device=device,
                   generator=generator) for _ in range(K + 1))
        self.bias = _bias(out_channels, use_bias, device)

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo = _coo(edge_index)
        if self.normalize:
            coo, edge_weight = gcn_norm(coo, edge_weight, n,
                                        add_self_loops=False, dtype=x.dtype)
        out = self.lins[0](x)
        h = x
        for k in range(1, self.K + 1):
            h = self.propagate(coo, x=h, edge_weight=edge_weight,
                               size=(n, n), edge_mask=edge_mask)
            out = out + self.lins[k](h)
        if self.bias is not None:
            out = out + self.bias
        return out


class APPNP(_Propagation):
    """Approximate personalised PageRank (reference ``appnp.py``):
    ``z^(k+1) = (1 - alpha) A_hat z^k + alpha x``. No parameters;
    ``dropout`` is kept for the signature and, as in the JAX package, not
    applied."""

    def __init__(self, K: int = 10, alpha: float = 0.1,
                 add_self_loops: bool = True, dropout: float = 0.0):
        super().__init__()
        self.K, self.alpha = K, alpha
        self.add_self_loops = add_self_loops
        self.dropout = dropout

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo, ew = gcn_norm(_coo(edge_index), edge_weight, n,
                           add_self_loops=self.add_self_loops, dtype=x.dtype)
        edge_mask = _grown(edge_mask, n, self.add_self_loops)
        h = x
        for _ in range(self.K):
            h = self.propagate(coo, x=h, edge_weight=ew, size=(n, n),
                               edge_mask=edge_mask)
            h = (1 - self.alpha) * h + self.alpha * x
        return h


class MixHopConv(_Propagation):
    """Mixed adjacency powers (reference ``mixhop_conv.py``): ``concat_p
    A_hat^p x W_p``; the per-power lins have no bias and one bias spans the
    concatenation (reference ``mixhop_conv.py:71``, JAX ``:268-276``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 powers: Sequence[int] = (0, 1, 2),
                 add_self_loops: bool = True, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.powers = tuple(powers)
        self.add_self_loops = add_self_loops
        self.lins = nn.ModuleDict({
            str(p): linear(in_channels, out_channels, bias=False,
                           device=device, generator=generator)
            for p in self.powers})
        self.bias = _bias(len(self.powers) * out_channels, use_bias, device)

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo, ew = gcn_norm(_coo(edge_index), edge_weight, n,
                           add_self_loops=self.add_self_loops, dtype=x.dtype)
        edge_mask = _grown(edge_mask, n, self.add_self_loops)
        outs, h = [], x
        for p in range(max(self.powers) + 1):
            if p > 0:
                h = self.propagate(coo, x=h, edge_weight=ew, size=(n, n),
                                   edge_mask=edge_mask)
            if p in self.powers:
                outs.append(self.lins[str(p)](h))
        out = torch.cat(outs, -1)
        if self.bias is not None:
            out = out + self.bias
        return out
