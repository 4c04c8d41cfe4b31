"""Simple neighbourhood-aggregation convolutions.

Counterpart of ``pytorch_geometric_tpu/nn/conv/graph_conv.py`` (reference
``torch_geometric/nn/conv/graph_conv.py``, ``cluster_gcn_conv.py``,
``res_gated_graph_conv.py``, ``gated_graph_conv.py``, ``le_conv.py``,
``mf_conv.py``, ``fa_conv.py``, ``agnn_conv.py``,
``wl_conv_continuous.py``, ``lg_conv.py``). ``GraphConv`` and
``ClusterGCNConv`` aggregate through ``MessagePassing``: over an
``EdgeIndex`` with its CSC cached, a weighted SpMM (``ops.spmm``, kernel 1
on the card); over a raw COO, a gather and a scatter. The others gather and
scatter, as the JAX package's do: ``ResGatedGraphConv``, ``GatedGraphConv``,
``LEConv`` and ``MFConv`` hand ``propagate`` the ``edge_index`` they were
given, the rest strip it to its COO. Submodules are named as the flax
modules name them (``lin_rel``, ``lin_root``, ``lin_out``, ``lin_key``,
``rnn``, ``lin1`` ...; MFConv's ``lin_l_d`` / ``lin_r_d`` are ``lins_l.d``
/ ``lins_r.d``), so ``convert.flax_to_state_dict`` carries their
parameters across.
"""

from typing import Optional, Tuple, Union

import torch

from torch import nn

from ..inits import constant, glorot, gru_cell, linear
from ..message_passing import MessagePassing
from ...backend import resolve_device
from ...edge_index import EdgeIndex
from ...ops import scatter, spmm
from ...utils.core import degree
from .gcn_conv import gcn_norm


def _coo(edge_index):
    return edge_index.coo if isinstance(edge_index, EdgeIndex) else edge_index


class _WeightedGather(MessagePassing):
    """Messages ``w_ij x_j`` (``x_j`` without weights), gathered: no fused
    SpMM, as the JAX package's convs of this kind have none."""

    def message(self, x_j, edge_weight=None):
        return x_j if edge_weight is None else edge_weight[:, None] * x_j


class _WeightedAggregation(_WeightedGather):
    """The same messages, fused into one weighted SpMM over a cached
    CSC."""

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


class ResGatedGraphConv(MessagePassing):
    """Residual gated conv (reference ``res_gated_graph_conv.py``):
    ``x'_i = W1 x_i + sum_j eta_ij * W2 x_j``, ``eta_ij = sigmoid(W3 x_i +
    W4 x_j)`` (``lin_key`` on the destination, ``lin_query`` and
    ``lin_value`` on the source), ``lin_skip`` without bias when
    ``root_weight``, then one ``bias``. The gate is the sigmoid whatever
    ``act`` says, as in the JAX package."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, act: str = 'sigmoid',
                 root_weight: bool = True, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst = (in_channels if isinstance(in_channels, tuple)
                          else (in_channels, in_channels))
        self.in_channels, self.out_channels = in_channels, out_channels
        self.act = act
        self.root_weight = root_weight
        kw = dict(device=device, generator=generator)
        self.lin_key = linear(in_dst, out_channels, **kw)
        self.lin_query = linear(in_src, out_channels, **kw)
        self.lin_value = linear(in_src, out_channels, **kw)
        self.lin_skip = (linear(in_dst, out_channels, bias=False, **kw)
                         if root_weight else None)
        self.bias = (constant((out_channels,), 0.0, device) if use_bias
                     else None)

    def forward(self, x, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        out = self.propagate(edge_index, k=self.lin_key(x_dst),
                             q=self.lin_query(x_src), v=self.lin_value(x_src),
                             size=(x_src.shape[0], x_dst.shape[0]),
                             edge_mask=edge_mask)
        if self.root_weight:
            out = out + self.lin_skip(x_dst)
        if self.bias is not None:
            out = out + self.bias
        return out

    def message(self, k_i, q_j, v_j):
        return torch.sigmoid(k_i + q_j) * v_j


class GatedGraphConv(_WeightedGather):
    """Gated graph conv (Li et al.; reference ``gated_graph_conv.py``): the
    input zero-padded to ``out_channels``, then ``num_layers`` rounds of
    ``m = A (x W_l)`` and ``x = GRU(m, x)`` (``torch.nn.GRUCell`` with the
    message as input and the node state as hidden state, as flax's
    ``GRUCell`` runs with the state as carry, JAX ``graph_conv.py:103-109``).

    flax's cell has no hidden biases for the reset and update gates;
    ``convert.py`` loads ``b_hr = b_hz = 0``. torch's cell keeps them as
    parameters, so a trained port model may move them off 0. The
    ``edge_index`` goes to ``propagate`` as given, an ``EdgeIndex`` too, and
    is aggregated by gather."""

    def __init__(self, out_channels: int, num_layers: int = 1,
                 aggr: str = 'add', device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.out_channels, self.num_layers = out_channels, num_layers
        self.aggr = aggr
        self.weight = glorot((num_layers, out_channels, out_channels),
                             device, generator)
        self.rnn = gru_cell(out_channels, out_channels, device, generator)

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, f = x.shape
        if f > self.out_channels:
            raise ValueError('input channels must be <= out_channels')
        if f < self.out_channels:
            x = nn.functional.pad(x, (0, self.out_channels - f))
        for i in range(self.num_layers):
            m = self.propagate(edge_index, x=x @ self.weight[i],
                               edge_weight=edge_weight, size=(n, n),
                               edge_mask=edge_mask)
            x = self.rnn(m, x)
        return x


class LEConv(MessagePassing):
    """Local extremum conv (reference ``le_conv.py:58-76``): ``x'_i = W3
    x_i + sum_j w_ji (W1 x_j - W2 x_i)`` (``lin1``, ``lin3`` with bias when
    ``use_bias``, ``lin2`` without)."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst = (in_channels if isinstance(in_channels, tuple)
                          else (in_channels, in_channels))
        self.in_channels, self.out_channels = in_channels, out_channels
        kw = dict(device=device, generator=generator)
        self.lin1 = linear(in_src, out_channels, bias=use_bias, **kw)
        self.lin2 = linear(in_dst, out_channels, bias=False, **kw)
        self.lin3 = linear(in_dst, out_channels, bias=use_bias, **kw)

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        out = self.propagate(edge_index, a=self.lin1(x_src),
                             b=self.lin2(x_dst), edge_weight=edge_weight,
                             size=(x_src.shape[0], x_dst.shape[0]),
                             edge_mask=edge_mask)
        return out + self.lin3(x_dst)

    def message(self, a_j, b_i, edge_weight=None):
        m = a_j - b_i
        return m if edge_weight is None else edge_weight[:, None] * m


class MFConv(MessagePassing):
    """Degree-specific weights (molecular fingerprints; reference
    ``mf_conv.py``): the neighbours' sum through ``lins_l[d]`` plus the
    node through ``lins_r[d]`` (no bias), ``d`` its in-degree capped at
    ``max_degree``. Every bank runs on every node and each node takes its
    own, as the JAX package computes it."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, max_degree: int = 10, aggr: str = 'add',
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst = (in_channels if isinstance(in_channels, tuple)
                          else (in_channels, in_channels))
        self.in_channels, self.out_channels = in_channels, out_channels
        self.max_degree = max_degree
        self.aggr = aggr
        kw = dict(device=device, generator=generator)
        self.lins_l = nn.ModuleList(linear(in_src, out_channels, **kw)
                                    for _ in range(max_degree + 1))
        self.lins_r = nn.ModuleList(linear(in_dst, out_channels, bias=False,
                                           **kw)
                                    for _ in range(max_degree + 1))

    def forward(self, x, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        n_dst = x_dst.shape[0]
        deg = degree(_coo(edge_index)[1], n_dst, mask=edge_mask).long()
        deg = deg.clamp(max=self.max_degree)
        h = self.propagate(edge_index, x=(x_src, x_dst),
                           size=(x_src.shape[0], n_dst), edge_mask=edge_mask)
        stacked = torch.stack([lin_l(h) + lin_r(x_dst) for lin_l, lin_r
                               in zip(self.lins_l, self.lins_r)])
        return stacked[deg, torch.arange(n_dst, device=deg.device)]


class FAConv(_WeightedGather):
    """Frequency-adaptive conv (reference ``fa_conv.py:205-217``):
    ``alpha_ij = tanh(a_l . x_j + a_r . x_i)``, ``x' = eps x_0 + sum_j
    alpha_ij w_ij x_j``. With ``normalize`` the weights are the GCN
    normalisation of the unweighted graph (self loops added when
    ``add_self_loops``) and a given ``edge_weight`` is not used, as in the
    JAX package."""

    def __init__(self, channels: int, eps: float = 0.1,
                 add_self_loops: bool = True, normalize: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.channels = channels
        self.eps = eps
        self.add_self_loops = add_self_loops
        self.normalize = normalize
        kw = dict(bias=False, device=device, generator=generator)
        self.att_l = linear(channels, 1, **kw)
        self.att_r = linear(channels, 1, **kw)

    def forward(self, x, edge_index, x_0: Optional[torch.Tensor] = None,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x_0 is None:
            x_0 = x
        n = x.shape[0]
        coo = _coo(edge_index)
        if self.normalize:
            coo, edge_weight = gcn_norm(coo, None, n,
                                        add_self_loops=self.add_self_loops,
                                        dtype=x.dtype)
            if edge_mask is not None and self.add_self_loops:
                edge_mask = torch.cat([edge_mask, edge_mask.new_ones(n)])
        out = self.propagate(coo, x=x, al=self.att_l(x)[:, 0],
                             ar=self.att_r(x)[:, 0], edge_weight=edge_weight,
                             size=(n, n), edge_mask=edge_mask)
        return out + self.eps * x_0

    def message(self, x_j, al_j, ar_i, edge_weight=None):
        alpha = torch.tanh(al_j + ar_i)
        if edge_weight is not None:
            alpha = alpha * edge_weight
        return alpha[:, None] * x_j


class AGNNConv(MessagePassing):
    """Attention over cosine similarity (reference ``agnn_conv.py``):
    ``alpha_ij = softmax_j(beta cos(x_i, x_j))``, ``x'_i = sum_j alpha_ij
    x_j``. With ``add_self_loops`` (the default, reference ``:66-72``) the
    existing loops are masked out and one fresh loop a node is appended.
    ``beta`` is a parameter when ``requires_grad_beta``, else a buffer of
    1. An edge at the padding sentinel joins the last node's softmax unless
    ``edge_mask`` drops it, as in the JAX package."""

    def __init__(self, requires_grad_beta: bool = True,
                 add_self_loops: bool = True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.add_self_loops = add_self_loops
        if requires_grad_beta:
            self.beta = constant((1,), 1.0, device)
        else:
            self.register_buffer('beta', torch.ones(1, device=device),
                                 persistent=False)

    def forward(self, x, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo = _coo(edge_index)
        if self.add_self_loops:
            loop_free = coo[0] != coo[1]
            edge_mask = (loop_free if edge_mask is None
                         else edge_mask & loop_free)
            loops = torch.arange(n, dtype=coo.dtype, device=coo.device)
            coo = torch.cat([coo, torch.stack([loops, loops])], 1)
            edge_mask = torch.cat([edge_mask, edge_mask.new_ones(n)])
        xn = x * (x * x).sum(-1, keepdim=True).clamp(min=1e-24).rsqrt()
        src = coo[0].long().clamp(max=n - 1)
        dst = coo[1].long().clamp(max=n - 1)
        cos = (xn[src] * xn[dst]).sum(-1)
        alpha = self.edge_softmax(self.beta * cos, dst, n, edge_mask)
        return self.propagate(coo, x=x, alpha=alpha, size=(n, n),
                              edge_mask=edge_mask)

    def message(self, x_j, alpha):
        return alpha[:, None] * x_j


class WLConvContinuous(_WeightedGather):
    """Continuous 1-WL (reference ``wl_conv_continuous.py``): ``x' = 0.5
    (x_i + mean_j x_j)``; with ``edge_weight`` the mean is weighted, ``sum_j
    w_ij x_j / sum_j w_ij``."""

    def __init__(self):
        super().__init__()
        self.aggr = 'mean'

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        n_dst = x_dst.shape[0]
        if edge_weight is not None:
            coo = _coo(edge_index)
            src = coo[0].long().clamp(max=x_src.shape[0] - 1)
            dst = coo[1].long().clamp(max=n_dst - 1)
            w = (edge_weight if edge_mask is None
                 else torch.where(edge_mask, edge_weight, 0))
            num = scatter(w[:, None] * x_src[src], dst, n_dst, 'sum',
                          mask=edge_mask)
            den = scatter(w, dst, n_dst, 'sum', mask=edge_mask)
            out = num / den.clamp(min=1e-12)[:, None]
        else:
            out = self.propagate(edge_index, x=(x_src, x_dst),
                                 size=(x_src.shape[0], n_dst),
                                 edge_mask=edge_mask)
        return 0.5 * (x_dst + out)


class LGConv(_WeightedGather):
    """LightGCN's conv (reference ``lg_conv.py``): ``x'_i = sum_j w_ij x_j``
    with the GCN normalisation without self loops when ``normalize``."""

    def __init__(self, normalize: bool = True):
        super().__init__()
        self.normalize = normalize

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo = _coo(edge_index)
        if self.normalize:
            coo, edge_weight = gcn_norm(coo, edge_weight, n,
                                        add_self_loops=False, dtype=x.dtype)
        return self.propagate(coo, x=x, edge_weight=edge_weight, size=(n, n),
                              edge_mask=edge_mask)
