"""GENConv, FiLMConv, PDNConv, GeneralConv, PNAConv and EGConv.

Counterpart of ``pytorch_geometric_tpu/nn/conv/gen_conv.py`` (reference
``nn/conv/gen_conv.py`` (DeeperGCN), ``film_conv.py``, ``pdn_conv.py``,
``general_conv.py``, ``pna_conv.py`` and ``eg_conv.py``). Each gathers its
per-edge messages and reduces them through ``ops.scatter`` or an
``nn/aggr`` module, as the JAX package does through XLA's segment ops; as
there, ``src`` and ``dst`` are clamped to the last node before they index
(a padded edge at ``n`` reads and lands in row ``n - 1`` unless
``edge_mask`` drops it). Submodules are named so that
``convert.flax_to_state_dict`` carries the flax parameters across.
"""

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..aggr import (DegreeScalerAggregation, PowerMeanAggregation,
                    SoftmaxAggregation)
from ..inits import constant, glorot, linear
from ..message_passing import MessagePassing
from ..norm import MsgNorm
from ...backend import resolve_device
from ...edge_index import EdgeIndex
from ...ops import scatter
from ...utils.loop import add_self_loops
from .gcn_conv import gcn_norm


def _coo(edge_index) -> torch.Tensor:
    return edge_index.coo if isinstance(edge_index, EdgeIndex) else edge_index


def _clamped(edge_index, n_src: int, n_dst: int):
    coo = _coo(edge_index)
    return (coo[0].long().clamp(max=n_src - 1),
            coo[1].long().clamp(max=n_dst - 1))


def _pair(c) -> Tuple[int, int]:
    return c if isinstance(c, tuple) else (c, c)


class GENConv(MessagePassing):
    """DeeperGCN's generalised convolution: messages ``relu(x_j + e_ji) +
    eps`` reduced by a softmax (``aggr_mode='softmax'``, temperature ``t``),
    a power mean (``'powermean'``, ``p``) or 'add' / 'mean' / 'max'; with
    ``msg_norm``, rescaled against the destination's raw features; plus
    the destination's features, then an MLP ``[out * expansion] *
    (num_layers - 1) + [out]``. ``lin_src``, ``lin_dst`` and ``lin_edge``
    project only on a width mismatch (``edge_dim`` names the edge
    width)."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, aggr_mode: str = 'softmax',
                 t: float = 1.0, learn_t: bool = False, p: float = 1.0,
                 learn_p: bool = False, msg_norm: bool = False,
                 learn_msg_scale: bool = False, norm: Optional[str] = None,
                 num_layers: int = 2, expansion: int = 2, eps: float = 1e-7,
                 use_bias: bool = False, edge_dim: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        from ..models.mlp import MLP    # nn/models imports this module
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst = _pair(in_channels)
        self.out_channels = out_channels
        self.eps = eps

        def proj(width):
            return (linear(width, out_channels, bias=use_bias, device=device,
                           generator=generator)
                    if width != out_channels else None)
        self.lin_src = proj(in_src)
        self.lin_dst = proj(in_dst)
        self.lin_edge = proj(edge_dim) if edge_dim is not None else None
        if aggr_mode == 'softmax':
            self.aggr = SoftmaxAggregation(t=t, learn=learn_t, device=device)
        elif aggr_mode == 'powermean':
            self.aggr = PowerMeanAggregation(p=p, learn=learn_p,
                                             device=device)
        else:
            self.aggr = aggr_mode
        self.msg_norm = (MsgNorm(learn_scale=learn_msg_scale, device=device)
                         if msg_norm else None)
        channels = [out_channels * expansion] * (num_layers - 1) + [
            out_channels]
        self.mlp = MLP(out_channels, channels, norm=norm, use_bias=use_bias,
                       device=device, generator=generator)

    def forward(self, x, edge_index,
                edge_attr: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        n_dst = x_dst.shape[0]
        h_src = x_src if self.lin_src is None else self.lin_src(x_src)
        if edge_attr is not None and self.lin_edge is not None:
            edge_attr = self.lin_edge(edge_attr)
        src, dst = _clamped(edge_index, x_src.shape[0], n_dst)
        msg = h_src[src]
        if edge_attr is not None:
            msg = msg + edge_attr
        msg = torch.relu(msg) + self.eps
        if isinstance(self.aggr, str):
            out = scatter(msg, dst, n_dst, self.aggr, mask=edge_mask)
        else:
            out = self.aggr(msg, dst, n_dst, mask=edge_mask)
        if self.msg_norm is not None:
            out = self.msg_norm(x_dst, out)
        h_dst = x_dst if self.lin_dst is None else self.lin_dst(x_dst)
        return self.mlp(out + h_dst)


class FiLMConv(MessagePassing):
    """Feature-wise linear modulation per relation: for relation ``r``,
    ``act(gamma_r(x_i) * lin_r(x_j) + beta_r(x_i))`` averaged over the
    relation's edges into each destination, summed over relations, plus
    ``act(gamma_s(x_i) * lin_skip(x_i) + beta_s(x_i))``. ``films.r`` gives
    beta then gamma (as the reference splits it); ``film_skip`` beta then
    gamma too. ``act`` names a function of ``torch.nn.functional``."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, num_relations: int = 1,
                 act: str = 'relu', device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst = _pair(in_channels)
        self.out_channels = out_channels
        self.num_relations = num_relations
        self.act = getattr(F, act)
        kw = dict(device=device, generator=generator)
        self.lins = nn.ModuleList(linear(in_src, out_channels, bias=False,
                                         **kw) for _ in range(num_relations))
        self.films = nn.ModuleList(linear(in_dst, 2 * out_channels, **kw)
                                   for _ in range(num_relations))
        self.film_skip = linear(in_dst, 2 * out_channels, bias=False, **kw)
        self.lin_skip = linear(in_dst, out_channels, bias=False, **kw)

    def forward(self, x, edge_index,
                edge_type: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        n_dst = x_dst.shape[0]
        src, dst = _clamped(edge_index, x_src.shape[0], n_dst)
        out = x_dst.new_zeros((n_dst, self.out_channels))
        for r, (lin, film) in enumerate(zip(self.lins, self.films)):
            beta, gamma = film(x_dst).chunk(2, -1)
            msg = self.act(gamma[dst] * lin(x_src)[src] + beta[dst])
            rmask = edge_mask
            if edge_type is not None:
                tm = edge_type == r
                rmask = tm if rmask is None else (rmask & tm)
            out = out + scatter(msg, dst, n_dst, 'mean', mask=rmask)
        b, g = self.film_skip(x_dst).chunk(2, -1)
        return out + self.act(g * self.lin_skip(x_dst) + b)


class PDNConv(MessagePassing):
    """Pathfinder discovery: an edge MLP (``mlp_0``, ReLU, ``mlp_1``,
    sigmoid) turns edge features into scalar weights, GCN-normalised with
    ``normalize``; ``lin`` (no bias) projects the nodes before the weighted
    sum, ``bias`` is added after it."""

    def __init__(self, in_channels: int, out_channels: int, edge_dim: int,
                 hidden_channels: int = 16, add_self_loops: bool = True,
                 normalize: bool = True, use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.add_self_loops = add_self_loops
        self.normalize = normalize
        self.mlp_0 = linear(edge_dim, hidden_channels, **kw)
        self.mlp_1 = linear(hidden_channels, 1, **kw)
        self.lin = linear(in_channels, out_channels, bias=False, **kw)
        self.bias = (constant((out_channels,), 0.0, device) if use_bias
                     else None)

    def forward(self, x, edge_index, edge_attr: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        w = torch.sigmoid(self.mlp_1(torch.relu(self.mlp_0(edge_attr))))[:, 0]
        x = self.lin(x)
        coo = _coo(edge_index)
        if self.normalize:
            coo, w = gcn_norm(coo, w, n, add_self_loops=self.add_self_loops)
            if edge_mask is not None and self.add_self_loops:
                edge_mask = torch.cat([edge_mask, edge_mask.new_ones(n)])
        out = self.propagate(coo, x=x, edge_weight=w, size=(n, n),
                             edge_mask=edge_mask)
        return out if self.bias is None else out + self.bias

    def message(self, x_j, edge_weight):
        return edge_weight[:, None] * x_j


class GeneralConv(MessagePassing):
    """GraphGym's tunable convolution: messages ``lin_msg(x_j)`` (plus
    ``lin_msg_i(x_i)`` unless ``directed_msg``, plus ``lin_edge(e)`` with
    ``in_edge_channels``), optionally weighted by a segment softmax of
    ``leaky_relu(<msg, att>)``, reduced by ``aggr``; then ``lin_self(x_i)``
    with ``skip_linear``, else ``x_i`` where the widths match; optionally
    L2-normalised. ``heads`` is accepted and unused, as in the JAX
    package."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, in_edge_channels: Optional[int] = None,
                 aggr: str = 'add', skip_linear: bool = False,
                 directed_msg: bool = True, heads: int = 1,
                 attention: bool = False, l2_normalize: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst = _pair(in_channels)
        kw = dict(device=device, generator=generator)
        self.out_channels = out_channels
        self.aggr = aggr
        self.skip_linear = skip_linear
        self.l2_normalize = l2_normalize
        self.lin_msg = linear(in_src, out_channels, **kw)
        self.lin_msg_i = (linear(in_dst, out_channels, **kw)
                          if not directed_msg else None)
        self.lin_edge = (linear(in_edge_channels, out_channels, **kw)
                         if in_edge_channels is not None else None)
        self.att = glorot((1, out_channels), **kw) if attention else None
        self.lin_self = (linear(in_dst, out_channels, **kw) if skip_linear
                         else None)

    def forward(self, x, edge_index,
                edge_attr: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        n_dst = x_dst.shape[0]
        src, dst = _clamped(edge_index, x_src.shape[0], n_dst)
        msg = self.lin_msg(x_src)[src]
        if self.lin_msg_i is not None:
            msg = msg + self.lin_msg_i(x_dst)[dst]
        if edge_attr is not None and self.lin_edge is not None:
            msg = msg + self.lin_edge(edge_attr)
        if self.att is not None:
            alpha = F.leaky_relu((msg * self.att).sum(-1), 0.2)
            alpha = self.edge_softmax(alpha, dst, n_dst, edge_mask)
            msg = msg * alpha[:, None]
        out = scatter(msg, dst, n_dst, self._aggr(), mask=edge_mask)
        if self.lin_self is not None:
            out = out + self.lin_self(x_dst)
        elif x_dst.shape[-1] == self.out_channels:
            out = out + x_dst
        if self.l2_normalize:
            out = out / torch.linalg.vector_norm(
                out, dim=-1, keepdim=True).clamp(min=1e-12)
        return out


class PNAConv(MessagePassing):
    """Principal Neighbourhood Aggregation: per tower, messages
    ``pre_nns.t([x_i, x_j(, edge_encoders.t(e))])``, the aggregators times
    the degree scalers (``DegreeScalerAggregation``), ``post_nns.t`` over
    ``[x_i, aggregated]``; the towers concatenated into ``lin_out``. With
    ``divide_input`` each tower sees its slice of the input, else all of
    it. ``avg_deg_log`` / ``avg_deg_lin`` are the training set's degree
    statistics (reference ``PNAConv.get_degree_histogram``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 aggregators: Sequence[str] = ('mean', 'min', 'max', 'std'),
                 scalers: Sequence[str] = ('identity', 'amplification',
                                           'attenuation'),
                 avg_deg_log: float = 1.0, avg_deg_lin: float = 1.0,
                 towers: int = 1, edge_dim: Optional[int] = None,
                 pre_layers: int = 1, post_layers: int = 1,
                 divide_input: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        from ..models.mlp import MLP    # nn/models imports this module
        super().__init__()
        device = resolve_device(device)
        if divide_input and in_channels % towers:
            raise ValueError(f'in_channels {in_channels} is not divisible '
                             f'by towers {towers}')
        kw = dict(device=device, generator=generator)
        self.towers = towers
        self.divide_input = divide_input
        self.tower_in = in_channels // towers if divide_input else in_channels
        self.tower_out = out_channels // towers
        f = self.tower_in
        self.edge_encoders = (nn.ModuleList(
            linear(edge_dim, f, **kw) for _ in range(towers))
            if edge_dim is not None else None)
        msg_in = (3 if edge_dim is not None else 2) * f
        self.pre_nns = nn.ModuleList(MLP(msg_in, [f] * pre_layers, **kw)
                                     for _ in range(towers))
        self.aggr = DegreeScalerAggregation(
            aggr=tuple(aggregators), scaler=tuple(scalers),
            avg_deg_log=avg_deg_log, avg_deg_lin=avg_deg_lin)
        post_in = (len(aggregators) * len(scalers) + 1) * f
        self.post_nns = nn.ModuleList(
            MLP(post_in, [self.tower_out] * post_layers, **kw)
            for _ in range(towers))
        self.lin_out = linear(towers * self.tower_out, out_channels, **kw)

    def forward(self, x, edge_index,
                edge_attr: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        src, dst = _clamped(edge_index, n, n)
        outs = []
        for t in range(self.towers):
            xt = (x[:, t * self.tower_in:(t + 1) * self.tower_in]
                  if self.divide_input else x)
            feats = [xt[dst], xt[src]]
            if edge_attr is not None and self.edge_encoders is not None:
                feats.append(self.edge_encoders[t](edge_attr))
            msg = self.pre_nns[t](torch.cat(feats, -1))
            agg = self.aggr(msg, dst, n, mask=edge_mask)
            outs.append(self.post_nns[t](torch.cat([xt, agg], -1)))
        return self.lin_out(torch.cat(outs, -1))


class EGConv(MessagePassing):
    """Efficient graph convolution: ``num_bases`` basis messages
    (``lin_bases``) aggregated by each of ``aggregators`` ('symnorm', sum,
    mean, max, min, std, var) and combined by per-node, per-head weights
    (``lin_comb``). With ``add_self_loops`` the original self loops are
    masked out and one loop a node appended (the static-shape
    ``add_remaining_self_loops``); 'symnorm' runs over the GCN-normalised
    edge set, and every aggregator over that same set."""

    def __init__(self, in_channels: int, out_channels: int,
                 aggregators: Sequence[str] = ('symnorm',),
                 num_heads: int = 8, num_bases: int = 4,
                 add_self_loops: bool = True, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if out_channels % num_heads:
            raise ValueError(f'out_channels {out_channels} is not divisible '
                             f'by num_heads {num_heads}')
        for a in aggregators:
            if a not in ('symnorm', 'sum', 'add', 'mean', 'max', 'min',
                         'std', 'var'):
                raise ValueError(f"Unknown aggregator '{a}'")
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.out_channels = out_channels
        self.aggregators = tuple(aggregators)
        self.num_heads = num_heads
        self.num_bases = num_bases
        self.add_self_loops = add_self_loops
        self.lin_bases = linear(in_channels,
                                (out_channels // num_heads) * num_bases,
                                bias=False, **kw)
        self.lin_comb = linear(in_channels,
                               num_heads * num_bases * len(aggregators), **kw)
        self.bias = (constant((out_channels,), 0.0, device) if use_bias
                     else None)

    def forward(self, x, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo = _coo(edge_index)
        bases = self.lin_bases(x)
        comb = self.lin_comb(x)
        em = edge_mask
        sym_w = None
        if self.add_self_loops:
            # the original loops stay in the buffer (weight 0 in gcn_norm)
            # and are masked, so counts, min and max do not see them twice
            loop_free = coo[0] != coo[1]
            em = loop_free if em is None else (em & loop_free)
        if 'symnorm' in self.aggregators:
            coo, sym_w = gcn_norm(coo, None, n,
                                  add_self_loops=self.add_self_loops)
            if em is not None and self.add_self_loops:
                em = torch.cat([em, em.new_ones(n)])
        elif self.add_self_loops:
            coo, _ = add_self_loops(coo, None, num_nodes=n)
            em = torch.cat([em, em.new_ones(n)])
        src, dst = _clamped(coo, n, n)
        aggs = []
        for a in self.aggregators:
            if a == 'symnorm':
                agg = self.propagate(coo, x=bases, edge_weight=sym_w,
                                     size=(n, n), edge_mask=em)
            elif a in ('std', 'var'):
                m1 = scatter(bases[src], dst, n, 'mean', mask=em)
                m2 = scatter(bases[src] ** 2, dst, n, 'mean', mask=em)
                agg = m2 - m1 * m1
                if a == 'std':
                    agg = agg.clamp(min=1e-5).sqrt()
            else:
                agg = scatter(bases[src], dst, n, a, mask=em)
            aggs.append(agg)
        ch = self.out_channels // self.num_heads
        a_b = len(self.aggregators) * self.num_bases
        agg = torch.stack(aggs, 1).reshape(n, a_b, ch)
        comb = comb.reshape(n, self.num_heads, a_b)
        out = torch.einsum('nhb,nbc->nhc', comb, agg).reshape(
            n, self.out_channels)
        return out if self.bias is None else out + self.bias

    def message(self, x_j, edge_weight=None):
        return x_j if edge_weight is None else edge_weight[:, None] * x_j
