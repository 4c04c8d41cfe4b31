"""GATConv / GATv2Conv: attention convolutions.

Counterpart of ``pytorch_geometric_tpu/nn/conv/gat_conv.py``. The attention
coefficients are LeakyReLU -> softmax over each destination's incoming
edges -> dropout; the message is ``alpha * x_j``. Three branches, chosen as
the JAX package chooses them (``gat_conv.py:121-161``, ``:237-273``), from
shapes alone and before any per-edge array is built:

  * fused: when the edge index carries the slot orders
    (``fill_cache(blocked=True)``), the conv did not rewrite the edge set
    (no self loops added at call time) and no attention weights are asked
    for, the softmax and the aggregation run as one
    ``ops.gat_fused.gat_aggregate``, through the hand-written mix kernel on
    the card (its plain version on the CPU). ``backend.use_kernel_spmm``
    plays the JAX package's ``_use_pallas()``: off, the CPU takes the plain
    branch, and the card raises, since the plain branch never stands in for
    the kernel there;
  * flash: not fused, no attention weights, no ``edge_attr``, no active
    dropout, and ``E * H * C * 4`` bytes of messages past
    ``PGT_ATTN_WIDE_BYTES`` (read on every call, default 1e9): the
    online-softmax scan of ``ops.edge_attention`` (``gat_flash_attention``,
    ``gatv2_flash_attention``; the flash kernels on the card) over the
    node-level logit parts, with no ``[E, .]`` float array;
  * plain: ``ops.softmax`` and a gather / ``index_add_`` in PyTorch on either
    device, as the JAX package leaves this branch to XLA.
"""

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..inits import linear
from ..message_passing import MessagePassing
from ...backend import resolve_device
from ...edge_index import EdgeIndex
from ...ops.edge_attention import (gat_flash_attention,
                                    gatv2_flash_attention, wide_bytes_cap)
from ...ops.gat_fused import fused_ok, gat_aggregate
from ...ops.gather import take_rows
from ...ops.softmax import softmax
from ...utils.loop import add_self_loops as _add_self_loops


def _glorot(shape, device, generator) -> nn.Parameter:
    """flax's ``glorot_uniform`` for an attention vector ``(1, H, C)``:
    fan-in ``H``, fan-out ``C``."""
    limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    t = torch.empty(shape).uniform_(-limit, limit, generator=generator)
    return nn.Parameter(t.to(device))


def _split(in_channels: Union[int, Tuple[int, int]]):
    if isinstance(in_channels, int):
        return in_channels, in_channels, False
    return in_channels[0], in_channels[1], True


def _loop_edge_attr(edge_attr, dst, keep, num_dst, fill_value):
    """Edge features of the appended self loops: ``fill_value='mean'`` is
    the mean of each node's kept incoming edge features; a number fills."""
    if not isinstance(fill_value, str):
        return edge_attr.new_full((num_dst,) + edge_attr.shape[1:],
                                  fill_value)
    if fill_value != 'mean':
        raise ValueError(f'Unsupported fill_value {fill_value!r}')
    w = keep.to(edge_attr.dtype)
    seg = torch.where(keep, dst.long().clamp(max=num_dst - 1), num_dst)
    flat = edge_attr.reshape(edge_attr.shape[0], -1)
    sums = flat.new_zeros((num_dst + 1, flat.shape[1])).index_add_(
        0, seg, flat * w[:, None])
    cnt = w.new_zeros(num_dst + 1).index_add_(0, seg, w)
    mean = sums[:num_dst] / torch.clamp(cnt[:num_dst, None], min=1)
    return mean.reshape((num_dst,) + edge_attr.shape[1:])


def _dropout_scale(dropout: float, deterministic: bool, shape, device,
                   generator: Optional[torch.Generator]):
    """Numerator-only dropout multiplier, ``keep / (1 - dropout)`` from
    ``generator`` (None when inactive)."""
    if dropout <= 0 or deterministic:
        return None
    dev = generator.device if generator is not None else device
    keep = torch.rand(shape, generator=generator, device=dev) < 1.0 - dropout
    return keep.to(device=device, dtype=torch.float32) / (1.0 - dropout)


def _self_loops(coo, edge_attr, edge_mask, num_dst, fill_value):
    """The reference's remove-then-add of self loops with static shapes:
    existing loops are masked out and one loop per node is appended."""
    keep = coo[0] != coo[1]
    edge_mask = keep if edge_mask is None else (edge_mask & keep)
    if edge_attr is not None:
        loop_attr = _loop_edge_attr(edge_attr, coo[1], edge_mask, num_dst,
                                    fill_value)
        edge_attr = torch.cat([edge_attr, loop_attr])
    coo, _ = _add_self_loops(coo, num_nodes=num_dst)
    edge_mask = torch.cat([edge_mask, edge_mask.new_ones(num_dst)])
    return coo, edge_attr, edge_mask


def _branch(conv, edge_index, values, loops, n_edges, edge_attr,
            deterministic, return_attention_weights) -> str:
    """'fused', 'flash' or 'plain', as the JAX package decides, from shapes,
    caches and ``PGT_ATTN_WIDE_BYTES`` only."""
    if (not loops and not return_attention_weights
            and fused_ok(edge_index, values)):
        return 'fused'
    h, c = values.shape[1], values.shape[2]
    if (not return_attention_weights and edge_attr is None
            and (conv.dropout == 0 or deterministic)
            and n_edges * h * c * 4 > wide_bytes_cap()):
        return 'flash'
    return 'plain'


def _attend(conv, branch, edge_index, alpha, values, valid, i_idx, j_idx,
            num_dst, deterministic, generator):
    """The fused or plain branch over the activated logits ``alpha [E,
    H]``; returns ``[num_dst, H, C]`` and the weights."""
    h, c = values.shape[1], values.shape[2]
    if branch == 'fused':
        scale = _dropout_scale(conv.dropout, deterministic, alpha.shape,
                               alpha.device, generator)
        return gat_aggregate(edge_index, alpha, values, edge_mask=valid,
                             numerator_scale=scale), None
    alpha = softmax(alpha, i_idx, num_dst, mask=valid)
    scale = _dropout_scale(conv.dropout, deterministic, alpha.shape,
                           alpha.device, generator)
    if scale is not None:
        alpha = alpha * scale
    msgs = torch.where(valid[:, None, None], values[j_idx] * alpha[..., None],
                       0.0)
    return values.new_zeros((num_dst, h, c)).index_add_(0, i_idx, msgs), alpha


def _finish(conv, out, coo, alpha, return_attention_weights):
    num_dst = out.shape[0]
    out = (out.reshape(num_dst, -1) if conv.concat else out.mean(dim=1))
    if conv.bias is not None:
        out = out + conv.bias
    if return_attention_weights:
        return out, (coo, alpha)
    return out


class GATConv(MessagePassing):
    """GAT (Velickovic et al.): ``alpha = softmax(LeakyReLU(a_s . W x_j +
    a_d . W x_i [+ a_e . W_e e_ij]))``, ``x'_i = sum_j alpha_ij W x_j``.

    ``in_channels`` as a pair ``(src, dst)`` gives the conv its own
    ``lin_dst`` for a distinct ``x_dst``; a single tensor, or a pair of one
    object, shares ``lin_src`` whatever ``in_channels`` was, and a distinct
    ``x_dst`` without ``lin_dst`` raises. ``edge_dim`` adds ``lin_edge`` and
    ``att_edge`` for ``edge_attr``. Parameter names follow the JAX
    package's, so ``convert.flax_to_state_dict`` carries its weights."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, heads: int = 1, concat: bool = True,
                 negative_slope: float = 0.2, dropout: float = 0.0,
                 add_self_loops: bool = True, edge_dim: Optional[int] = None,
                 fill_value: Union[float, str] = 'mean',
                 use_bias: bool = True, aggr: str = 'sum', device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst, bipartite = _split(in_channels)
        self.out_channels, self.heads, self.concat = out_channels, heads, concat
        self.negative_slope, self.dropout = negative_slope, dropout
        self.add_self_loops, self.fill_value = add_self_loops, fill_value
        self.aggr = aggr
        hc = heads * out_channels
        kw = dict(device=device, generator=generator)
        self.lin_src = linear(in_src, hc, bias=False, init='glorot_uniform',
                              **kw)
        self.lin_dst = (linear(in_dst, hc, bias=False, init='glorot_uniform',
                               **kw) if bipartite else None)
        self.att_src = _glorot((1, heads, out_channels), **kw)
        self.att_dst = _glorot((1, heads, out_channels), **kw)
        self.lin_edge = self.att_edge = None
        if edge_dim is not None:
            self.lin_edge = linear(edge_dim, hc, bias=False, **kw)
            self.att_edge = _glorot((1, heads, out_channels), **kw)
        self.bias = (nn.Parameter(torch.zeros(hc if concat else out_channels,
                                              device=device))
                     if use_bias else None)

    def forward(self, x: Union[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]],
                edge_index, edge_attr: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                return_attention_weights: bool = False,
                generator: Optional[torch.Generator] = None):
        """``deterministic=False`` applies attention dropout, drawn from
        ``generator`` (the default generator of ``x``'s device if None)."""
        h, c = self.heads, self.out_channels
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        num_src, num_dst = x_src.shape[0], x_dst.shape[0]
        xs = self.lin_src(x_src).view(num_src, h, c)
        # the JAX package decides by identity (gat_conv.py:70-81): one
        # tensor, or a pair of one object, shares lin_src
        if x_dst is x_src:
            xd = xs
        elif self.lin_dst is None:
            raise ValueError('GATConv got a distinct x_dst but has no '
                             'lin_dst: build it with in_channels=(src, dst) '
                             'for a bipartite graph')
        else:
            xd = self.lin_dst(x_dst).view(num_dst, h, c)
        alpha_src = (xs * self.att_src).sum(-1)          # [N_src, H]
        alpha_dst = (xd * self.att_dst).sum(-1)          # [N_dst, H]

        coo = edge_index.coo if isinstance(edge_index, EdgeIndex) \
            else edge_index
        loops = self.add_self_loops and num_src == num_dst
        if loops:
            coo, edge_attr, edge_mask = _self_loops(
                coo, edge_attr, edge_mask, num_dst, self.fill_value)
        j_idx = coo[0].long().clamp(max=num_src - 1)
        i_idx = coo[1].long().clamp(max=num_dst - 1)
        valid = coo[1] < num_dst
        if edge_mask is not None:
            valid = valid & edge_mask
        branch = _branch(self, edge_index, xs, loops, coo.shape[1], edge_attr,
                         deterministic, return_attention_weights)
        if branch == 'flash':
            # the node-level logit parts; leaky_relu runs inside the scan
            out = gat_flash_attention(
                alpha_src, alpha_dst, xs, j_idx,
                torch.where(valid, i_idx, num_dst), num_dst,
                negative_slope=self.negative_slope)
            return _finish(self, out, coo, None, False)
        alpha = take_rows(alpha_src, j_idx) + take_rows(alpha_dst, i_idx)
        if edge_attr is not None:
            if self.lin_edge is None:
                raise ValueError('GATConv got edge_attr but was built with '
                                 'edge_dim=None')
            ea = self.lin_edge(edge_attr).view(-1, h, c)
            alpha = alpha + (ea * self.att_edge).sum(-1)
        alpha = F.leaky_relu(alpha, self.negative_slope)
        out, alpha = _attend(self, branch, edge_index, alpha, xs, valid, i_idx,
                             j_idx, num_dst, deterministic, generator)
        return _finish(self, out, coo, alpha, return_attention_weights)


class GATv2Conv(MessagePassing):
    """GATv2 (Brody et al.): the attention vector applies after the
    nonlinearity, on the joint transformed features ``W_l x_j + W_r x_i
    [+ W_e e_ij]``."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, heads: int = 1, concat: bool = True,
                 negative_slope: float = 0.2, dropout: float = 0.0,
                 add_self_loops: bool = True, edge_dim: Optional[int] = None,
                 fill_value: Union[float, str] = 'mean',
                 use_bias: bool = True, share_weights: bool = False,
                 aggr: str = 'sum', device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst, _ = _split(in_channels)
        self.out_channels, self.heads, self.concat = out_channels, heads, concat
        self.negative_slope, self.dropout = negative_slope, dropout
        self.add_self_loops, self.fill_value = add_self_loops, fill_value
        self.share_weights, self.aggr = share_weights, aggr
        hc = heads * out_channels
        kw = dict(device=device, generator=generator)
        self.lin_l = linear(in_src, hc, bias=use_bias, init='glorot_uniform',
                            **kw)
        self.lin_r = (None if share_weights else
                      linear(in_dst, hc, bias=use_bias,
                             init='glorot_uniform', **kw))
        self.lin_edge = (linear(edge_dim, hc, bias=False, **kw)
                         if edge_dim is not None else None)
        self.att = _glorot((1, heads, out_channels), **kw)
        self.bias = (nn.Parameter(torch.zeros(hc if concat else out_channels,
                                              device=device))
                     if use_bias else None)

    def forward(self, x, edge_index, edge_attr: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                return_attention_weights: bool = False,
                generator: Optional[torch.Generator] = None):
        h, c = self.heads, self.out_channels
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        num_src, num_dst = x_src.shape[0], x_dst.shape[0]
        x_l = self.lin_l(x_src).view(num_src, h, c)
        x_r = (self.lin_l if self.share_weights else self.lin_r)(
            x_dst).view(num_dst, h, c)

        coo = edge_index.coo if isinstance(edge_index, EdgeIndex) \
            else edge_index
        loops = self.add_self_loops and num_src == num_dst
        if loops:
            coo, edge_attr, edge_mask = _self_loops(
                coo, edge_attr, edge_mask, num_dst, self.fill_value)
        j_idx = coo[0].long().clamp(max=num_src - 1)
        i_idx = coo[1].long().clamp(max=num_dst - 1)
        valid = coo[1] < num_dst
        if edge_mask is not None:
            valid = valid & edge_mask
        branch = _branch(self, edge_index, x_l, loops, coo.shape[1],
                         edge_attr, deterministic, return_attention_weights)
        if branch == 'flash':
            # the [E, H, C] joint features are formed per edge in the scan
            out = gatv2_flash_attention(
                x_l, x_r, self.att[0], j_idx,
                torch.where(valid, i_idx, num_dst), num_dst,
                negative_slope=self.negative_slope)
            return _finish(self, out, coo, None, False)
        joint = x_l[j_idx] + x_r[i_idx]                  # [E, H, C]
        if edge_attr is not None:
            if self.lin_edge is None:
                raise ValueError('GATv2Conv got edge_attr but was built with '
                                 'edge_dim=None')
            joint = joint + self.lin_edge(edge_attr).view(-1, h, c)
        joint = F.leaky_relu(joint, self.negative_slope)
        alpha = (joint * self.att).sum(-1)               # [E, H]
        out, alpha = _attend(self, branch, edge_index, alpha, x_l, valid,
                             i_idx, j_idx, num_dst, deterministic, generator)
        return _finish(self, out, coo, alpha, return_attention_weights)


class FusedGATConv(GATConv):
    """Alias of :class:`GATConv`: the fused branch is the default whenever
    the slot orders are cached (see ``ops/gat_fused.py``)."""

    @staticmethod
    def to_graph_format(edge_index, size=None) -> EdgeIndex:
        """The edge index with its slot orders filled, the counterpart of
        the CSR / CSC / permutation triple the reference's dgNN kernels
        take."""
        if not isinstance(edge_index, EdgeIndex):
            edge_index = EdgeIndex(edge_index, size)
        return edge_index.fill_cache(blocked=True)


# the reference's cugraph GAT wraps CUDA kernels; here the fused branch
# plays that role
CuGraphGATConv = FusedGATConv
