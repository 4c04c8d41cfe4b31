"""GPSConv, RGATConv and HEATConv.

Counterpart of ``pytorch_geometric_tpu/nn/conv/gps_conv.py:20-192`` and
``:254-307`` (reference ``gps_conv.py``, ``rgat_conv.py``,
``heat_conv.py``); the file's ``SuperGATConv`` is the port's
``supergat_conv.py``. The JAX package computes all three in XLA, with no
Pallas kernel: the attention softmaxes are ``ops.softmax`` and the
aggregations ``ops.scatter`` (``index_add_``), the dense attention of
``GPSConv`` is plain PyTorch (``nn/attention/mha.py``), as here.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..attention import MultiHeadDotProductAttention, PerformerAttention
from ..dense.linear import HeteroLinear
from ..inits import embedding, glorot, linear
from ..message_passing import MessagePassing
from ..norm.norms import RunningBatchNorm
from ...backend import resolve_device
from ...edge_index import EdgeIndex
from ...ops import scatter, softmax
from ...utils.dense import node_positions, to_dense_batch


def _endpoints(edge_index, n: int):
    coo = edge_index.coo if isinstance(edge_index, EdgeIndex) else edge_index
    return coo[0].long().clamp(max=n - 1), coo[1].long().clamp(max=n - 1)


class GPSConv(nn.Module):
    """GraphGPS layer: ``h = norm1(conv(x, A) + x) + norm2(attn(x) + x)``,
    then ``norm3(h + ff2(relu(ff1(h))))``. ``attn_type``: ``'multihead'``
    (flax's dense multi-head attention over ``to_dense_batch``'s padded
    graphs) or ``'performer'`` (FAVOR+). ``norm``: ``'batch_norm'`` (flax
    ``BatchNorm``, momentum 0.9 in flax's sense: running statistics in eval
    mode), ``'layer_norm'`` (eps 1e-5, two-pass variance) or None.

    ``dropout`` must be 0: the JAX package applies none."""

    def __init__(self, channels: int, conv: Optional[MessagePassing] = None,
                 heads: int = 1, attn_type: str = 'multihead',
                 norm: Optional[str] = 'batch_norm', dropout: float = 0.0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if attn_type not in ('multihead', 'performer'):
            raise ValueError(f"attn_type {attn_type!r} is not one of "
                             "'multihead', 'performer'")
        if norm not in (None, 'batch_norm', 'layer_norm'):
            raise ValueError(f'unknown norm {norm!r}')
        if dropout:
            raise ValueError('GPSConv applies no dropout (dropout must be 0)')
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.channels, self.attn_type = channels, attn_type
        self.conv = conv
        self.norm1 = (self._norm(norm, channels, device)
                      if conv is not None else None)
        if attn_type == 'performer':
            self.attn = PerformerAttention(channels, heads, **kw)
        else:
            self.attn = MultiHeadDotProductAttention(channels, heads, **kw)
        self.norm2 = self._norm(norm, channels, device)
        self.ff1 = linear(channels, 2 * channels, **kw)
        self.ff2 = linear(2 * channels, channels, **kw)
        self.norm3 = self._norm(norm, channels, device)

    @staticmethod
    def _norm(norm, channels, device):
        if norm == 'batch_norm':
            return RunningBatchNorm(channels, eps=1e-5, momentum=0.1,
                                    device=device)
        if norm == 'layer_norm':
            return nn.LayerNorm(channels, eps=1e-5, device=device)
        return nn.Identity()

    def forward(self, x: torch.Tensor, edge_index,
                batch: Optional[torch.Tensor] = None, batch_size: int = 1,
                max_num_nodes: Optional[int] = None,
                node_mask: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None,
                **conv_kwargs) -> torch.Tensor:
        """``batch`` assigns rows to ``batch_size`` graphs; ``max_num_nodes``
        (the largest graph's size, as the reference's ``to_dense_batch``
        takes it; ``N`` when None) pads them for the attention;
        ``node_mask`` marks the rows that take part as keys."""
        n = x.shape[0]
        hs = []
        if self.conv is not None:
            h = self.conv(x, edge_index, edge_mask=edge_mask, **conv_kwargs)
            hs.append(self.norm1(h + x))
        if batch is None:
            batch = torch.zeros(n, dtype=torch.long, device=x.device)
        batch = batch.long()
        L = max_num_nodes or n
        dense, valid = to_dense_batch(x, batch, batch_size, L)
        if node_mask is not None:
            dm, _ = to_dense_batch(node_mask[:, None].int(), batch,
                                   batch_size, L)
            valid = valid & (dm[..., 0] > 0)
        if self.attn_type == 'performer':
            att = self.attn(dense, mask=valid.to(dense.dtype))
        else:
            att = self.attn(dense, dense, mask=valid[:, None, None, :])
        # back to flat rows, with the JAX package's gather: the rank
        # clamped to L - 1, a rank of -1 wrapped to L - 1, the graph
        # clamped to the last; a row whose graph lies past the end reads
        # there but sends no gradient back (the gather's transpose drops
        # what lies out of range)
        pos = node_positions(batch, batch_size).clamp(max=L - 1)
        pos = torch.where(pos < 0, pos + L, pos)
        graph = torch.where(batch < 0, batch + batch_size, batch)
        back = att[graph.clamp(0, batch_size - 1), pos]
        inside = ((graph >= 0) & (graph < batch_size))[:, None]
        hs.append(self.norm2(torch.where(inside, back, back.detach()) + x))
        out = sum(hs)
        ff = self.ff2(torch.relu(self.ff1(out)))
        return self.norm3(out + ff)


class RGATConv(MessagePassing):
    """Relational GAT (reference ``rgat_conv.py``): per-relation projections
    ``weight [R, F, H*C]`` (or ``att [R, B] @ basis [B, F, H*C]`` with
    ``num_bases``), shared query / key maps ``q``, ``k`` ``[H*C, H*d]``
    (and ``e`` over ``lin_edge(edge_attr)`` with ``edge_dim``).

      * ``attention_mechanism``: ``'across-relation'`` (one softmax over a
        node's incoming edges) or ``'within-relation'`` (one per node and
        relation, segments ``dst * R + type``);
      * ``attention_mode``: ``'additive-self-attention'`` (``leaky_relu(q_i
        + k_j (+ e_ij))``, ``dim`` 1) or ``'multiplicative-self-attention'``
        (``q_i * k_j (* e_ij)``, ``dim`` values per head);
      * ``mod``: None, ``'f-additive'`` (``alpha + 1`` where positive) or
        ``'f-scaled'`` (``alpha`` times the in-degree)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_relations: int = 1, num_bases: Optional[int] = None,
                 heads: int = 1, dim: int = 1, concat: bool = True,
                 attention_mechanism: str = 'across-relation',
                 attention_mode: str = 'additive-self-attention',
                 mod: Optional[str] = None, negative_slope: float = 0.2,
                 edge_dim: Optional[int] = None, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if attention_mechanism not in ('across-relation', 'within-relation'):
            raise ValueError(f'unknown attention_mechanism '
                             f'{attention_mechanism!r}')
        if attention_mode not in ('additive-self-attention',
                                  'multiplicative-self-attention'):
            raise ValueError(f'unknown attention_mode {attention_mode!r}')
        if mod not in (None, 'f-additive', 'f-scaled'):
            raise ValueError(f'unknown mod {mod!r}')
        if attention_mode == 'additive-self-attention' and dim != 1:
            raise ValueError('the additive attention mode takes dim=1')
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        h, c, r = heads, out_channels, num_relations
        self.heads, self.out_channels, self.num_relations = h, c, r
        self.dim, self.concat = dim, concat
        self.attention_mechanism = attention_mechanism
        self.attention_mode = attention_mode
        self.mod, self.negative_slope = mod, negative_slope
        self.weight = self.att = self.basis = None
        if num_bases is not None:
            self.att = glorot((r, num_bases), **kw)
            self.basis = glorot((num_bases, in_channels, h * c), **kw)
        else:
            self.weight = glorot((r, in_channels, h * c), **kw)
        self.q = glorot((h * c, h * dim), **kw)
        self.k = glorot((h * c, h * dim), **kw)
        self.e = self.lin_edge = None
        if edge_dim is not None:
            self.e = glorot((h * c, h * dim), **kw)
            self.lin_edge = linear(edge_dim, h * c, bias=False, **kw)
        width = h * dim * c if concat else dim * c
        self.bias = (nn.Parameter(torch.zeros(width, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, edge_index, edge_type: torch.Tensor,
                edge_attr: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        h, c, r, d = self.heads, self.out_channels, self.num_relations, \
            self.dim
        src, dst = _endpoints(edge_index, n)
        et = edge_type.long().clamp(max=r - 1)
        w = (self.weight if self.weight is not None
             else torch.einsum('rb,bfo->rfo', self.att, self.basis))
        proj = torch.einsum('nf,rfo->rno', x, w)          # [R, N, H*C]
        out_j = proj[et, src]
        out_i = proj[et, dst]
        qi = out_i @ self.q                               # [E, H*d]
        kj = out_j @ self.k
        alpha_edge = 0.0
        if edge_attr is not None:
            alpha_edge = self.lin_edge(edge_attr) @ self.e
        if self.attention_mode == 'additive-self-attention':
            alpha = F.leaky_relu(qi + kj + alpha_edge, self.negative_slope)
        else:
            alpha = qi * kj
            if edge_attr is not None:
                alpha = alpha * alpha_edge
        if self.attention_mechanism == 'within-relation':
            alpha = softmax(alpha, dst * r + et, n * r, mask=edge_mask)
        else:
            alpha = softmax(alpha, dst, n, mask=edge_mask)
        if self.mod == 'f-additive':
            alpha = torch.where(alpha > 0, alpha + 1, alpha)
        elif self.mod == 'f-scaled':
            ones = alpha.new_ones(src.shape[0])
            if edge_mask is not None:
                ones = torch.where(edge_mask, ones, 0.0)
            alpha = alpha * scatter(ones[:, None], dst, n, 'sum')[dst]
        if self.attention_mode == 'additive-self-attention':
            msg = (alpha.reshape(-1, h, 1)
                   * out_j.reshape(-1, h, c)).reshape(-1, h * c)
            out = scatter(msg, dst, n, 'sum', mask=edge_mask)
            if not self.concat:
                out = out.reshape(n, h, c).mean(1)
        else:
            msg = (alpha.reshape(-1, h, d, 1)
                   * out_j.reshape(-1, h, 1, c)).reshape(-1, h * d * c)
            out = scatter(msg, dst, n, 'sum', mask=edge_mask)
            if not self.concat:
                out = out.reshape(n, h, d * c).mean(1)
        if self.bias is not None:
            out = out + self.bias
        return out


class HEATConv(MessagePassing):
    """Heterogeneous edge-enhanced graph attention (reference
    ``heat_conv.py``): node-typed projections ``hetero_lin``, leaky-ReLU'd
    edge-type and edge-attribute embeddings (``edge_type_emb``, a flax
    ``Embed``; ``edge_attr_emb``), the attention ``att`` over ``[x_i | x_j
    | type emb | attr emb]``, the values ``lin_v([x_j | attr emb])``, and
    ``x`` added back with ``root_weight``."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_node_types: int = 1, num_edge_types: int = 1,
                 edge_type_emb_dim: int = 8, edge_dim: int = 8,
                 edge_attr_emb_dim: int = 8, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 root_weight: bool = True, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        c = out_channels
        self.heads, self.out_channels = heads, c
        self.concat, self.root_weight = concat, root_weight
        self.negative_slope = negative_slope
        self.hetero_lin = HeteroLinear(in_channels, c, num_node_types,
                                       use_bias=use_bias, **kw)
        self.edge_type_emb = embedding(num_edge_types, edge_type_emb_dim,
                                       **kw)
        self.edge_attr_emb = linear(edge_dim, edge_attr_emb_dim, bias=False,
                                    **kw)
        self.att = linear(2 * c + edge_type_emb_dim + edge_attr_emb_dim,
                          heads, bias=False, **kw)
        self.lin_v = linear(c + edge_attr_emb_dim, c, bias=use_bias, **kw)

    def forward(self, x: torch.Tensor, edge_index, node_type: torch.Tensor,
                edge_type: torch.Tensor, edge_attr: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        hd, c, slope = self.heads, self.out_channels, self.negative_slope
        src, dst = _endpoints(edge_index, n)
        h = self.hetero_lin(x, node_type)
        ete = F.leaky_relu(self.edge_type_emb(edge_type.long()), slope)
        eae = F.leaky_relu(self.edge_attr_emb(edge_attr), slope)
        h_j = h[src]
        alpha = F.leaky_relu(self.att(torch.cat([h[dst], h_j, ete, eae], -1)),
                             slope)
        v = self.lin_v(torch.cat([h_j, eae], -1))            # [E, C]
        alpha = softmax(alpha, dst, n, mask=edge_mask)
        msg = (v[:, None, :] * alpha[..., None]).reshape(-1, hd * c)
        out = scatter(msg, dst, n, 'sum', mask=edge_mask)
        if self.concat:
            if self.root_weight:
                out = (out.reshape(n, hd, c) + h[:, None, :]).reshape(
                    n, hd * c)
            return out
        out = out.reshape(n, hd, c).mean(1)
        if self.root_weight:
            out = out + h
        return out
