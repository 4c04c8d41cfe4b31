"""Graph-transformer models: SGFormer, Polynormer and GraphMixer.

Counterpart of ``pytorch_geometric_tpu/nn/models/transformers.py``
(reference ``torch_geometric/nn/models/sgformer.py``, ``polynormer.py``,
``graph_mixer.py``), in the reference's eval semantics: no dropout; the
batch norms use the batch's statistics in training mode
(``module.train()``, the JAX package's ``training=True``) and the running
ones in eval mode. The layer names are the JAX package's, so
``convert.flax_to_state_dict`` carries its parameters across.

SGFormer and Polynormer run their local branch through ``GCNConv``. As in
the JAX package it normalises ``D^-1/2 (A + I) D^-1/2`` on every call, and
then aggregates over the normalised COO by gather and ``index_add_``. With
``cached=True`` the convolutions take ``normalize=False,
add_self_loops=False`` (the reference's ``GCNConv(cached=True)``) and
``edge_index`` is ``cache_gcn_norm(EdgeIndex(...))``'s output, the same
normalisation computed once on the host: the aggregation then runs on the
SpMM regime that ``fill_cache`` chose, the segment-sum kernel for a large
sparse graph on the card.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..attention import PolynormerAttention, SGFormerAttention
from ..conv import GCNConv
from ..encoding import TemporalEncoding
from ..inits import linear
from ..norm import BatchNorm
from ...backend import resolve_device


def _gcn(in_channels, out_channels, cached, **kw):
    return GCNConv(in_channels, out_channels, normalize=not cached,
                   add_self_loops=not cached, **kw)


class SGFormer(nn.Module):
    """Global linear attention plus a GCN (reference ``sgformer.py:123``):
    ``log_softmax(fc(w * gnn(x, A) + (1 - w) * attn(x)))`` (``aggregate
    ='add'``; ``'cat'`` concatenates the two), with per-layer residuals in
    both branches. One (optionally padded) graph a call, ``mask`` marking
    its valid rows: the global attention has no notion of graphs in a flat
    layout."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, trans_num_layers: int = 2,
                 trans_num_heads: int = 1, gnn_num_layers: int = 3,
                 graph_weight: float = 0.5, aggregate: str = 'add',
                 cached: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if aggregate not in ('add', 'cat'):
            raise ValueError(f'Invalid aggregate type: {aggregate}')
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        hc = hidden_channels
        self.trans_num_layers, self.gnn_num_layers = (trans_num_layers,
                                                      gnn_num_layers)
        self.graph_weight, self.aggregate = graph_weight, aggregate
        self.tc_fc0 = linear(in_channels, hc, **kw)
        self.tc_ln0 = nn.LayerNorm(hc, eps=1e-5, device=device)
        for i in range(trans_num_layers):
            self.add_module(f'tc_attn_{i}', SGFormerAttention(
                hc, trans_num_heads, head_channels=hc, **kw))
            self.add_module(f'tc_ln_{i + 1}',
                            nn.LayerNorm(hc, eps=1e-5, device=device))
        self.gc_fc0 = linear(in_channels, hc, **kw)
        self.gc_bn0 = BatchNorm(hc, device=device)
        for i in range(gnn_num_layers):
            self.add_module(f'gc_conv_{i}', _gcn(hc, hc, cached, **kw))
            self.add_module(f'gc_bn_{i + 1}', BatchNorm(hc, device=device))
        self.fc = linear(2 * hc if aggregate == 'cat' else hc, out_channels,
                         **kw)

    def forward(self, x: torch.Tensor, edge_index,
                edge_mask: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # SGModule (reference sgformer.py:59-120)
        h = torch.relu(self.tc_ln0(self.tc_fc0(x)))
        prev = h
        for i in range(self.trans_num_layers):
            a = getattr(self, f'tc_attn_{i}')(h, mask=mask)
            h = torch.relu(getattr(self, f'tc_ln_{i + 1}')((a + prev) / 2.0))
            prev = h
        # GraphModule (reference sgformer.py:12-56)
        g = torch.relu(self.gc_bn0(self.gc_fc0(x)))
        first = g
        for i in range(self.gnn_num_layers):
            g = getattr(self, f'gc_conv_{i}')(g, edge_index,
                                              edge_mask=edge_mask)
            g = torch.relu(getattr(self, f'gc_bn_{i + 1}')(g)) + first
        if self.aggregate == 'add':
            out = self.graph_weight * g + (1 - self.graph_weight) * h
        else:
            out = torch.cat([h, g], -1)
        return torch.log_softmax(self.fc(out), -1)


class Polynormer(nn.Module):
    """Polynomial-expressive transformer (reference ``polynormer.py:12``):
    ``local_layers`` gated GCN blocks summed into ``x_local``, then, with
    ``use_global``, ``global_layers`` linear global attentions over its
    layer norm. The reference turns ``model._global`` on after a local-only
    warm-up; here ``use_global`` is an attribute to set, and both modes
    share the weights. One (optionally padded, ``mask``) graph a call."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, local_layers: int = 7,
                 global_layers: int = 2, heads: int = 1, beta: float = 0.9,
                 qk_shared: bool = False, pre_ln: bool = False,
                 post_bn: bool = True, use_global: bool = False,
                 cached: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        inner = heads * hidden_channels
        self.local_layers, self.global_layers = local_layers, global_layers
        self.beta, self.pre_ln, self.post_bn = beta, pre_ln, post_bn
        self.use_global = use_global
        self.lins = nn.ModuleList()
        for i in range(local_layers):
            width = in_channels if i == 0 else inner
            if pre_ln:
                self.add_module(f'pre_ln_{i}', nn.LayerNorm(
                    width, eps=1e-5, device=device))
            self.add_module(f'h_lin_{i}', linear(width, inner, **kw))
            self.add_module(f'local_conv_{i}', _gcn(width, inner, cached,
                                                    **kw))
            self.lins.append(linear(width, inner, **kw))
            if post_bn:
                self.add_module(f'post_bn_{i}', BatchNorm(inner,
                                                          device=device))
            self.add_module(f'ln_{i}', nn.LayerNorm(inner, eps=1e-5,
                                                    device=device))
        self.ln = nn.LayerNorm(inner, eps=1e-5, device=device)
        for j in range(global_layers):
            self.add_module(f'global_attn_{j}', PolynormerAttention(
                inner, heads, head_channels=hidden_channels, beta=beta,
                qk_shared=qk_shared, **kw))
        self.pred_global = linear(inner, out_channels, **kw)
        self.pred_local = linear(inner, out_channels, **kw)

    def forward(self, x: torch.Tensor, edge_index,
                edge_mask: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_local = 0.0
        for i in range(self.local_layers):
            if self.pre_ln:
                x = getattr(self, f'pre_ln_{i}')(x)
            h = torch.relu(getattr(self, f'h_lin_{i}')(x))
            x = (getattr(self, f'local_conv_{i}')(x, edge_index,
                                                  edge_mask=edge_mask)
                 + self.lins[i](x))
            if self.post_bn:
                x = getattr(self, f'post_bn_{i}')(x)
            x = torch.relu(x)
            x = ((1 - self.beta) * getattr(self, f'ln_{i}')(h * x)
                 + self.beta * x)
            x_local = x_local + x
        if self.use_global:
            g = self.ln(x_local)
            for j in range(self.global_layers):
                g = getattr(self, f'global_attn_{j}')(g, mask=mask)
            out = self.pred_global(g)
        else:
            out = self.pred_local(x_local)
        return torch.log_softmax(out, -1)


class GraphMixer(nn.Module):
    """Temporal link encoder (reference ``graph_mixer.py``): each node's
    ``num_tokens`` most recent links, their features beside a
    ``TemporalEncoding`` of their time deltas, through an MLP-mixer
    (``token_in``; token mixing ``token_mix`` over the links, channel
    mixing ``chan_mix`` after ``ln``; GELU in flax's tanh form), then the
    mean over the valid links and ``head``."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, num_tokens: int = 8,
                 time_channels: int = 16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.time_enc = TemporalEncoding(time_channels)
        self.token_in = linear(in_channels + time_channels, hidden_channels,
                               **kw)
        self.token_mix = linear(num_tokens, num_tokens, **kw)
        self.ln = nn.LayerNorm(hidden_channels, eps=1e-5, device=device)
        self.chan_mix = linear(hidden_channels, hidden_channels, **kw)
        self.head = linear(hidden_channels, out_channels, **kw)

    def forward(self, link_feats: torch.Tensor, link_times: torch.Tensor,
                link_mask: torch.Tensor) -> torch.Tensor:
        """``link_feats [N, T, F]`` (zero padded), ``link_times [N, T]``
        time deltas, ``link_mask [N, T]``; ``T = num_tokens``."""
        te = self.time_enc(link_times.reshape(-1)).reshape(
            tuple(link_times.shape) + (-1,))
        h = self.token_in(torch.cat([link_feats, te], -1))
        h = torch.where(link_mask[..., None], h, 0.0)
        t = self.token_mix(F.gelu(h.transpose(1, 2), approximate='tanh'))
        h = h + t.transpose(1, 2)
        h = h + self.chan_mix(F.gelu(self.ln(h), approximate='tanh'))
        pooled = h.sum(1) / link_mask.sum(1, keepdim=True).clamp(min=1)
        return self.head(pooled)
