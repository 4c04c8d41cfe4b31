"""QFormer: learned-query cross-attention pooling.

Counterpart of ``pytorch_geometric_tpu/nn/attention/qformer.py`` (reference
``torch_geometric/nn/attention/qformer.py``).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .mha import MultiHeadDotProductAttention
from ..inits import linear
from ...backend import resolve_device


class QFormer(nn.Module):
    """``num_queries`` learned queries (``queries``, drawn from N(0,
    0.02^2)) cross-attend the input sequence projected by ``in_proj``;
    each of ``num_layers`` layers is ``cross_i`` (flax multi-head
    attention), ``ln1_i``, a GELU (tanh form, flax's default) feed-forward
    ``ffh_i`` / ``ff_i`` and ``ln2_i`` (flax ``LayerNorm``s, eps 1e-6).
    ``mask [B, N]`` (True valid) masks the keys."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_queries: int = 32, heads: int = 4, num_layers: int = 2,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        hc = hidden_channels
        self.queries = nn.Parameter(
            (torch.randn((num_queries, hc), generator=generator) * 0.02)
            .to(device))
        self.in_proj = linear(in_channels, hc, **kw)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f'cross_{i}', MultiHeadDotProductAttention(
                hc, heads, **kw))
            self.add_module(f'ln1_{i}', nn.LayerNorm(hc, eps=1e-6,
                                                     device=device))
            self.add_module(f'ffh_{i}', linear(hc, 2 * hc, **kw))
            self.add_module(f'ff_{i}', linear(2 * hc, hc, **kw))
            self.add_module(f'ln2_{i}', nn.LayerNorm(hc, eps=1e-6,
                                                     device=device))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        b = x.shape[0]
        q = self.queries[None].expand((b,) + self.queries.shape)
        kv = self.in_proj(x)
        attn_mask = mask[:, None, None, :] if mask is not None else None
        for i in range(self.num_layers):
            att = getattr(self, f'cross_{i}')(q, kv, mask=attn_mask)
            q = getattr(self, f'ln1_{i}')(q + att)
            ff = getattr(self, f'ff_{i}')(F.gelu(
                getattr(self, f'ffh_{i}')(q), approximate='tanh'))
            q = getattr(self, f'ln2_{i}')(q + ff)
        return q[0] if squeeze else q
