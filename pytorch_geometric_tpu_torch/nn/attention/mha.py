"""flax's ``MultiHeadDotProductAttention``, as the JAX package's
``GPSConv`` and ``QFormer`` call it.

The JAX package computes it in XLA (no Pallas kernel), so the port's is
plain PyTorch on either device. flax's arithmetic is kept: the query, key
and value projections are ``DenseGeneral`` layers to ``[H, D]`` (here
``Linear`` layers to ``H * D``, their kernels reshaped by
``convert.flax_to_state_dict``), the query is divided by ``sqrt(D)``
before the product, and a masked logit is set to the dtype's most negative
finite value, so a row with no valid key gets a uniform softmax rather than
NaN. ``torch.nn.functional.scaled_dot_product_attention`` is not used: with
a boolean mask it fills with minus infinity and gives NaN for such a row.
"""

import math
from typing import Optional

import torch
from torch import nn

from ..inits import linear
from ...backend import resolve_device


class MultiHeadDotProductAttention(nn.Module):
    """``out(softmax(q k^T / sqrt(D), masked) v)`` over ``[B, L, F]``
    sequences; ``mask`` broadcasts to ``[B, H, Lq, Lk]`` (True keeps).
    Widths as flax's defaults: ``qkv_features`` and ``out_features`` are
    the query's width unless given, ``D = qkv_features // num_heads``."""

    def __init__(self, in_features: int, num_heads: int,
                 kv_features: Optional[int] = None,
                 qkv_features: Optional[int] = None,
                 out_features: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        qkv = qkv_features or in_features
        if qkv % num_heads:
            raise ValueError(f'qkv_features {qkv} is not a multiple of '
                             f'num_heads {num_heads}')
        self.num_heads = num_heads
        kw = dict(device=device, generator=generator)
        self.query = linear(in_features, qkv, **kw)
        self.key = linear(kv_features or in_features, qkv, **kw)
        self.value = linear(kv_features or in_features, qkv, **kw)
        self.out = linear(qkv, out_features or in_features, **kw)

    def forward(self, inputs_q: torch.Tensor,
                inputs_kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if inputs_kv is None:
            inputs_kv = inputs_q
        b, lq = inputs_q.shape[:2]
        lk = inputs_kv.shape[1]
        h = self.num_heads
        q = self.query(inputs_q).view(b, lq, h, -1)
        k = self.key(inputs_kv).view(b, lk, h, -1)
        v = self.value(inputs_kv).view(b, lk, h, -1)
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum('bqhd,bkhd->bhqk', q, k)
        if mask is not None:
            logits = torch.where(mask, logits,
                                 torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, -1)
        out = torch.einsum('bhqk,bkhd->bqhd', weights, v)
        return self.out(out.reshape(b, lq, -1))
