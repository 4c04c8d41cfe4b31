"""PolynormerAttention: polynomial-expressive linear attention.

Counterpart of ``pytorch_geometric_tpu/nn/attention/polynormer.py``
(reference ``torch_geometric/nn/attention/polynormer.py:8``): sigmoid
``q`` / ``k`` (``q = k`` with ``qk_shared``), the heads viewed D-major as
``[B, N, D, H]`` (the reference's view of ``[B, N, H * D]``), then
``relu(lin_out(LayerNorm(attn) * (h + beta)))``. No dropout (the JAX
package runs the reference's eval semantics).
"""

from typing import Optional

import torch
from torch import nn

from ..inits import linear
from ...backend import resolve_device


class PolynormerAttention(nn.Module):
    """``D = head_channels`` or ``channels // heads``; ``h_lins`` (with
    bias), ``k``, ``q`` (unless ``qk_shared``), ``v`` (bias with
    ``qkv_bias``), ``lns`` (flax ``LayerNorm``, eps 1e-5) and ``lin_out``;
    input width ``in_channels`` or ``channels``; ``mask [B, N]`` zeroes the
    padded values."""

    def __init__(self, channels: int, heads: int = 1,
                 head_channels: Optional[int] = None, beta: float = 0.9,
                 qkv_bias: bool = False, qk_shared: bool = True,
                 in_channels: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.heads, self.beta, self.qk_shared = heads, beta, qk_shared
        d = head_channels or channels // heads
        f = in_channels or channels
        kw = dict(device=device, generator=generator)
        self.h_lins = linear(f, heads * d, **kw)
        self.k = linear(f, heads * d, bias=qkv_bias, **kw)
        self.q = (None if qk_shared
                  else linear(f, heads * d, bias=qkv_bias, **kw))
        self.v = linear(f, heads * d, bias=qkv_bias, **kw)
        self.lns = nn.LayerNorm(heads * d, eps=1e-5, device=device)
        self.lin_out = linear(heads * d, heads * d, **kw)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
            mask = mask[None] if mask is not None else None
        b, n, _ = x.shape
        h = self.h_lins(x)
        k = torch.sigmoid(self.k(x)).view(b, n, -1, self.heads)
        q = k if self.q is None else torch.sigmoid(self.q(x)).view(
            b, n, -1, self.heads)
        v = self.v(x).view(b, n, -1, self.heads)
        if mask is not None:
            v = v * mask[:, :, None, None]
        kv = torch.einsum('bndh,bnmh->bdmh', k, v)
        num = torch.einsum('bndh,bdmh->bnmh', q, kv)
        den = torch.einsum('bndh,bdh->bnh', q, k.sum(1))[:, :, None, :]
        out = (num / (den + 1e-6)).reshape(b, n, -1)
        out = self.lns(out) * (h + self.beta)
        out = torch.relu(self.lin_out(out))
        return out[0] if squeeze else out
