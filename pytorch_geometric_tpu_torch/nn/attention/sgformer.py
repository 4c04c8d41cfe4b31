"""SGFormerAttention: simple global linear attention.

Counterpart of ``pytorch_geometric_tpu/nn/attention/sgformer.py``
(reference ``torch_geometric/nn/attention/sgformer.py:7``): ``q`` and ``k``
L2-normalised per head after exact zeros are set to 1e-6 (which keeps
all-zero padded rows finite; padded key rows then still add ``1/sqrt(D)``
vectors to the denominator, as in the reference), the numerator plus ``N *
v`` and the denominator plus ``N``, and the heads averaged, so the output
has ``head_channels`` features. O(N D^2): no ``[N, N]`` array.
"""

from typing import Optional

import torch
from torch import nn

from ..inits import linear
from ...backend import resolve_device


class SGFormerAttention(nn.Module):
    """``D = head_channels`` or ``channels``; ``q``, ``k``, ``v`` flax
    ``Dense`` layers ``in_channels (= channels) -> H * D`` with bias when
    ``qkv_bias``; ``mask [B, N]`` zeroes the padded values."""

    def __init__(self, channels: int, heads: int = 1,
                 head_channels: Optional[int] = None,
                 qkv_bias: bool = False, in_channels: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.heads = heads
        d = head_channels or channels
        f = in_channels or channels
        kw = dict(bias=qkv_bias, device=device, generator=generator)
        self.q = linear(f, heads * d, **kw)
        self.k = linear(f, heads * d, **kw)
        self.v = linear(f, heads * d, **kw)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
            mask = mask[None] if mask is not None else None
        b, n, _ = x.shape
        h = self.heads
        q = self.q(x).view(b, n, h, -1)
        k = self.k(x).view(b, n, h, -1)
        v = self.v(x).view(b, n, h, -1)
        if mask is not None:
            v = v * mask[:, :, None, None]
        eps = 1e-6
        q = torch.where(q == 0, eps, q)
        k = torch.where(k == 0, eps, k)
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        k = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True)
        kv = torch.einsum('blhm,blhd->bhmd', k, v)
        num = torch.einsum('bnhm,bhmd->bnhd', q, kv) + n * v
        den = torch.einsum('bnhm,bhm->bnh', q, k.sum(1))[..., None] + n
        out = (num / den).mean(2)             # [B, N, D]
        return out[0] if squeeze else out
