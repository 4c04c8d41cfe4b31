"""PerformerAttention: FAVOR+ linear attention.

Counterpart of ``pytorch_geometric_tpu/nn/attention/performer.py``
(reference ``torch_geometric/nn/attention/performer.py``): positive random
features ``phi`` and ``phi(q) (phi(k)^T v)`` in O(N), two dense products
instead of an ``N x N`` score matrix. As in the JAX package the random
projection is drawn once and never redrawn (no ``redraw_interval``), and it
carries no gradient: it is a buffer here, carried across from the JAX
parameters by ``convert.flax_to_state_dict`` under its name,
``projection``.
"""

from typing import Optional

import torch
from torch import nn

from ..inits import linear
from ...backend import resolve_device


def _orthogonal_gaussian(rows: int, cols: int,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Block-orthogonal random projection ``[rows, cols]`` (reference
    ``orthogonal_matrix``): the Q factors of Gaussian ``cols x cols``
    blocks, each row scaled by the root of a chi-square draw of ``cols``
    degrees of freedom (the norm of a Gaussian row)."""
    blocks, remaining = [], rows
    while remaining > 0:
        q, _ = torch.linalg.qr(torch.randn((cols, cols),
                                           generator=generator))
        blocks.append(q.T[:min(remaining, cols)])
        remaining -= cols
    m = torch.cat(blocks, 0)
    norms = torch.randn((rows, cols), generator=generator).norm(dim=1)
    return m * norms[:, None]


def softmax_kernel(x: torch.Tensor, projection: torch.Tensor,
                   is_query: bool, eps: float = 1e-4) -> torch.Tensor:
    """FAVOR+ positive random features of ``x [..., D]`` over
    ``projection [M, D]``. The query's features subtract each row's max;
    the key's subtract one max over the whole tensor, padded rows
    included, as the JAX package does."""
    d = x.shape[-1]
    ratio = projection.shape[0] ** -0.5
    xp = (x / (d ** 0.25)) @ projection.T
    x2 = (x ** 2).sum(-1, keepdim=True) / (2 * (d ** 0.5))
    stab = xp.amax(-1, keepdim=True) if is_query else xp.max()
    return ratio * (torch.exp(xp - x2 - stab) + eps)


class PerformerAttention(nn.Module):
    """Multi-head FAVOR+ attention over a node sequence ``[N, F]`` or a
    batch of them ``[B, N, F]``; ``mask [B, N]`` (1 valid, 0 padded) drops
    padded keys and values. ``q``, ``k``, ``v`` and ``out`` are flax
    ``Dense`` layers, ``D = channels // heads``, ``M = num_features`` or
    ``max(2 * int(D / 2), 16)`` random features."""

    def __init__(self, channels: int, heads: int = 1,
                 num_features: Optional[int] = None,
                 in_channels: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.channels, self.heads = channels, heads
        d = channels // heads
        m = num_features or max(int(d * 0.5) * 2, 16)
        f = in_channels or channels
        kw = dict(device=device, generator=generator)
        self.q = linear(f, heads * d, **kw)
        self.k = linear(f, heads * d, **kw)
        self.v = linear(f, heads * d, **kw)
        self.register_buffer('projection', _orthogonal_gaussian(
            m, d, generator).to(device))
        self.out = linear(heads * d, channels, **kw)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        b, n, _ = x.shape
        h = self.heads
        q = self.q(x).view(b, n, h, -1)
        k = self.k(x).view(b, n, h, -1)
        v = self.v(x).view(b, n, h, -1)
        qp = softmax_kernel(q, self.projection, True)     # [B, N, H, M]
        kp = softmax_kernel(k, self.projection, False)
        if mask is not None:
            kp = kp * mask[..., None, None]
            v = v * mask[..., None, None]
        kv = torch.einsum('bnhm,bnhd->bhmd', kp, v)
        z = 1.0 / torch.clamp(torch.einsum('bnhm,bhm->bnh', qp, kp.sum(1)),
                              min=1e-6)
        out = torch.einsum('bnhm,bhmd,bnh->bnhd', qp, kv, z)
        out = self.out(out.reshape(b, n, -1))
        return out[0] if squeeze else out
