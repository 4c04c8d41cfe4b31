"""Dense differentiable pooling: DiffPool, MinCut and DMoN.

Counterpart of ``pytorch_geometric_tpu/nn/dense/dense_pool.py`` (reference
``torch_geometric/nn/dense/diff_pool.py``, ``mincut_pool.py`` and
``dmon_pool.py``), over padded ``[B, N, F]`` / ``[B, N, N]`` tensors: a
handful of batched matrix products, plain PyTorch.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..inits import linear
from ...backend import resolve_device

EPS = 1e-15


def _fro(a):
    return torch.linalg.norm(a, dim=(-2, -1), keepdim=True)


def dense_diff_pool(x, adj, s, mask: Optional[torch.Tensor] = None,
                    normalize: bool = True):
    """``(x', adj', link_loss, ent_loss)`` (reference
    ``diff_pool.py:dense_diff_pool``): the link loss is one Frobenius norm
    over the whole ``[B, N, N]`` residual, divided by its number of
    entries when ``normalize``."""
    s = torch.softmax(s, -1)
    if mask is not None:
        s = s * mask[..., None]
    st = s.transpose(1, 2)
    out = st @ x
    out_adj = st @ adj @ s
    link_loss = torch.sqrt(((adj - s @ st) ** 2).sum().clamp(min=0))
    if normalize:
        link_loss = link_loss / adj.numel()
    ent = (-s * torch.log(s + EPS)).sum(-1)
    if mask is not None:
        ent = ent * mask
    return out, out_adj, link_loss, ent.mean()


def dense_mincut_pool(x, adj, s, mask: Optional[torch.Tensor] = None):
    """``(x', adj', mincut_loss, ortho_loss)`` (reference
    ``mincut_pool.py``); the pooled adjacency with a zero diagonal,
    degree-normalised."""
    s = torch.softmax(s, -1)
    if mask is not None:
        s = s * mask[..., None]
    k = s.shape[-1]
    st = s.transpose(1, 2)
    out = st @ x
    out_adj = st @ adj @ s
    num = torch.diagonal(out_adj, dim1=-2, dim2=-1).sum(-1)
    d = adj.sum(-1)
    den = torch.diagonal(st @ (d[..., None] * s), dim1=-2, dim2=-1).sum(-1)
    mincut_loss = (-(num / den.clamp(min=EPS))).mean()
    ss = st @ s
    ss_n = ss / _fro(ss).clamp(min=EPS)
    i_n = torch.eye(k, dtype=x.dtype, device=x.device) / torch.sqrt(
        torch.tensor(k, dtype=x.dtype))
    ortho_loss = torch.linalg.norm(ss_n - i_n, dim=(-2, -1)).mean()
    eye = torch.eye(k, dtype=x.dtype, device=x.device)
    out_adj = out_adj * (1 - eye)
    dis = torch.rsqrt(out_adj.sum(-1).clamp(min=EPS))
    out_adj = dis[..., None] * out_adj * dis[..., None, :]
    return out, out_adj, mincut_loss, ortho_loss


def dense_dmon_pool(x, adj, s, mask: Optional[torch.Tensor] = None):
    """``(x', adj', spectral_loss, ortho_loss, cluster_loss)`` (reference
    ``dmon_pool.py``, Tsitsulin et al.); ``s`` are cluster probabilities.
    As the reference: masked x and s, selu on the pooled rows, the
    modularity over masked degrees, the cluster loss normalised by the
    valid node count (its ``[B] / [B, 1]`` broadcast to ``[B, B]`` kept),
    the pooled adjacency with a zero diagonal, degree-normalised."""
    B, N, k = s.shape
    m1 = (x.new_ones((B, N, 1)) if mask is None
          else mask[..., None].to(x.dtype))
    x = x * m1
    s = s * m1
    st = s.transpose(1, 2)
    out = F.selu(st @ x)
    out_adj = st @ adj @ s
    degrees = adj.sum(-1)[..., None] * m1
    m = degrees.sum((1, 2)) / 2
    ca = st @ degrees
    cb = degrees.transpose(1, 2) @ s
    normalizer = (ca @ cb) / 2 / m[:, None, None]
    decompose = out_adj - normalizer
    spectral_loss = (-torch.diagonal(decompose, dim1=-2, dim2=-1).sum(-1)
                     / 2 / m).mean()
    ss = st @ s
    i_norm = torch.sqrt(torch.tensor(k, dtype=x.dtype))
    ss_n = ss / _fro(ss)
    i_n = torch.eye(k, dtype=x.dtype, device=x.device) / i_norm
    ortho_loss = torch.linalg.norm(ss_n - i_n, dim=(-2, -1)).mean()
    cluster_size = s.sum(1)
    cl = (torch.linalg.norm(cluster_size, dim=-1)[None, :]
          / m1.sum((1, 2))[:, None])
    cluster_loss = (cl * i_norm - 1).mean()
    out_adj = out_adj * (1 - torch.eye(k, dtype=x.dtype, device=x.device))
    d = torch.sqrt(out_adj.sum(-1))[:, None] + EPS
    out_adj = out_adj / d / d.transpose(1, 2)
    return out, out_adj, spectral_loss, ortho_loss, cluster_loss


class DMoNPooling(nn.Module):
    """Learnable DMoN pooling (reference ``dmon_pool.py:DMoNPooling``):
    ``mlp`` to ``k`` cluster logits (dropout unless ``deterministic``),
    softmax, :func:`dense_dmon_pool`. Returns ``(s, x', adj',
    spectral_loss, ortho_loss, cluster_loss)``."""

    def __init__(self, in_channels: int, k: int, dropout: float = 0.0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.dropout = k, dropout
        self.mlp = linear(in_channels, k, device=resolve_device(device),
                          generator=generator)

    def forward(self, x, adj, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True):
        s = self.mlp(x)
        if self.dropout > 0 and not deterministic:
            s = F.dropout(s, self.dropout, training=True)
        s = torch.softmax(s, -1)
        out, out_adj, sp, on, cl = dense_dmon_pool(x, adj, s, mask)
        s_out = s if mask is None else s * mask[..., None]
        return s_out, out, out_adj, sp, on, cl
