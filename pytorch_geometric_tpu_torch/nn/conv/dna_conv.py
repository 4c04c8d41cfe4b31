"""DNAConv and PANConv.

Counterpart of ``pytorch_geometric_tpu/nn/conv/dna_conv.py`` (reference
``torch_geometric/nn/conv/dna_conv.py``: just-jump attention over the
stack of a node's earlier representations; ``pan_conv.py``: the path
integral, a MET matrix summing weighted adjacency powers). Plain PyTorch,
as the JAX package leaves both to XLA; PANConv's matrix is dense ``[N,
N]``, as there.
"""

from typing import Optional

import torch
from torch import nn

from ..inits import constant, glorot, linear
from ..message_passing import MessagePassing
from ...backend import resolve_device
from ...ops import scatter
from .gcn_conv import gcn_norm
from .graph_conv import _coo


def restricted_softmax(src: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax with a phantom 0 logit (reference ``dna_conv.py:62``)."""
    src_max = src.amax(dim, keepdim=True).clamp(min=0.0)
    out = torch.exp(src - src_max)
    return out / (out.sum(dim, keepdim=True) + torch.exp(-src_max))


class _GroupedDense(nn.Module):
    """Block-diagonal Linear (reference ``dna_conv.py:15``): ``weight
    [groups, in / groups, out / groups]``, one block a group, then
    ``bias``."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 1,
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.groups, self.out_channels = groups, out_channels
        self.weight = glorot((groups, in_channels // groups,
                              out_channels // groups), device, generator)
        self.bias = (constant((out_channels,), 0.0, device) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        xg = x.reshape(lead + (self.groups, -1))
        out = torch.einsum('...gi,gio->...go', xg, self.weight)
        out = out.reshape(lead + (self.out_channels,))
        return out if self.bias is None else out + self.bias


class DNAConv(MessagePassing):
    """Dynamic neighbourhood aggregation (reference ``dna_conv.py:170``):
    ``x`` is ``[N, L, channels]``, a node's ``L`` earlier representations;
    ``heads``-head attention of each destination's latest one against each
    neighbour's whole stack (``restricted_softmax`` over ``L``), the
    messages weighted by the GCN normalisation (self loops added when
    ``add_self_loops``) and summed. ``multi_head_lin_q`` / ``_k`` / ``_v``
    are block-diagonal over ``groups``."""

    def __init__(self, channels: int, heads: int = 1, groups: int = 1,
                 normalize: bool = True, add_self_loops: bool = True,
                 use_bias: bool = True, aggr: str = 'add', device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.channels, self.heads, self.groups = channels, heads, groups
        self.normalize, self.add_self_loops = normalize, add_self_loops
        self.aggr = aggr
        kw = dict(device=device, generator=generator)
        for part in 'qkv':
            setattr(self, f'multi_head_lin_{part}', _GroupedDense(
                channels, channels, groups, use_bias, **kw))

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, L, _ = x.shape
        H, C = self.heads, self.channels
        D = C // H
        coo = _coo(edge_index)
        if self.normalize:
            coo, edge_weight = gcn_norm(coo, edge_weight, n,
                                        add_self_loops=self.add_self_loops,
                                        dtype=x.dtype)
            if edge_mask is not None and self.add_self_loops:
                edge_mask = torch.cat([edge_mask, edge_mask.new_ones(n)])
        src = coo[0].long().clamp(max=n - 1)
        dst = coo[1].long().clamp(max=n - 1)
        q = self.multi_head_lin_q(x[:, -1]).view(n, H, D)
        k = self.multi_head_lin_k(x).view(n, L, H, D)
        v = self.multi_head_lin_v(x).view(n, L, H, D)
        logits = torch.einsum('ehd,elhd->elh', q[dst], k[src]) / D ** 0.5
        alpha = restricted_softmax(logits, dim=1)
        msg = torch.einsum('elh,elhd->ehd', alpha, v[src]).reshape(-1, C)
        if edge_weight is not None:
            msg = msg * edge_weight[:, None]
        return scatter(msg, dst, n, self._aggr(), mask=edge_mask)


class PANConv(nn.Module):
    """Path-integral conv (reference ``pan_conv.py``): the MET matrix ``M =
    sum_k (prod_{i <= k} w_i) A^k`` with learned per-power weights (``w``
    from 0.5), normalised symmetrically by its rows' structural nonzero
    counts (JAX ``dna_conv.py:99-142``); returns ``(lin(M_norm x),
    M_norm)``. ``A[i, j]`` counts the edges ``j -> i``; ``M`` is dense
    ``[N, N]``, as in the JAX package (molecule-sized graphs)."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_size: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.filter_size = filter_size
        self.weight = constant((filter_size + 1,), 0.5, device)
        self.lin = linear(in_channels, out_channels, device=device,
                          generator=generator)

    def forward(self, x, edge_index,
                edge_mask: Optional[torch.Tensor] = None):
        n = x.shape[0]
        coo = _coo(edge_index)
        src = coo[0].long().clamp(max=n - 1)
        dst = coo[1].long().clamp(max=n - 1)
        val = x.new_ones(coo.shape[1])
        if edge_mask is not None:
            val = torch.where(edge_mask, val, 0)
        a = x.new_zeros((n, n)).index_put_((dst, src), val, accumulate=True)
        a_nz = (a > 0).to(x.dtype)
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        w = self.weight
        m = p = w[0] * eye
        m_nz = p_nz = eye > 0
        for k in range(1, self.filter_size + 1):
            p = (p @ a) * w[k]
            p_nz = (p_nz.to(x.dtype) @ a_nz) > 0
            m = m + p
            m_nz = m_nz | p_nz
        deg = m_nz.sum(1).to(x.dtype)
        dis = torch.where(deg > 0, deg.clamp(min=1e-12).rsqrt(), 0.0)
        mn = dis[:, None] * m * dis[None, :]
        return self.lin(mn @ x), mn
