"""Point-cloud and mesh convolutions.

Counterpart of ``pytorch_geometric_tpu/nn/conv/point_conv.py`` (reference
``nn/conv/point_conv.py`` (PointNetConv), ``edge_conv.py`` (EdgeConv,
DynamicEdgeConv), ``ppf_conv.py`` (PPFConv), ``point_transformer_conv.py``,
``gravnet_conv.py``). Dynamic graphs come from the fixed-``k``
``knn_graph`` / ``knn`` of ``nn/pool/point.py`` (static shapes, a validity
mask). Messages run on ``MessagePassing``'s gather path (``index_select``,
the message, ``index_add_`` / ``scatter_reduce_``), as the JAX package
computes them in XLA.

A submodule passed in (``nn``, ``local_nn``, ``global_nn``, ``pos_nn``,
``attn_nn``) keeps the flax attribute's name, so ``convert.py`` carries its
parameters. The JAX package calls a flax ``MLP`` there with its default
``deterministic=True`` (its batch norms read the running statistics even
in training); the port's follows the module's mode, as PyG's does
(ROADMAP Queue 3).
"""

from typing import Optional, Tuple, Union

import torch
from torch import nn as tnn

from ..inits import linear
from ..message_passing import MessagePassing, _pair
from ...backend import resolve_device
from ...ops import scatter, softmax
from .graph_conv import _coo


def _with_self_loops(edge_index, edge_mask, n: int):
    """remove_self_loops + add_self_loops with static shapes: existing loop
    edges are masked out and ``n`` fresh loops appended (reference
    ``point_conv.py:94-99`` and friends). Returns ``(coo, edge_mask)``."""
    coo = _coo(edge_index)
    loop_free = coo[0] != coo[1]
    edge_mask = loop_free if edge_mask is None else (edge_mask & loop_free)
    loops = torch.arange(n, dtype=coo.dtype, device=coo.device)
    coo = torch.cat([coo, torch.stack([loops, loops])], 1)
    edge_mask = torch.cat([edge_mask, edge_mask.new_ones(n)])
    return coo, edge_mask


class PointNetConv(MessagePassing):
    """``h = local_nn([x_j, pos_j - pos_i])``; ``out = global_nn(max_j h)``
    (reference ``point_conv.py``); self loops replaced by fresh ones
    (reference ``point_conv.py:66``)."""

    def __init__(self, local_nn: Optional[tnn.Module] = None,
                 global_nn: Optional[tnn.Module] = None,
                 add_self_loops: bool = True, aggr: str = 'max'):
        super().__init__()
        self.local_nn = local_nn
        self.global_nn = global_nn
        self.add_self_loops = add_self_loops
        self.aggr = aggr

    def forward(self, x, pos, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        pos_src, pos_dst = _pair(pos)
        if self.add_self_loops:
            n = min(pos_src.shape[0], pos_dst.shape[0])
            edge_index, edge_mask = _with_self_loops(edge_index, edge_mask, n)
        out = self.propagate(edge_index, x=x, pos=(pos_src, pos_dst),
                             size=(pos_src.shape[0], pos_dst.shape[0]),
                             edge_mask=edge_mask)
        if self.global_nn is not None:
            out = self.global_nn(out)
        return out

    def message(self, pos_j, pos_i, x_j):
        msg = torch.cat([x_j, pos_j - pos_i], -1)
        if self.local_nn is not None:
            msg = self.local_nn(msg)
        return msg


class EdgeConv(MessagePassing):
    """x'_i = aggr_j nn([x_i, x_j - x_i]), max by default (reference
    ``edge_conv.py``). The network is kept as ``mlp``, the name
    ``EdgeCNN``'s flax parameters carry (``mlp_i``)."""

    def __init__(self, nn: tnn.Module, aggr: str = 'max'):
        super().__init__()
        self.mlp = nn
        self.aggr = aggr

    def forward(self, x, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = _pair(x)
        return self.propagate(edge_index, x=(x_src, x_dst),
                              size=(x_src.shape[0], x_dst.shape[0]),
                              edge_mask=edge_mask)

    def message(self, x_i, x_j):
        return self.mlp(torch.cat([x_i, x_j - x_i], -1))


class DynamicEdgeConv(MessagePassing):
    """EdgeConv over a k-NN graph built every forward (reference
    ``edge_conv.py:DynamicEdgeConv``): the ``k`` nearest other points of
    ``x``'s source rows in their cloud (``batch``), as the JAX package's
    ``knn_graph(loop=False)``, its validity mask as the edge mask."""

    def __init__(self, nn: tnn.Module, k: int = 6, aggr: str = 'max'):
        super().__init__()
        self.nn = nn
        self.k = k
        self.aggr = aggr

    def forward(self, x, batch: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        from ..pool.point import knn_graph
        x_src, x_dst = _pair(x)
        coo, valid = knn_graph(x_src, self.k, batch=batch, mask=mask)
        return self.propagate(coo, x=(x_src, x_dst),
                              size=(x_src.shape[0], x_dst.shape[0]),
                              edge_mask=valid)

    def message(self, x_i, x_j):
        return self.nn(torch.cat([x_i, x_j - x_i], -1))


class PPFConv(MessagePassing):
    """Point-pair-feature conv (reference ``ppf_conv.py``): the rotation
    invariant ``[|d|, angle(n_i, d), angle(n_j, d), angle(n_i, n_j)]``
    after ``x_j``, through ``local_nn``; self loops replaced by fresh
    ones (reference ``ppf_conv.py:84``)."""

    def __init__(self, local_nn: Optional[tnn.Module] = None,
                 global_nn: Optional[tnn.Module] = None,
                 add_self_loops: bool = True, aggr: str = 'max'):
        super().__init__()
        self.local_nn = local_nn
        self.global_nn = global_nn
        self.add_self_loops = add_self_loops
        self.aggr = aggr

    def forward(self, x, pos, normal, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        pos_src, pos_dst = _pair(pos)
        nrm_src, nrm_dst = _pair(normal)
        if self.add_self_loops:
            n = min(pos_src.shape[0], pos_dst.shape[0])
            edge_index, edge_mask = _with_self_loops(edge_index, edge_mask, n)
        out = self.propagate(edge_index, x=x, pos=(pos_src, pos_dst),
                             normal=(nrm_src, nrm_dst),
                             size=(pos_src.shape[0], pos_dst.shape[0]),
                             edge_mask=edge_mask)
        if self.global_nn is not None:
            out = self.global_nn(out)
        return out

    @staticmethod
    def _angle(v1, v2):
        cross = torch.linalg.vector_norm(torch.linalg.cross(v1, v2), dim=-1)
        dot = (v1 * v2).sum(-1)
        return torch.atan2(cross, dot)

    def message(self, pos_i, pos_j, normal_i, normal_j, x_j):
        d = pos_j - pos_i
        dist = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        ppf = torch.cat([
            dist,
            self._angle(normal_i, d)[:, None],
            self._angle(normal_j, d)[:, None],
            self._angle(normal_i, normal_j)[:, None],
        ], -1)
        ppf = torch.cat([x_j, ppf], -1)
        if self.local_nn is not None:
            ppf = self.local_nn(ppf)
        return ppf


class PointTransformerConv(MessagePassing):
    """Point transformer attention (reference
    ``point_transformer_conv.py``): ``alpha = attn_nn(q_i - k_j + delta)``,
    ``delta = pos_nn(pos_i - pos_j)``, ``out = sum_j softmax_j(alpha) *
    (v_j + delta)``, the softmax per channel over each destination's
    incoming edges (``[E, C]``) under the edge mask. ``q`` (``lin_dst``),
    ``k`` (``lin_src``) and ``v`` (``lin``) are bias-free (reference
    ``:20-22``); without ``pos_nn`` a Linear ``pos_dim -> out_channels``
    with bias. Endpoints are clamped into range, as in the JAX package: an
    edge at the padding sentinel counts towards the last node unless the
    mask drops it."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, pos_nn: Optional[tnn.Module] = None,
                 attn_nn: Optional[tnn.Module] = None,
                 add_self_loops: bool = True, pos_dim: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst = _pair(in_channels)
        self.out_channels = out_channels
        self.add_self_loops = add_self_loops
        kw = dict(device=device, generator=generator)
        self.lin_dst = linear(in_dst, out_channels, bias=False, **kw)
        self.lin_src = linear(in_src, out_channels, bias=False, **kw)
        self.lin = linear(in_src, out_channels, bias=False, **kw)
        self.pos_nn = (pos_nn if pos_nn is not None
                       else linear(pos_dim, out_channels, **kw))
        self.attn_nn = attn_nn

    def forward(self, x, pos, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = _pair(x)
        pos_src, pos_dst = _pair(pos)
        n_src, n_dst = pos_src.shape[0], pos_dst.shape[0]
        q = self.lin_dst(x_dst)
        k = self.lin_src(x_src)
        v = self.lin(x_src)
        if self.add_self_loops:
            edge_index, edge_mask = _with_self_loops(
                edge_index, edge_mask, min(n_src, n_dst))
        coo = _coo(edge_index)
        src = coo[0].long().clamp(max=n_src - 1)
        dst = coo[1].long().clamp(max=n_dst - 1)
        delta = self.pos_nn(pos_dst[dst] - pos_src[src])
        alpha = q[dst] - k[src] + delta
        if self.attn_nn is not None:
            alpha = self.attn_nn(alpha)
        alpha = softmax(alpha, dst, n_dst, mask=edge_mask)
        if edge_mask is not None:
            alpha = torch.where(edge_mask[:, None], alpha, 0.0)
        msg = alpha * (v[src] + delta)
        return scatter(msg, dst, n_dst, 'sum', mask=edge_mask)


class GravNetConv(MessagePassing):
    """GravNet (reference ``gravnet_conv.py``): a learned coordinate space
    ``s = lin_s(x)``, the ``k`` nearest points there (self included:
    reference ``:96``'s raw knn) in the same cloud, messages ``lin_h(x)_j *
    exp(-10 |s_i - s_j|^2)`` reduced by mean and max under the knn's
    validity mask; ``lin_out1(x)`` (bias-free) ``+ lin_out2([mean,
    max])``. A node whose every slot is invalid (masked out) aggregates
    to 0, as the JAX package's scatter does for an empty segment."""

    def __init__(self, in_channels: int, out_channels: int,
                 space_dimensions: int = 4, propagate_dimensions: int = 16,
                 k: int = 4, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.k = k
        self.lin_s = linear(in_channels, space_dimensions, **kw)
        self.lin_h = linear(in_channels, propagate_dimensions, **kw)
        self.lin_out1 = linear(in_channels, out_channels, bias=False, **kw)
        self.lin_out2 = linear(2 * propagate_dimensions, out_channels, **kw)

    def forward(self, x, batch: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        from ..pool.point import knn
        n = x.shape[0]
        s = self.lin_s(x)
        h = self.lin_h(x)
        qk, valid = knn(s, s, self.k, batch_x=batch, batch_y=batch,
                        mask_x=mask, mask_y=mask)
        dst, src = qk[0], qk[1]
        d2 = ((s[src] - s[dst]) ** 2).sum(-1)
        msg = h[src] * torch.exp(-10.0 * d2)[:, None]
        mean = scatter(msg, dst, n, 'mean', mask=valid)
        mx = scatter(msg, dst, n, 'max', mask=valid)
        return self.lin_out1(x) + self.lin_out2(torch.cat([mean, mx], -1))
