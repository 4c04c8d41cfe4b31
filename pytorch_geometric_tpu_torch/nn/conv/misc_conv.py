"""SignedConv, DirGNNConv, AntiSymmetricConv, HypergraphConv, WLConv,
MeshCNNConv, SimpleConv, GCN2Conv and PointGNNConv.

Counterpart of ``pytorch_geometric_tpu/nn/conv/misc_conv.py`` (reference
``torch_geometric/nn/conv/signed_conv.py``, ``dir_gnn_conv.py``,
``antisymmetric_conv.py``, ``hypergraph_conv.py``, ``wl_conv.py``,
``meshcnn_conv.py``, ``simple_conv.py``, ``gcn2_conv.py``,
``point_gnn_conv.py``). Every aggregation is a gather and a scatter (plain
PyTorch, as the JAX package leaves them to XLA); ``WLConv`` hashes colours
on the host. Submodules and parameters are named as the flax modules name
theirs (``lin_pos``, ``conv_in``, ``W``, ``phi``, ``w0`` ... ``w4``,
``weight1``, ``mlp_h1`` ...), so ``convert.flax_to_state_dict`` carries
them across.
"""

import copy
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..inits import constant, glorot, linear
from ..message_passing import MessagePassing
from ...backend import resolve_device
from ...ops import scatter
from ...utils.loop import add_self_loops as _add_self_loops
from .gcn_conv import GCNConv, gcn_norm
from .graph_conv import _coo


class SignedConv(MessagePassing):
    """Signed GCN conv over positive and negative edge sets (reference
    ``signed_conv.py``), mean aggregation. The first layer (``first_aggr``)
    maps ``x`` ``[N, in_channels]`` to ``[lin_pos([pos | x]) | lin_neg([neg
    | x])]``; a deeper layer takes ``x = [x_pos | x_neg]``, ``in_channels``
    wide each, and concatenates ``[pos(x_pos), neg(x_neg), x_pos]`` for
    ``lin_pos`` and ``[pos(x_neg), neg(x_pos), x_neg]`` for ``lin_neg`` (in
    that order, JAX ``misc_conv.py:48-51``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 first_aggr: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.first_aggr = first_aggr
        self.aggr = 'mean'
        width = (2 if first_aggr else 3) * in_channels
        self.lin_pos = linear(width, out_channels, device=device,
                              generator=generator)
        self.lin_neg = linear(width, out_channels, device=device,
                              generator=generator)

    def forward(self, x, pos_edge_index, neg_edge_index,
                pos_mask: Optional[torch.Tensor] = None,
                neg_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]

        def prop(edges, mask, v):
            return self.propagate(edges, x=v, size=(n, n), edge_mask=mask)

        if self.first_aggr:
            pos = prop(pos_edge_index, pos_mask, x)
            neg = prop(neg_edge_index, neg_mask, x)
            return torch.cat([self.lin_pos(torch.cat([pos, x], -1)),
                              self.lin_neg(torch.cat([neg, x], -1))], -1)
        f = x.shape[-1] // 2
        x_pos, x_neg = x[:, :f], x[:, f:]
        out_pos = self.lin_pos(torch.cat(
            [prop(pos_edge_index, pos_mask, x_pos),
             prop(neg_edge_index, neg_mask, x_neg), x_pos], -1))
        out_neg = self.lin_neg(torch.cat(
            [prop(pos_edge_index, pos_mask, x_neg),
             prop(neg_edge_index, neg_mask, x_pos), x_neg], -1))
        return torch.cat([out_pos, out_neg], -1)


# the submodules a conv holds only for its root weight
_ROOT_PARTS = ('lin_skip', 'lin_beta', 'lin_r', 'root')


def _directional(conv: nn.Module) -> nn.Module:
    """A copy of ``conv`` without self loops and without its own root
    weight (reference ``dir_gnn_conv.py:15-20``)."""
    conv = copy.deepcopy(conv)
    if hasattr(conv, 'add_self_loops'):
        conv.add_self_loops = False
    if hasattr(conv, 'root_weight'):
        conv.root_weight = False
        for name in _ROOT_PARTS:
            if isinstance(getattr(conv, name, None), nn.Module):
                setattr(conv, name, None)
    return conv


class DirGNNConv(nn.Module):
    """Directional wrapper (reference ``dir_gnn_conv.py``): ``alpha *
    conv_out(x, reversed edges) + (1 - alpha) * conv_in(x, edges)``, plus
    ``lin(x)`` when ``root_weight``. ``conv_in`` and ``conv_out`` are two
    copies of ``conv`` without self loops and without root weight; alpha
    weights the **reversed** pass (JAX ``misc_conv.py:62-96``). ``conv``
    names its widths in ``in_channels`` / ``out_channels``."""

    def __init__(self, conv: nn.Module, alpha: float = 0.5,
                 root_weight: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.alpha = alpha
        self.root_weight = root_weight
        self.conv_in = _directional(conv)
        self.conv_out = _directional(conv)
        self.lin = (linear(conv.in_channels, conv.out_channels,
                           device=resolve_device(device),
                           generator=generator) if root_weight else None)

    def forward(self, x, edge_index, **kwargs) -> torch.Tensor:
        coo = _coo(edge_index)
        out_in = self.conv_in(x, coo, **kwargs)
        out_out = self.conv_out(x, coo.flip(0), **kwargs)
        out = self.alpha * out_out + (1 - self.alpha) * out_in
        if self.lin is not None:
            out = out + self.lin(x)
        return out


class AntiSymmetricConv(nn.Module):
    """Anti-symmetric ODE conv (reference ``antisymmetric_conv.py``):
    ``num_iters`` times ``x <- x + epsilon * act(x (W - W^T - gamma I)^T +
    phi(x, A) + b)``. The default ``phi`` is a bias-free ``GCNConv(in,
    in)`` (JAX ``misc_conv.py:114-117``), which takes an ``EdgeIndex`` as
    its own forward does."""

    def __init__(self, in_channels: int, phi: Optional[nn.Module] = None,
                 num_iters: int = 1, epsilon: float = 0.1,
                 gamma: float = 0.1, act: str = 'tanh', device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels = in_channels
        self.num_iters, self.epsilon, self.gamma = num_iters, epsilon, gamma
        self.act = getattr(torch, act)
        self.W = glorot((in_channels, in_channels), device, generator)
        self.bias = constant((in_channels,), 0.0, device)
        self.phi = (GCNConv(in_channels, in_channels, use_bias=False,
                            device=device, generator=generator)
                    if phi is None else phi)

    def forward(self, x, edge_index, **kwargs) -> torch.Tensor:
        f = x.shape[-1]
        a = (self.W - self.W.T
             - self.gamma * torch.eye(f, dtype=x.dtype, device=x.device))
        for _ in range(self.num_iters):
            h = self.phi(x, edge_index, **kwargs)
            x = x + self.epsilon * self.act(x @ a.T + h + self.bias)
        return x


class HypergraphConv(nn.Module):
    """Hypergraph conv (reference ``hypergraph_conv.py``): ``X' = D^-1 H
    B^-1 H^T X Theta + b`` over incidence pairs ``hyperedge_index`` ``[2,
    nnz]`` (node, hyperedge); ``D`` sums each node's hyperedge weights,
    ``B`` counts each hyperedge's nodes. The weights enter only through
    ``D``, as in the reference's message (JAX ``misc_conv.py:166-169``).
    As in the JAX package, ``use_attention`` and ``heads`` are kept for the
    signature and the attention arm is not implemented; an incidence at a
    padding sentinel is clamped to the last node or hyperedge unless
    ``mask`` drops it."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_attention: bool = False, heads: int = 1,
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.use_attention, self.heads = use_attention, heads
        self.lin = linear(in_channels, out_channels, bias=False,
                          device=device, generator=generator)
        self.bias = (constant((out_channels,), 0.0, device) if use_bias
                     else None)

    def forward(self, x, hyperedge_index,
                hyperedge_weight: Optional[torch.Tensor] = None,
                num_edges: Optional[int] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo = _coo(hyperedge_index)
        m = num_edges if num_edges is not None else n
        node = coo[0].long().clamp(max=n - 1)
        edge = coo[1].long().clamp(max=m - 1)
        x = self.lin(x)
        w = (x.new_ones(m) if hyperedge_weight is None
             else hyperedge_weight)
        deg = scatter(w[edge], node, n, 'sum', mask=mask)
        edeg = scatter(x.new_ones(edge.shape[0]), edge, m, 'sum', mask=mask)
        dinv = torch.where(deg > 0, 1.0 / deg.clamp(min=1e-12), 0.0)
        binv = torch.where(edeg > 0, 1.0 / edeg.clamp(min=1e-12), 0.0)
        he = scatter(x[node] * binv[edge][:, None], edge, m, 'sum',
                     mask=mask)
        out = scatter(he[edge] * dinv[node][:, None], node, n, 'sum',
                      mask=mask)
        if self.bias is not None:
            out = out + self.bias
        return out


class WLConv(nn.Module):
    """Weisfeiler-Lehman colour refinement (reference ``wl_conv.py``), on
    the host: a node's new colour is the index of ``(its colour, the sorted
    colours of its in-neighbours)`` in a map kept across calls, as the
    reference module keeps it. ``x`` is ``[N]`` colours or one-hot ``[N,
    C]``; returns ``[N]`` int64 on ``x``'s device. An edge with an endpoint
    at or past ``N`` is dropped."""

    def __init__(self):
        super().__init__()
        self.hashmap = {}

    def forward(self, x, edge_index) -> torch.Tensor:
        device = x.device if isinstance(x, torch.Tensor) else None
        coo = _coo(edge_index)
        coo = (coo.cpu().numpy() if isinstance(coo, torch.Tensor)
               else np.asarray(coo))
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if x.ndim > 1:
            x = x.argmax(-1)
        n = x.shape[0]
        adj = [[] for _ in range(n)]
        for s, d in zip(coo[0], coo[1]):
            if d < n and s < n:
                adj[int(d)].append(int(x[s]))
        out = np.empty(n, np.int64)
        for v in range(n):
            key = (int(x[v]), tuple(sorted(adj[v])))
            if key not in self.hashmap:
                self.hashmap[key] = len(self.hashmap)
            out[v] = self.hashmap[key]
        return torch.from_numpy(out).to(device)

    def histogram(self, x, batch=None, norm: bool = False) -> torch.Tensor:
        """Per-graph colour counts ``[B, colours seen so far]`` float32,
        rows scaled to unit length when ``norm``."""
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if batch is None:
            batch = np.zeros(len(x), np.int64)
        elif isinstance(batch, torch.Tensor):
            batch = batch.cpu().numpy()
        hist = np.zeros((int(batch.max()) + 1, len(self.hashmap)),
                        np.float32)
        np.add.at(hist, (batch.astype(np.int64), x.astype(np.int64)), 1)
        if norm:
            hist /= np.maximum(np.linalg.norm(hist, axis=-1, keepdims=True),
                               1e-12)
        return torch.from_numpy(hist)


class MeshCNNConv(nn.Module):
    """MeshCNN edge conv (reference ``meshcnn_conv.py:13``): ``x'_i = W0
    x_i + W1 |a - c| + W2 (a + c) + W3 |b - d| + W4 (b + d)`` over each mesh
    edge's four ring neighbours, given as ``ring [E, 4]`` (a, b, c, d) or
    the reference's ``[2, 4E]`` adjacency in that column order. ``w0`` has
    the bias."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.out_channels = in_channels, out_channels
        for k in range(5):
            setattr(self, f'w{k}', linear(in_channels, out_channels,
                                          bias=use_bias and k == 0,
                                          device=device, generator=generator))

    def forward(self, x, ring) -> torch.Tensor:
        e = x.shape[0]
        if ring.dim() == 2 and ring.shape[0] == 2:
            ring = ring[1].reshape(e, 4)
        safe = ring.long().clamp(max=e - 1)
        a, b, c, d = (x[safe[:, k]] for k in range(4))
        return (self.w0(x) + self.w1((a - c).abs()) + self.w2(a + c)
                + self.w3((b - d).abs()) + self.w4(b + d))


class SimpleConv(MessagePassing):
    """Non-trainable propagation (reference ``simple_conv.py:19``): ``out_i
    = aggr_j w_ji x_j``, the root added (``combine_root='sum'``),
    concatenated in front (``'cat'``) or taken in as one self loop a node
    (``'self_loop'``)."""

    def __init__(self, aggr: str = 'sum',
                 combine_root: Optional[str] = None):
        super().__init__()
        self.aggr = aggr
        self.combine_root = combine_root

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        n = x_dst.shape[0]
        coo = _coo(edge_index)
        if self.combine_root == 'self_loop':
            coo, edge_weight = _add_self_loops(coo, edge_weight, num_nodes=n)
            if edge_mask is not None:
                edge_mask = torch.cat([edge_mask, edge_mask.new_ones(n)])
        src = coo[0].long().clamp(max=x_src.shape[0] - 1)
        msg = x_src[src]
        if edge_weight is not None:
            msg = msg * edge_weight[:, None]
        valid = coo[1] < n
        if edge_mask is not None:
            valid = valid & edge_mask
        out = scatter(msg, coo[1].long().clamp(max=n - 1), n, self._aggr(),
                      mask=valid)
        if self.combine_root == 'sum':
            out = out + x_dst
        elif self.combine_root == 'cat':
            out = torch.cat([x_dst, out], -1)
        return out


class GCN2Conv(nn.Module):
    """GCNII (reference ``gcn2_conv.py:15``): ``out = ((1 - alpha) P x +
    alpha x_0) ((1 - beta) I + beta W)``, ``P`` the GCN normalisation (self
    loops added when ``add_self_loops``) and ``beta = log(theta / layer +
    1)`` when ``theta`` or ``layer`` is given (JAX ``misc_conv.py:299-302``),
    else 1. Without ``shared_weights`` the two terms take ``weight1`` and
    ``weight2`` apart. The weights multiply on the right, ``[C, C]``."""

    def __init__(self, channels: int, alpha: float = 0.1,
                 theta: Optional[float] = None, layer: Optional[int] = None,
                 shared_weights: bool = True, normalize: bool = True,
                 add_self_loops: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.channels = channels
        self.alpha = alpha
        self.beta = (math.log(theta / layer + 1)
                     if theta is not None or layer is not None else 1.0)
        self.normalize, self.add_self_loops = normalize, add_self_loops
        self.weight1 = glorot((channels, channels), device, generator)
        self.weight2 = (None if shared_weights
                        else glorot((channels, channels), device, generator))

    def forward(self, x, x_0, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo = _coo(edge_index)
        if self.normalize:
            coo, edge_weight = gcn_norm(coo, edge_weight, n,
                                        add_self_loops=self.add_self_loops,
                                        dtype=x.dtype)
            if edge_mask is not None and self.add_self_loops:
                # the N appended loops are valid (the JAX package leaves
                # the mask E long here and cannot run: ROADMAP Queue 3)
                edge_mask = torch.cat([edge_mask, edge_mask.new_ones(n)])
        w = x.new_ones(coo.shape[1]) if edge_weight is None else edge_weight
        valid = coo[1] < n
        if edge_mask is not None:
            valid = valid & edge_mask
        msg = x[coo[0].long().clamp(max=n - 1)] * torch.where(valid, w,
                                                              0)[:, None]
        h = (1 - self.alpha) * scatter(msg, coo[1], n, 'sum', mask=valid)
        x0 = self.alpha * x_0[:n]
        beta = self.beta
        if self.weight2 is None:
            out = h + x0
            return (1 - beta) * out + beta * (out @ self.weight1)
        return ((1 - beta) * h + beta * (h @ self.weight1)
                + (1 - beta) * x0 + beta * (x0 @ self.weight2))


class PointGNNConv(nn.Module):
    """Point-GNN (reference ``point_gnn_conv.py``): offsets ``delta =
    mlp_h(x)`` predicted at the destination sharpen the relative positions,
    ``msg = mlp_f([pos_j - pos_i + delta_i, x_j])``, the messages' max
    (an empty or all-masked node gets 0), ``x + mlp_g(max)``; each ``mlp``
    two Linears with a ReLU between."""

    def __init__(self, channels: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.channels = channels
        kw = dict(device=device, generator=generator)
        self.mlp_h1 = linear(channels, channels, **kw)
        self.mlp_h2 = linear(channels, 3, **kw)
        self.mlp_f1 = linear(3 + channels, channels, **kw)
        self.mlp_f2 = linear(channels, channels, **kw)
        self.mlp_g1 = linear(channels, channels, **kw)
        self.mlp_g2 = linear(channels, channels, **kw)

    def forward(self, x, pos, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo = _coo(edge_index)
        src = coo[0].long().clamp(max=n - 1)
        dst = coo[1].long().clamp(max=n - 1)
        delta = self.mlp_h2(torch.relu(self.mlp_h1(x)))
        e = torch.cat([pos[src] - pos[dst] + delta[dst], x[src]], -1)
        msg = self.mlp_f2(torch.relu(self.mlp_f1(e)))
        valid = coo[1] < n
        if edge_mask is not None:
            valid = valid & edge_mask
        agg = scatter(msg, dst, n, 'max', mask=valid)
        return x + self.mlp_g2(torch.relu(self.mlp_g1(agg)))
