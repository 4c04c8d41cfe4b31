"""AttentiveFP, SignedGCN, RECT_L, GroupAddRev.

Counterpart of ``pytorch_geometric_tpu/nn/models/molecular.py`` (reference
``torch_geometric/nn/models/attentive_fp.py``, ``signed_gcn.py``,
``rect.py``, ``rev_gnn.py:196``). The convolutions are the port's own:
AttentiveFP's atom ``GATConv`` takes its fused branch (the mix kernel on
the card) over an ``EdgeIndex`` that carries the slot orders, as the JAX
package's takes its Pallas one, and the plain branch over a raw COO;
``RECT_L``'s ``GCNConv`` normalises on every call (``normalize=True``, as
the JAX package fixes it), so it propagates over the raw COO that
``gcn_norm`` returns. GRU cells are ``torch.nn.GRUCell``
(``inits.gru_cell``), with the state as the carry, as flax's ``GRUCell``
runs them. Submodules are named as the flax modules name theirs
(``gate_conv``, ``gru``, ``atom_convs_i``, ``atom_grus_i``, ``mol_conv``,
``mol_gru``; ``conv0`` and ``conv_i`` -> ``convs.i``; ``conv_g`` ->
``convs.g``), so ``convert.flax_to_state_dict`` carries the weights.
"""

import copy
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..conv import GATConv, GCNConv, SignedConv
from ..inits import glorot, gru_cell, linear
from ..pool import global_add_pool
from ...backend import resolve_device
from ...data.data import host
from ...edge_index import EdgeIndex
from ...ops import scatter, softmax


class GATEConv(nn.Module):
    """The edge-conditioned attention layer of AttentiveFP (reference
    ``attentive_fp.py:GATEConv``): each source's ``x_j' = leaky_relu(lin1(
    [x_j | edge_attr]))`` meets ``att_l``, the destination's raw ``x_i``
    meets ``att_r``; the softmax over each destination weighs
    ``lin2(x_j)``."""

    def __init__(self, in_channels: int, out_channels: int, edge_dim: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.att_l = glorot((1, out_channels), **kw)
        self.att_r = glorot((1, in_channels), **kw)
        self.lin1 = linear(in_channels + edge_dim, out_channels, bias=False,
                           **kw)
        self.lin2 = linear(in_channels, out_channels, bias=False, **kw)
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, x: torch.Tensor, edge_index, edge_attr: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        coo = edge_index.coo if isinstance(edge_index, EdgeIndex) \
            else edge_index
        src = coo[0].long().clamp(max=n - 1)
        dst = coo[1].long().clamp(max=n - 1)
        xj = F.leaky_relu(self.lin1(torch.cat([x[src], edge_attr], -1)),
                          0.01)
        alpha = (xj * self.att_l).sum(-1) + (x[dst] * self.att_r).sum(-1)
        alpha = softmax(F.leaky_relu(alpha, 0.01), dst, n, mask=edge_mask)
        msg = self.lin2(x[src]) * alpha[:, None]
        return scatter(msg, dst, n, 'sum', mask=edge_mask) + self.bias


class AttentiveFP(nn.Module):
    """Attentive FP (reference ``attentive_fp.py``): a ``GATEConv`` and
    ``num_layers - 1`` ``GATConv`` atom layers, each followed by a GRU
    update, then ``num_timesteps`` rounds of a ``GATConv`` from the atoms
    to a virtual node a molecule (its state the summed atoms) with a GRU
    update, and ``lin2``. ``forward(x, edge_index, edge_attr, batch=None,
    batch_size=1, node_mask=None, edge_mask=None)``."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, edge_dim: int, num_layers: int = 2,
                 num_timesteps: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        h = hidden_channels
        self.num_layers, self.num_timesteps = num_layers, num_timesteps
        self.lin1 = linear(in_channels, h, **kw)
        self.gate_conv = GATEConv(h, h, edge_dim, **kw)
        self.gru = gru_cell(h, h, **kw)
        for layer in range(num_layers - 1):
            self.add_module(f'atom_convs_{layer}', GATConv(
                h, h, add_self_loops=False, negative_slope=0.01, **kw))
            self.add_module(f'atom_grus_{layer}', gru_cell(h, h, **kw))
        self.mol_conv = GATConv((h, h), h, add_self_loops=False,
                                negative_slope=0.01, **kw)
        self.mol_gru = gru_cell(h, h, **kw)
        self.lin2 = linear(h, out_channels, **kw)

    def forward(self, x: torch.Tensor, edge_index, edge_attr: torch.Tensor,
                batch: Optional[torch.Tensor] = None, batch_size: int = 1,
                node_mask: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        x = F.leaky_relu(self.lin1(x), 0.01)
        h = F.elu(self.gate_conv(x, edge_index, edge_attr,
                                 edge_mask=edge_mask))
        x = F.relu(self.gru(h, x))
        for layer in range(self.num_layers - 1):
            h = F.elu(getattr(self, f'atom_convs_{layer}')(
                x, edge_index, edge_mask=edge_mask))
            x = F.relu(getattr(self, f'atom_grus_{layer}')(h, x))

        # the molecule embedding: a bipartite GAT from the atoms to one
        # node a molecule
        if batch is None:
            batch = torch.zeros(n, dtype=torch.long, device=x.device)
        mol_edge = torch.stack([torch.arange(n, device=x.device),
                                batch.long()])
        out = F.relu(global_add_pool(x, batch, batch_size, mask=node_mask))
        for _ in range(self.num_timesteps):
            h = F.elu(self.mol_conv((x, out), mol_edge, edge_mask=node_mask))
            out = F.relu(self.mol_gru(h, out))
        return self.lin2(out)


class SignedGCN(nn.Module):
    """Signed graph embedding (reference ``signed_gcn.py``): a first
    ``SignedConv`` (``conv0``) and ``num_layers - 1`` deeper ones, ReLU
    after each. ``forward(x, pos_edge_index, neg_edge_index)``."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_layers: int = 2, lamb: float = 5.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.num_layers, self.lamb = num_layers, lamb
        self.conv0 = SignedConv(in_channels, hidden_channels,
                                first_aggr=True, **kw)
        self.convs = nn.ModuleDict({
            str(i): SignedConv(hidden_channels, hidden_channels,
                               first_aggr=False, **kw)
            for i in range(1, num_layers)})

    def forward(self, x, pos_edge_index, neg_edge_index) -> torch.Tensor:
        h = F.relu(self.conv0(x, pos_edge_index, neg_edge_index))
        for i in range(1, self.num_layers):
            h = F.relu(self.convs[str(i)](h, pos_edge_index, neg_edge_index))
        return h

    @staticmethod
    def discriminate(params, lin_apply, z, edge_index):
        """``lin_apply(params, [z_src | z_dst])`` of each edge."""
        return lin_apply(params, torch.cat([z[edge_index[0]],
                                            z[edge_index[1]]], -1))

    @staticmethod
    def pos_embedding_loss(z, pos_edge_index) -> torch.Tensor:
        return ((z[pos_edge_index[0]] - z[pos_edge_index[1]]) ** 2).sum(
            -1).mean()

    @staticmethod
    def neg_embedding_loss(z, neg_edge_index) -> torch.Tensor:
        d = ((z[neg_edge_index[0]] - z[neg_edge_index[1]]) ** 2).sum(-1)
        return torch.clamp(1 - d, min=0).mean()


class RECT_L(nn.Module):
    """RECT's supervised part (reference ``rect.py``): a normalising
    ``GCNConv`` and ``lin`` back to the input width, trained against the
    class-mean features of :meth:`get_semantic_labels`."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 dropout: float = 0.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.dropout = dropout
        self.conv = GCNConv(in_channels, hidden_channels, **kw)
        self.lin = linear(hidden_channels, in_channels, **kw)

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.lin(self.conv(x, edge_index, edge_weight=edge_weight))

    @staticmethod
    def get_semantic_labels(x, y, mask) -> np.ndarray:
        """Each masked row's class-mean features (host numpy)."""
        x, y, mask = host(x), host(y), host(mask)
        xm, ym = x[mask], y[mask]
        out = np.zeros_like(xm)
        for c in np.unique(ym):
            out[ym == c] = xm[ym == c].mean(0)
        return out


class GroupAddRev(nn.Module):
    """The grouped reversible residual block (reference
    ``rev_gnn.py:196``): the channels split into ``num_groups`` groups,
    group ``g`` updated by ``conv_g`` (a copy of ``conv``, its weights its
    own) of the previous group's output (the sum of the other groups' for
    the first). In training, each group's conv is recomputed in the
    backward pass (``torch.utils.checkpoint``) rather than kept, as the
    reference's reversible block trades memory for compute. ``conv`` takes
    ``(x, edge_index, **kwargs)``."""

    def __init__(self, conv: nn.Module, num_groups: int = 2):
        super().__init__()
        self.num_groups = num_groups
        self.convs = nn.ModuleList([conv] + [copy.deepcopy(conv)
                                             for _ in range(num_groups - 1)])

    def forward(self, x: torch.Tensor, edge_index, **kwargs) -> torch.Tensor:
        if x.shape[-1] % self.num_groups:
            raise ValueError(f'{x.shape[-1]} channels do not split into '
                             f'{self.num_groups} equal groups')
        xs = torch.chunk(x, self.num_groups, dim=-1)
        y_prev = sum(xs[1:]) if self.num_groups > 1 else xs[0]
        ys = []
        for g, conv in enumerate(self.convs):
            if torch.is_grad_enabled() and self.training:
                out = checkpoint(lambda v, c=conv: c(v, edge_index, **kwargs),
                                 y_prev, use_reentrant=False)
            else:
                out = conv(y_prev, edge_index, **kwargs)
            y_prev = xs[g] + out
            ys.append(y_prev)
        return torch.cat(ys, -1)
