"""SchNet, the continuous-filter convolution model of molecules.

Counterpart of ``pytorch_geometric_tpu/nn/models/schnet.py`` (reference
``torch_geometric/nn/models/schnet.py:35``). The interaction graph is the
fixed-k ``radius_graph`` of ``nn/pool/point.py`` (``max_num_neighbors``
slots a node, a validity mask), or what ``interaction_graph`` returns;
the distances, smeared over Gaussians, drive each interaction block's
filter network. Every reduction is a gather and an ``index_add_``, as the
JAX package leaves them to XLA: no port kernel runs. Submodules are named
as the flax modules name theirs (``embedding``, ``interaction_i`` with
``filter1``, ``filter2``, ``lin1``-``lin3``, ``lin1``, ``lin2``), so
``convert.flax_to_state_dict`` carries the weights across.
"""

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..inits import embedding, linear
from ..pool import global_add_pool, global_mean_pool
from ..pool.point import radius_graph
from ...backend import resolve_device
from ...edge_index import EdgeIndex
from ...ops import scatter


class GaussianSmearing(nn.Module):
    """``exp(coeff * (d - offset)^2)`` over ``num_gaussians`` offsets
    evenly spaced in ``[start, stop]`` (reference ``schnet.py``): the
    offsets are made in float64 on the host and cast to the distances'
    dtype, as the JAX package casts them."""

    def __init__(self, start: float = 0.0, stop: float = 5.0,
                 num_gaussians: int = 50):
        super().__init__()
        offset = np.linspace(start, stop, num_gaussians)
        self.coeff = -0.5 / float(offset[1] - offset[0]) ** 2
        self.register_buffer('offset', torch.from_numpy(offset),
                             persistent=False)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        d = dist[:, None] - self.offset.to(dist)[None]
        return torch.exp(self.coeff * d ** 2)


class ShiftedSoftplus(nn.Module):
    """``softplus(x) - log(2)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.softplus(x) - math.log(2.0)


# Standard atomic masses for Z in [0, 100) (the reference reads
# ``ase.data.atomic_masses``; the port's copy of the JAX package's table)
ATOMIC_MASSES = np.asarray([
    1.008, 1.008, 4.002602, 6.94, 9.0121831, 10.81, 12.011, 14.007,
    15.999, 18.998403163, 20.1797, 22.98976928, 24.305, 26.9815385,
    28.085, 30.973761998, 32.06, 35.45, 39.948, 39.0983, 40.078,
    44.955908, 47.867, 50.9415, 51.9961, 54.938044, 55.845, 58.933194,
    58.6934, 63.546, 65.38, 69.723, 72.63, 74.921595, 78.971, 79.904,
    83.798, 85.4678, 87.62, 88.90584, 91.224, 92.90637, 95.95, 97.90721,
    101.07, 102.9055, 106.42, 107.8682, 112.414, 114.818, 118.71,
    121.76, 127.6, 126.90447, 131.293, 132.90545196, 137.327,
    138.90547, 140.116, 140.90766, 144.242, 144.91276, 150.36,
    151.964, 157.25, 158.92535, 162.5, 164.93033, 167.259, 168.93422,
    173.045, 174.9668, 178.49, 180.94788, 183.84, 186.207, 190.23,
    192.217, 195.084, 196.966569, 200.592, 204.38, 207.2, 208.9804,
    208.98243, 209.98715, 222.01758, 223.01974, 226.02541, 227.02775,
    232.0377, 231.03588, 238.02891, 237.04817, 244.06421, 243.06138,
    247.07035, 247.07031, 251.07959, 252.083, 257.09511,
], np.float32)


def _endpoints(edge_index, n: int):
    coo = edge_index.coo if isinstance(edge_index, EdgeIndex) else edge_index
    return coo[0].long().clamp(max=n - 1), coo[1].long().clamp(max=n - 1)


class InteractionBlock(nn.Module):
    """The continuous-filter convolution and the atom-wise layers
    (reference ``schnet.py:InteractionBlock``): a filter ``filter2(ssp(
    filter1(edge_attr)))`` scaled by the cosine cutoff ``0.5 (cos(pi d /
    cutoff) + 1)``, times ``lin1(h)`` of each source, summed into each
    destination; then ``lin3(ssp(lin2(.)))`` and the residual."""

    def __init__(self, hidden_channels: int, num_gaussians: int,
                 num_filters: int, cutoff: float = 10.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.cutoff = cutoff
        self.act = ShiftedSoftplus()
        self.filter1 = linear(num_gaussians, num_filters, **kw)
        self.filter2 = linear(num_filters, num_filters, **kw)
        self.lin1 = linear(hidden_channels, num_filters, bias=False, **kw)
        self.lin2 = linear(num_filters, hidden_channels, **kw)
        self.lin3 = linear(hidden_channels, hidden_channels, **kw)

    def forward(self, h: torch.Tensor, edge_index, edge_weight: torch.Tensor,
                edge_attr: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = h.shape[0]
        src, dst = _endpoints(edge_index, n)
        w = self.filter2(self.act(self.filter1(edge_attr)))
        w = w * (0.5 * (torch.cos(edge_weight * math.pi / self.cutoff)
                        + 1.0))[:, None]
        out = scatter(self.lin1(h)[src] * w, dst, n, 'sum', mask=edge_mask)
        return h + self.lin3(self.act(self.lin2(out)))


class SchNet(nn.Module):
    """SchNet (reference ``schnet.py:35``): atom embeddings (``z == 0``
    embeds to 0, the reference's ``padding_idx``), ``num_interactions``
    blocks over the interaction graph, ``lin2(ssp(lin1(h)))`` an atom, and
    a sum (or mean) over each molecule. Options as the JAX package has
    them: ``dipole`` (each atom's output times its offset from its
    molecule's centre of mass, summed and normed), ``mean`` / ``std``
    target scaling and per-element ``atomref`` offsets (both skipped under
    ``dipole``), a unit ``scale``, and ``interaction_graph(pos, batch) ->
    (coo, dist, valid)`` in place of the fixed-k ``radius_graph``.

    ``forward(z, pos, batch=None, batch_size=1, node_mask=None)`` returns
    ``[batch_size, 1]``; ``node_mask`` drops padded atoms."""

    def __init__(self, hidden_channels: int = 128, num_filters: int = 128,
                 num_interactions: int = 6, num_gaussians: int = 50,
                 cutoff: float = 10.0, max_num_neighbors: int = 32,
                 readout: str = 'add', dipole: bool = False,
                 mean: Optional[float] = None, std: Optional[float] = None,
                 atomref=None, scale: Optional[float] = None,
                 interaction_graph: Optional[Callable] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.hidden_channels, self.num_filters = hidden_channels, num_filters
        self.num_interactions = num_interactions
        self.cutoff, self.max_num_neighbors = cutoff, max_num_neighbors
        self.readout, self.dipole = readout, dipole
        self.mean, self.std, self.scale = mean, std, scale
        self.interaction_graph = interaction_graph
        self.embedding = embedding(100, hidden_channels, **kw)
        self.distance_expansion = GaussianSmearing(0.0, cutoff,
                                                   num_gaussians).to(device)
        for i in range(num_interactions):
            self.add_module(f'interaction_{i}', InteractionBlock(
                hidden_channels, num_gaussians, num_filters, cutoff, **kw))
        self.act = ShiftedSoftplus()
        self.lin1 = linear(hidden_channels, hidden_channels // 2, **kw)
        self.lin2 = linear(hidden_channels // 2, 1, **kw)
        self.register_buffer('masses', torch.from_numpy(ATOMIC_MASSES).to(
            device), persistent=False)
        self.register_buffer(
            'atomref', None if atomref is None else torch.as_tensor(
                np.asarray(atomref, np.float32).reshape(-1), device=device),
            persistent=False)

    def forward(self, z: torch.Tensor, pos: torch.Tensor,
                batch: Optional[torch.Tensor] = None, batch_size: int = 1,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = z.shape[0]
        z = z.long()
        if batch is None:
            batch = torch.zeros(n, dtype=torch.long, device=z.device)
        h = torch.where((z > 0)[:, None], self.embedding(z), 0.0).to(pos)
        if self.interaction_graph is not None:
            coo, dist, valid = self.interaction_graph(pos, batch)
        else:
            coo, valid = radius_graph(
                pos, self.cutoff, batch=batch,
                max_num_neighbors=self.max_num_neighbors, mask=node_mask)
            src, dst = _endpoints(coo, n)
            dist = torch.linalg.vector_norm(pos[src] - pos[dst], dim=-1)
        edge_attr = self.distance_expansion(dist)
        for i in range(self.num_interactions):
            h = getattr(self, f'interaction_{i}')(h, coo, dist, edge_attr,
                                                  edge_mask=valid)
        h = self.lin2(self.act(self.lin1(h)))

        nm = (node_mask if node_mask is not None
              else torch.ones(n, dtype=torch.bool, device=z.device))
        if self.dipole:
            # each molecule's centre of mass (reference :296-300)
            mass = torch.where(nm, self.masses.to(pos)[z.clamp(0, 99)],
                               0.0)[:, None]
            m = scatter(mass, batch, batch_size, 'sum')
            c = scatter(mass * pos, batch, batch_size, 'sum') / torch.clamp(
                m, min=1e-9)
            h = h * (pos - c[batch.long()])
        elif self.mean is not None and self.std is not None:
            h = h * self.std + self.mean
        if not self.dipole and self.atomref is not None:
            ref = self.atomref.to(h)
            h = h + ref[z.clamp(0, ref.shape[0] - 1)][:, None]

        pool = (global_add_pool if (self.readout == 'add' or self.dipole)
                else global_mean_pool)
        out = pool(h, batch, batch_size, mask=node_mask)
        if self.dipole:
            out = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        if self.scale is not None:
            out = self.scale * out
        return out
