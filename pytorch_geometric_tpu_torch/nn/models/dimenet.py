"""DimeNet and DimeNet++, directional message passing over triplets.

Counterpart of ``pytorch_geometric_tpu/nn/models/dimenet.py`` (reference
``torch_geometric/nn/models/dimenet.py:457,728``): the spherical-Bessel x
zonal-harmonic bases, the embedding, interaction (bilinear and ++) and
output blocks with their residual towers, and edge-to-edge message passing
over triplets ``k -> j -> i``.

As in the JAX package:

  * the interaction graph and the triplets are host numpy
    (:meth:`DimeNet.prepare`, :func:`triplets`), one vectorised pass, the
    triplets padded to ``max_triplets`` where asked;
  * the bases are evaluated by recurrences: the spherical Bessel functions
    by the upward recurrence for ``x >= 0.5`` and a two-term ascending
    series below (:func:`_spherical_jn`, the JAX package's switch and
    arithmetic exactly, its float32 error included: at ``l = 6`` the
    recurrence multiplies a rounding error of ``sin`` or ``cos`` by up to
    ``prod (2l + 1) / x``), the Legendre polynomials by their three-term
    recurrence; the Bessel zeros and normalisers are host constants from
    scipy (:func:`_bessel_zeros_and_norms`);
  * every reduction is a gather and an ``index_add_`` (the JAX package
    leaves them to XLA): no port kernel runs.

Submodules and parameters are named as the flax modules name theirs
(``rbf.freq``, ``emb.emb``, ``interaction_b.W``, ``output_b.lins_i`` ->
``output_b.lins.i``, ``res_before_i`` ...), so
``convert.flax_to_state_dict`` carries the weights across.
"""

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..inits import linear
from ...backend import resolve_device
from ...ops import scatter


@lru_cache(maxsize=None)
def _bessel_zeros_and_norms(num_spherical: int, num_radial: int):
    """The first ``num_radial`` zeros of ``j_l`` for ``l < num_spherical``
    and the normalisers ``1 / sqrt(0.5 J_{l+1}(z)^2)`` (reference
    ``dimenet_utils.py:11-27``), float32 host arrays ``[L, K]``."""
    from scipy import special as sp
    from scipy.optimize import brentq

    def jn(r, n):
        return np.sqrt(np.pi / (2 * r)) * sp.jv(n + 0.5, r)

    n, k = num_spherical, num_radial
    zerosj = np.zeros((n, k), dtype='float64')
    zerosj[0] = np.arange(1, k + 1) * np.pi
    points = np.arange(1, k + n) * np.pi
    racines = np.zeros(k + n - 1, dtype='float64')
    for i in range(1, n):
        for j in range(k + n - 1 - i):
            racines[j] = brentq(jn, points[j], points[j + 1], (i,))
        points = racines.copy()
        zerosj[i][:k] = racines[:k]
    norms = np.zeros((n, k))
    for l in range(n):
        norms[l] = 1.0 / np.sqrt(0.5 * jn(zerosj[l], l + 1) ** 2)
    return zerosj.astype(np.float32), norms.astype(np.float32)


def _spherical_jn(x: torch.Tensor, lmax: int) -> torch.Tensor:
    """``j_l(x)`` for ``l`` in ``[0, lmax]`` stacked on the last axis: the
    upward recurrence for ``x >= 0.5``, and below it (where the recurrence
    cancels catastrophically) the series ``x^l / (2l+1)!! (1 - x^2 / (2
    (2l + 3)))`` (JAX ``dimenet.py:62-86``)."""
    xs = torch.clamp(x, min=0.5)          # the recurrence's input only
    rec = [torch.sin(xs) / xs]
    if lmax >= 1:
        rec.append(torch.sin(xs) / xs ** 2 - torch.cos(xs) / xs)
        for l in range(1, lmax):
            rec.append((2 * l + 1) / xs * rec[l] - rec[l - 1])
    small = x < 0.5
    out = []
    dfact = 1.0
    for l in range(lmax + 1):
        if l > 0:
            dfact *= (2 * l + 1)
        series = x ** l / dfact * (1 - x * x / (2 * (2 * l + 3)))
        out.append(torch.where(small, series, rec[l]))
    return torch.stack(out, dim=-1)


def _zonal_harmonics(angle: torch.Tensor, lmax: int) -> torch.Tensor:
    """``Y_l^0(theta) = sqrt((2l+1) / 4 pi) P_l(cos theta)`` for ``l`` in
    ``[0, lmax]`` stacked on the last axis."""
    z = torch.cos(angle)
    p = [torch.ones_like(z)]
    if lmax >= 1:
        p.append(z)
        for l in range(2, lmax + 1):
            p.append(((2 * l - 1) * z * p[l - 1] - (l - 1) * p[l - 2]) / l)
    return torch.stack([p[l] * math.sqrt((2 * l + 1) / (4 * math.pi))
                        for l in range(lmax + 1)], dim=-1)


class Envelope(nn.Module):
    """``u(x) = 1/x + a x^(p-1) + b x^p + c x^(p+1)`` below 1, 0 from 1 on
    (reference ``dimenet.py:35``), ``p = exponent + 1``."""

    def __init__(self, exponent: int = 5):
        super().__init__()
        self.exponent = exponent

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.exponent + 1
        a = -(p + 1) * (p + 2) / 2
        b = p * (p + 2)
        c = -p * (p + 1) / 2
        xp0 = x ** (p - 1)
        env = (1.0 / torch.clamp(x, min=1e-12) + a * xp0 + b * xp0 * x
               + c * xp0 * x * x)
        return torch.where(x < 1.0, env, 0.0)


class BesselBasisLayer(nn.Module):
    """The radial basis ``envelope(d / c) sin(freq d / c)`` with learnable
    frequencies, ``n pi`` at the start (reference ``dimenet.py:52``)."""

    def __init__(self, num_radial: int, cutoff: float = 5.0,
                 envelope_exponent: int = 5, device=None):
        super().__init__()
        self.cutoff = cutoff
        self.envelope = Envelope(envelope_exponent)
        self.freq = nn.Parameter(
            torch.arange(1, num_radial + 1, dtype=torch.float32,
                         device=resolve_device(device)) * math.pi)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        d = (dist / self.cutoff)[:, None]
        return self.envelope(d) * torch.sin(self.freq[None] * d)


class SphericalBasisLayer(nn.Module):
    """The triplet basis ``envelope(d / c) norm_ln j_l(z_ln d / c) Y_l^0(
    angle)`` (reference ``dimenet.py:73``): ``[T, L * K]``, the radial part
    of each triplet's ``k -> j`` edge."""

    def __init__(self, num_spherical: int, num_radial: int,
                 cutoff: float = 5.0, envelope_exponent: int = 5):
        super().__init__()
        self.num_spherical, self.num_radial = num_spherical, num_radial
        self.cutoff = cutoff
        self.envelope = Envelope(envelope_exponent)
        zeros, norms = _bessel_zeros_and_norms(num_spherical, num_radial)
        self.register_buffer('zeros', torch.from_numpy(zeros),
                             persistent=False)
        self.register_buffer('norms', torch.from_numpy(norms),
                             persistent=False)

    def forward(self, dist: torch.Tensor, angle: torch.Tensor,
                idx_kj: torch.Tensor) -> torch.Tensor:
        n, k = self.num_spherical, self.num_radial
        u = dist / self.cutoff                                    # [E]
        x = u[:, None, None] * self.zeros.to(u)[None]             # [E, L, K]
        jl = _spherical_jn(x, n - 1)                          # [E, L, K, L]
        rbf = torch.diagonal(jl, dim1=1, dim2=3).permute(0, 2, 1)
        rbf = rbf * self.norms.to(u)[None]
        rbf = self.envelope(u)[:, None, None] * rbf               # [E, L, K]
        cbf = _zonal_harmonics(angle, n - 1)                      # [T, L]
        kj = idx_kj.long().clamp(max=dist.shape[0] - 1)
        return (rbf[kj] * cbf[:, :, None]).reshape(-1, n * k)


class EmbeddingBlock(nn.Module):
    """Edge embeddings ``silu(lin([x_i | x_j | silu(lin_rbf(rbf))]))``
    from atom embeddings ``emb`` (95 elements, uniform in ``[-sqrt 3,
    sqrt 3]``) (reference ``dimenet.py:129``)."""

    def __init__(self, num_radial: int, hidden_channels: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        emb = torch.empty(95, hidden_channels).uniform_(
            -math.sqrt(3.0), math.sqrt(3.0), generator=generator)
        self.emb = nn.Parameter(emb.to(device))
        self.lin_rbf = linear(num_radial, hidden_channels, **kw)
        self.lin = linear(3 * hidden_channels, hidden_channels, **kw)

    def forward(self, z, rbf, i, j):
        x = self.emb[z.long().clamp(0, 94)]
        rbf = F.silu(self.lin_rbf(rbf))
        return F.silu(self.lin(torch.cat([x[i], x[j], rbf], dim=-1)))


class ResidualLayer(nn.Module):
    """``x + silu(lin2(silu(lin1(x))))`` (reference ``dimenet.py:151``)."""

    def __init__(self, hidden_channels: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.lin1 = linear(hidden_channels, hidden_channels, **kw)
        self.lin2 = linear(hidden_channels, hidden_channels, **kw)

    def forward(self, x):
        return x + F.silu(self.lin2(F.silu(self.lin1(x))))


class _Interaction(nn.Module):
    """What both interaction blocks share: ``lin_ji``, ``lin_kj``, the
    residual towers around ``lin`` and the skip."""

    def _towers(self, hidden_channels, num_before_skip, num_after_skip, kw):
        self.lin_ji = linear(hidden_channels, hidden_channels, **kw)
        self.lin_kj = linear(hidden_channels, hidden_channels, **kw)
        for b in range(num_before_skip):
            self.add_module(f'res_before_{b}',
                            ResidualLayer(hidden_channels, **kw))
        self.lin = linear(hidden_channels, hidden_channels, **kw)
        for b in range(num_after_skip):
            self.add_module(f'res_after_{b}',
                            ResidualLayer(hidden_channels, **kw))
        self.num_before_skip, self.num_after_skip = (num_before_skip,
                                                     num_after_skip)

    def _finish(self, x, h):
        for b in range(self.num_before_skip):
            h = getattr(self, f'res_before_{b}')(h)
        h = F.silu(self.lin(h)) + x
        for b in range(self.num_after_skip):
            h = getattr(self, f'res_after_{b}')(h)
        return h


def _triplet_sum(t, idx_ji, triplet_mask, e):
    t = torch.where(triplet_mask[:, None], t, 0.0)
    return scatter(t, idx_ji.long().clamp(max=e - 1), e, 'sum',
                   mask=triplet_mask)


class InteractionBlock(_Interaction):
    """The bilinear directional interaction (reference
    ``dimenet.py:170``): ``einsum('wj,wl,ijl->wi', lin_sbf(sbf), x_kj, W)``
    a triplet, summed into its ``j -> i`` edge."""

    def __init__(self, hidden_channels: int, num_bilinear: int,
                 num_spherical: int, num_radial: int,
                 num_before_skip: int = 1, num_after_skip: int = 2,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        h = hidden_channels
        self.lin_rbf = linear(num_radial, h, bias=False, **kw)
        self.lin_sbf = linear(num_spherical * num_radial, num_bilinear,
                              bias=False, **kw)
        self._towers(h, num_before_skip, num_after_skip, kw)
        w = torch.empty(h, num_bilinear, h).normal_(0.0, 2.0 / h,
                                                    generator=generator)
        self.W = nn.Parameter(w.to(device))

    def forward(self, x, rbf, sbf, idx_kj, idx_ji, triplet_mask):
        e = x.shape[0]
        rbf = self.lin_rbf(rbf)
        sbf = self.lin_sbf(sbf)
        x_ji = F.silu(self.lin_ji(x))
        x_kj = F.silu(self.lin_kj(x)) * rbf
        kj = idx_kj.long().clamp(max=e - 1)
        t = torch.einsum('wj,wl,ijl->wi', sbf, x_kj[kj], self.W)
        return self._finish(x, x_ji + _triplet_sum(t, idx_ji, triplet_mask,
                                                   e))


class InteractionPPBlock(_Interaction):
    """The DimeNet++ interaction (reference ``dimenet.py:241``): the bases
    through ``basis_emb_size`` bottlenecks, the triplet products at
    ``int_emb_size`` between ``lin_down`` and ``lin_up``."""

    def __init__(self, hidden_channels: int, int_emb_size: int,
                 basis_emb_size: int, num_spherical: int, num_radial: int,
                 num_before_skip: int = 1, num_after_skip: int = 2,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        h = hidden_channels
        self.lin_rbf1 = linear(num_radial, basis_emb_size, bias=False, **kw)
        self.lin_rbf2 = linear(basis_emb_size, h, bias=False, **kw)
        self.lin_sbf1 = linear(num_spherical * num_radial, basis_emb_size,
                               bias=False, **kw)
        self.lin_sbf2 = linear(basis_emb_size, int_emb_size, bias=False, **kw)
        self.lin_down = linear(h, int_emb_size, bias=False, **kw)
        self.lin_up = linear(int_emb_size, h, bias=False, **kw)
        self._towers(h, num_before_skip, num_after_skip, kw)

    def forward(self, x, rbf, sbf, idx_kj, idx_ji, triplet_mask):
        e = x.shape[0]
        x_ji = F.silu(self.lin_ji(x))
        x_kj = F.silu(self.lin_kj(x)) * self.lin_rbf2(self.lin_rbf1(rbf))
        x_kj = F.silu(self.lin_down(x_kj))
        sbf = self.lin_sbf2(self.lin_sbf1(sbf))
        t = x_kj[idx_kj.long().clamp(max=e - 1)] * sbf
        x_kj = F.silu(self.lin_up(_triplet_sum(t, idx_ji, triplet_mask, e)))
        return self._finish(x, x_ji + x_kj)


class OutputBlock(nn.Module):
    """Edge messages ``lin_rbf(rbf) * x`` summed into their destination
    atoms, ``num_layers`` silu layers (``lins``), and ``lin`` (zeros at the
    start, or glorot) (reference ``dimenet.py:337``); with ``out_emb``
    (DimeNet++, ``dimenet.py:381``) a ``lin_up`` to that width first."""

    def __init__(self, num_radial: int, hidden_channels: int,
                 out_channels: int, num_layers: int = 3,
                 output_initializer: str = 'zeros',
                 out_emb: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        width = hidden_channels if out_emb is None else out_emb
        self.lin_rbf = linear(num_radial, hidden_channels, bias=False, **kw)
        self.lin_up = (None if out_emb is None else
                       linear(hidden_channels, out_emb, bias=False, **kw))
        self.lins = nn.ModuleList(linear(width, width, **kw)
                                  for _ in range(num_layers))
        if output_initializer == 'zeros':
            self.lin = linear(width, out_channels, bias=False, device=device)
            with torch.no_grad():
                self.lin.weight.zero_()
        else:
            self.lin = linear(width, out_channels, bias=False,
                              init='glorot_uniform', **kw)

    def forward(self, x, rbf, i, num_nodes, edge_mask):
        h = scatter(self.lin_rbf(rbf) * x, i.clamp(max=num_nodes - 1),
                    num_nodes, 'sum', mask=edge_mask)
        if self.lin_up is not None:
            h = self.lin_up(h)
        for lin in self.lins:
            h = F.silu(lin(h))
        return self.lin(h)


class OutputPPBlock(OutputBlock):
    """The DimeNet++ output block (reference ``dimenet.py:381``)."""

    def __init__(self, num_radial: int, hidden_channels: int,
                 out_emb_channels: int, out_channels: int,
                 num_layers: int = 3, output_initializer: str = 'zeros',
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(num_radial, hidden_channels, out_channels,
                         num_layers, output_initializer, out_emb_channels,
                         device, generator)


def triplets(coo: np.ndarray, num_nodes: int,
             max_triplets: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host: the triplets ``(k -> j, j -> i)`` of the edges ``coo`` (rows
    ``(j, i)``, edges ``j -> i``), ``k != i``, as ``(idx_kj, idx_ji,
    mask)``, padded to ``max_triplets`` with the sentinel ``E`` (JAX
    ``dimenet.py:324-351``)."""
    row, col = np.asarray(coo[0]), np.asarray(coo[1])
    e = row.shape[0]
    order = np.argsort(col, kind='stable')       # edges grouped by dst
    col_s = col[order]
    indptr = np.searchsorted(col_s, np.arange(num_nodes + 1))
    # for edge e = (j -> i): all edges f = (k -> j) with dst j
    cnt = indptr[row + 1] - indptr[row]
    idx_ji = np.repeat(np.arange(e), cnt)
    starts = np.repeat(indptr[row], cnt)
    local = np.arange(cnt.sum()) - np.repeat(
        np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    idx_kj = order[starts + local]
    keep = row[idx_kj] != col[idx_ji]            # drop k == i
    idx_kj, idx_ji = idx_kj[keep], idx_ji[keep]
    t = idx_kj.shape[0]
    cap = max_triplets or t
    out_kj = np.full(cap, e, np.int32)
    out_ji = np.full(cap, e, np.int32)
    out_kj[:min(t, cap)] = idx_kj[:cap]
    out_ji[:min(t, cap)] = idx_ji[:cap]
    return out_kj, out_ji, np.arange(cap) < min(t, cap)


class DimeNet(nn.Module):
    """DimeNet (reference ``dimenet.py:457``). ``forward(z, pos, coo,
    idx_kj, idx_ji, triplet_mask, batch=None, batch_size=1,
    edge_mask=None)`` takes the interaction graph ``coo`` (``j -> i``
    edges) and its triplets from :meth:`prepare` (host numpy, moved to the
    model's device by the caller) and returns ``[batch_size,
    out_channels]`` (``[out_channels]`` without ``batch``)."""

    _pp = False
    triplets = staticmethod(triplets)

    def __init__(self, hidden_channels: int = 128, out_channels: int = 1,
                 num_blocks: int = 6, num_bilinear: int = 8,
                 num_spherical: int = 7, num_radial: int = 6,
                 cutoff: float = 5.0, max_num_neighbors: int = 32,
                 envelope_exponent: int = 5, num_before_skip: int = 1,
                 num_after_skip: int = 2, num_output_layers: int = 3,
                 output_initializer: str = 'zeros', device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_bilinear = num_bilinear
        self._setup(hidden_channels, out_channels, num_blocks, num_spherical,
                    num_radial, cutoff, max_num_neighbors, envelope_exponent,
                    num_before_skip, num_after_skip, num_output_layers,
                    output_initializer, device, generator)

    def _setup(self, hidden_channels, out_channels, num_blocks,
               num_spherical, num_radial, cutoff, max_num_neighbors,
               envelope_exponent, num_before_skip, num_after_skip,
               num_output_layers, output_initializer, device, generator):
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.hidden_channels, self.out_channels = hidden_channels, out_channels
        self.num_blocks = num_blocks
        self.num_spherical, self.num_radial = num_spherical, num_radial
        self.cutoff, self.max_num_neighbors = cutoff, max_num_neighbors
        self.num_before_skip, self.num_after_skip = (num_before_skip,
                                                     num_after_skip)
        self.num_output_layers = num_output_layers
        self.output_initializer = output_initializer
        self.rbf = BesselBasisLayer(num_radial, cutoff, envelope_exponent,
                                    device=device)
        self.sbf = SphericalBasisLayer(num_spherical, num_radial, cutoff,
                                       envelope_exponent).to(device)
        self.emb = EmbeddingBlock(num_radial, hidden_channels, **kw)
        self.add_module('output_0', self._output(kw))
        for b in range(num_blocks):
            self.add_module(f'interaction_{b}', self._interaction(kw))
            self.add_module(f'output_{b + 1}', self._output(kw))

    def _interaction(self, kw):
        return InteractionBlock(
            self.hidden_channels, self.num_bilinear, self.num_spherical,
            self.num_radial, self.num_before_skip, self.num_after_skip, **kw)

    def _output(self, kw):
        return OutputBlock(self.num_radial, self.hidden_channels,
                           self.out_channels, self.num_output_layers,
                           self.output_initializer, **kw)

    @classmethod
    def prepare(cls, pos: np.ndarray, batch: Optional[np.ndarray],
                cutoff: float, max_num_neighbors: int = 32,
                max_triplets: Optional[int] = None):
        """Host: every pair of atoms of one molecule within ``cutoff``, in
        both directions (``j -> i``), and its triplets: ``(coo, idx_kj,
        idx_ji, mask)`` (JAX ``dimenet.py:378-388``; no neighbour cap, as
        there)."""
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        same = (np.ones_like(d, bool) if batch is None
                else batch[:, None] == batch[None])
        keep = (d <= cutoff) & same & ~np.eye(len(pos), dtype=bool)
        i, j = np.nonzero(keep)
        coo = np.stack([j, i]).astype(np.int32)   # j -> i
        kj, ji, mask = triplets(coo, len(pos), max_triplets)
        return coo, kj, ji, mask

    def forward(self, z, pos, coo, idx_kj, idx_ji, triplet_mask,
                batch: Optional[torch.Tensor] = None, batch_size: int = 1,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, e = z.shape[0], coo.shape[1]
        j = coo[0].long().clamp(max=n - 1)
        i = coo[1].long().clamp(max=n - 1)
        dist = torch.sqrt(torch.clamp(((pos[i] - pos[j]) ** 2).sum(-1),
                                      min=1e-12))
        kj = idx_kj.long().clamp(max=e - 1)
        ji = idx_ji.long().clamp(max=e - 1)
        idx_i, idx_j, idx_k = i[ji], j[ji], j[kj]
        if self._pp:
            v1 = pos[idx_j] - pos[idx_k]      # pos_jk
            v2 = pos[idx_i] - pos[idx_j]      # pos_ij
            a = (v2 * v1).sum(-1)
            b = torch.linalg.vector_norm(torch.linalg.cross(v2, v1), dim=-1)
        else:
            v1 = pos[idx_j] - pos[idx_i]      # pos_ji
            v2 = pos[idx_k] - pos[idx_i]      # pos_ki
            a = (v1 * v2).sum(-1)
            b = torch.linalg.vector_norm(torch.linalg.cross(v1, v2), dim=-1)
        angle = torch.atan2(b, a)

        rbf = self.rbf(dist)
        sbf = self.sbf(dist, angle, idx_kj)
        if edge_mask is not None:
            rbf = torch.where(edge_mask[:, None], rbf, 0.0)
        x = self.emb(z, rbf, i, j)
        p = self.output_0(x, rbf, i, n, edge_mask)
        for b in range(self.num_blocks):
            x = getattr(self, f'interaction_{b}')(x, rbf, sbf, idx_kj,
                                                  idx_ji, triplet_mask)
            p = p + getattr(self, f'output_{b + 1}')(x, rbf, i, n,
                                                     edge_mask)
        if batch is None:
            return p.sum(0)
        return scatter(p, batch, batch_size, 'sum')


class DimeNetPlusPlus(DimeNet):
    """DimeNet++ (reference ``dimenet.py:728``): the interaction through
    ``InteractionPPBlock``, the output through ``OutputPPBlock``, the
    angle measured between ``j -> k`` and ``i -> j``."""

    _pp = True

    def __init__(self, hidden_channels: int = 128, out_channels: int = 1,
                 num_blocks: int = 6, int_emb_size: int = 64,
                 basis_emb_size: int = 8, out_emb_channels: int = 256,
                 num_spherical: int = 7, num_radial: int = 6,
                 cutoff: float = 5.0, max_num_neighbors: int = 32,
                 envelope_exponent: int = 5, num_before_skip: int = 1,
                 num_after_skip: int = 2, num_output_layers: int = 3,
                 output_initializer: str = 'zeros', device=None,
                 generator: Optional[torch.Generator] = None):
        nn.Module.__init__(self)
        self.int_emb_size, self.basis_emb_size = int_emb_size, basis_emb_size
        self.out_emb_channels = out_emb_channels
        self._setup(hidden_channels, out_channels, num_blocks, num_spherical,
                    num_radial, cutoff, max_num_neighbors, envelope_exponent,
                    num_before_skip, num_after_skip, num_output_layers,
                    output_initializer, device, generator)

    def _interaction(self, kw):
        return InteractionPPBlock(
            self.hidden_channels, self.int_emb_size, self.basis_emb_size,
            self.num_spherical, self.num_radial, self.num_before_skip,
            self.num_after_skip, **kw)

    def _output(self, kw):
        return OutputPPBlock(self.num_radial, self.hidden_channels,
                             self.out_emb_channels, self.out_channels,
                             self.num_output_layers,
                             self.output_initializer, **kw)
