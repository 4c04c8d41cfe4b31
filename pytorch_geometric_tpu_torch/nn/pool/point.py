"""Point-cloud ops: knn / knn_graph / radius / radius_graph / fps.

Counterpart of ``pytorch_geometric_tpu/nn/pool/point.py`` (the
``torch_cluster`` kernels the reference wraps at ``nn/pool/__init__.py``).
Fixed-``k`` neighbour search is dense distance matrices from the matmul
expansion ``||y||^2 + ||x||^2 - 2 y x^T``, tiled above ``_DENSE_LIMIT``
entries with a running top-k merge, as in the JAX package; points of other
clouds (``batch``) and masked points are excluded by masking, not skipped.
Plain PyTorch: the JAX package computes these in XLA.

Ties go to the lowest index, as ``jax.lax.top_k`` breaks them (and the JAX
package's tiled merge keeps earlier tiles first): the dense branch takes a
stable sort of each row, the tiled branch a top-k of a composite key, the
distance's float32 bits above the column index (stable sorts for float64),
so duplicated points give the JAX package's neighbours. An invalid slot
(fewer than ``k`` candidates in its cloud) carries what the JAX package's
does: the lowest index among the excluded candidates in the dense branch, 0
in the tiled one. The search takes no gradient. Keep TF32 off for the
distance product (``torch.backends.cuda.matmul.allow_tf32``, off by
default): a TF32 product moves near neighbours past each other.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ...backend import resolve_device


def _pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[N, M] squared distances via the matmul expansion."""
    x2 = (x * x).sum(-1)[:, None]
    y2 = (y * y).sum(-1)[None, :]
    return (x2 + y2 - 2 * (x @ y.T)).clamp(min=0)


def _masked_dist(x, y, batch_x, batch_y, mask_x, mask_y):
    d = _pairwise_sqdist(x, y)
    inf = torch.tensor(math.inf, dtype=d.dtype, device=d.device)
    if batch_x is not None and batch_y is not None:
        d = torch.where(batch_x[:, None] == batch_y[None, :], d, inf)
    if mask_x is not None:
        d = torch.where(mask_x[:, None], d, inf)
    if mask_y is not None:
        d = torch.where(mask_y[None, :], d, inf)
    return d


# Above this many distance-matrix entries the dense [M, N] expansion is
# tiled: query tiles of _QT scan over x tiles of _XT with a running top-k
# merge, so peak memory is O(_QT * _XT) instead of O(M * N) (100k x 100k
# float32 would be 40 GB). The JAX package's constants.
_DENSE_LIMIT = 1 << 24
_QT = 1024
_XT = 8192
# the tiled branch's stand-in for an excluded pair (the JAX package's)
_BIG = 3.4e38


def _knn_indices(y, x, k, batch_y, batch_x, mask_y, mask_x,
                 exclude_self: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest x-rows per y-row -> (idx [M, k], valid [M, k])."""
    m, n = y.shape[0], x.shape[0]
    if k > n:
        # fewer candidates than k: take all n, pad the tail as invalid
        idx, valid = _knn_indices(y, x, n, batch_y, batch_x, mask_y,
                                  mask_x, exclude_self)
        return (torch.cat([idx, idx.new_zeros((m, k - n))], 1),
                torch.cat([valid, valid.new_zeros((m, k - n))], 1))
    with torch.no_grad():
        if m * n <= _DENSE_LIMIT:
            d = _masked_dist(y, x, batch_y, batch_x, mask_y, mask_x)
            if exclude_self:
                eye = (torch.arange(m, device=d.device)[:, None]
                       == torch.arange(n, device=d.device)[None, :])
                d = d.masked_fill(eye, math.inf)
            # a stable sort keeps equal distances in index order
            idx = torch.sort(d, dim=1, stable=True).indices[:, :k]
            return idx, torch.isfinite(d.gather(1, idx))
        return _knn_tiled(y, x, k, batch_y, batch_x, mask_y, mask_x,
                          exclude_self)


def _knn_tiled(y, x, k, batch_y, batch_x, mask_y, mask_x, exclude_self):
    m, n = y.shape[0], x.shape[0]
    dev = y.device
    xt = max(_XT, k)
    # the JAX package's distances here are float32 (with 64-bit types off,
    # as JAX runs by default, it never sees float64); a float64 input keeps
    # float64, so a float64 model's neighbours are its own
    dt = torch.float64 if y.dtype == torch.float64 else torch.float32
    yf, xf = y.to(dt), x.to(dt)
    # fold every per-point exclusion into one int "group" per point:
    # out-of-batch and masked-out points can never match
    gy = (torch.zeros(m, dtype=torch.int32, device=dev) if batch_y is None
          else batch_y.to(torch.int32))
    gx = (torch.zeros(n, dtype=torch.int32, device=dev) if batch_x is None
          else batch_x.to(torch.int32))
    if mask_y is not None:
        gy = torch.where(mask_y, gy, -1)
    if mask_x is not None:
        gx = torch.where(mask_x, gx, -2)
    big = torch.tensor(_BIG, dtype=dt, device=dev)
    x2 = (xf * xf).sum(-1)
    cols = torch.arange(n, device=dev)
    idxs, vals = [], []
    for q0 in range(0, m, _QT):
        yq = yf[q0:q0 + _QT]
        gq = gy[q0:q0 + _QT]
        y2 = (yq * yq).sum(-1)[:, None]
        # the running best, seeded with (big, index 0): the JAX package's
        # merge keeps its seed ahead of later tiles' excluded pairs, so an
        # invalid slot ends at index 0
        best_v = big.expand(yq.shape[0], k)
        best_i = cols.new_zeros((yq.shape[0], k))
        for j in range(0, n, xt):
            xb = xf[j:j + xt]
            d = (y2 + x2[None, j:j + xt] - 2 * (yq @ xb.T)).clamp(min=0)
            d = torch.where(gq[:, None] == gx[None, j:j + xt], d, big)
            if exclude_self:
                iy = torch.arange(q0, q0 + yq.shape[0], device=dev)
                d = torch.where(iy[:, None] == cols[None, j:j + xt], big, d)
            best_v, best_i = _merge(best_v, best_i, d, cols[j:j + xt], k)
        idxs.append(best_i)
        vals.append(best_v)
    return torch.cat(idxs), torch.cat(vals) < _BIG / 2


def _merge(best_v, best_i, d, cols, k):
    """The running top-k (smallest) merged with a tile's, ties to the
    running best and then to the lowest column, as the JAX package's merge
    orders them. float32: one top-k of a composite key, the distance's
    bits above the column (a non-negative float's bits order as the
    float); other dtypes: stable sorts."""
    if d.dtype == torch.float32:
        # + 0.0 turns a -0.0 into +0.0
        key = ((d + 0.0).view(torch.int32).long() << 32) | cols
        # a last tile narrower than k (the JAX package pads it) gives all
        top = torch.topk(key, min(k, key.shape[1]), dim=1, largest=False,
                         sorted=True).values
        run = (best_v.contiguous().view(torch.int32).long() << 32) | best_i
        best = torch.topk(torch.cat([run, top], 1), k, dim=1, largest=False,
                          sorted=True).values
        return ((best >> 32).to(torch.int32).view(torch.float32),
                best & 0xFFFFFFFF)
    v, i = torch.sort(d, dim=1, stable=True)
    all_v = torch.cat([best_v, v[:, :k]], 1)
    all_i = torch.cat([best_i, cols[i[:, :k]]], 1)
    pick = torch.sort(all_v, dim=1, stable=True).indices[:, :k]
    return all_v.gather(1, pick), all_i.gather(1, pick)


def knn(x: torch.Tensor, y: torch.Tensor, k: int,
        batch_x: Optional[torch.Tensor] = None,
        batch_y: Optional[torch.Tensor] = None,
        mask_x: Optional[torch.Tensor] = None,
        mask_y: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``y``, its ``k`` nearest rows of ``x`` (reference
    ``nn/pool/__init__.py:knn``). Returns ``edge_index [2, M*k]`` with row
    0 the y-index (query) and row 1 the x-index, plus a validity mask
    (False where fewer than k in-batch points exist)."""
    idx, valid = _knn_indices(y, x, k, batch_y, batch_x, mask_y, mask_x,
                              exclude_self=False)
    m = y.shape[0]
    row = torch.arange(m, device=y.device).repeat_interleave(k)
    return torch.stack([row, idx.reshape(-1)]), valid.reshape(-1)


def knn_graph(x: torch.Tensor, k: int,
              batch: Optional[torch.Tensor] = None,
              loop: bool = False,
              mask: Optional[torch.Tensor] = None,
              flow: str = 'source_to_target'
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN graph over a point set (reference ``knn_graph``). Returns
    (edge_index [2, N*k], edge_mask)."""
    idx, valid = _knn_indices(x, x, k, batch, batch, mask, mask,
                              exclude_self=not loop)
    n = x.shape[0]
    center = torch.arange(n, device=x.device).repeat_interleave(k)
    neighbor = idx.reshape(-1)
    if flow == 'source_to_target':
        coo = torch.stack([neighbor, center])
    else:
        coo = torch.stack([center, neighbor])
    return coo, valid.reshape(-1)


def radius(x: torch.Tensor, y: torch.Tensor, r: float,
           batch_x: Optional[torch.Tensor] = None,
           batch_y: Optional[torch.Tensor] = None,
           max_num_neighbors: int = 32,
           mask_x: Optional[torch.Tensor] = None,
           mask_y: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All x within r of each y, capped at ``max_num_neighbors``
    (reference ``radius``). Static output ``[2, M*max_num_neighbors]``."""
    ei, valid = knn(x, y, max_num_neighbors, batch_x, batch_y, mask_x,
                    mask_y)
    xs = x[ei[1].clamp(max=x.shape[0] - 1)]
    ys = y[ei[0].clamp(max=y.shape[0] - 1)]
    within = ((xs - ys) ** 2).sum(-1) <= r * r
    return ei, valid & within


def radius_graph(x: torch.Tensor, r: float,
                 batch: Optional[torch.Tensor] = None,
                 loop: bool = False, max_num_neighbors: int = 32,
                 mask: Optional[torch.Tensor] = None,
                 flow: str = 'source_to_target'
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radius graph (reference ``radius_graph``)."""
    coo, valid = knn_graph(x, max_num_neighbors, batch, loop, mask, flow)
    src, dst = coo[0], coo[1]
    last = x.shape[0] - 1
    d2 = ((x[src.clamp(max=last)] - x[dst.clamp(max=last)]) ** 2).sum(-1)
    return coo, valid & (d2 <= r * r)


def fps(pos: torch.Tensor, ratio: float = 0.5,
        batch: Optional[torch.Tensor] = None,
        random_start: bool = False,
        num_samples: Optional[int] = None) -> torch.Tensor:
    """Farthest point sampling of one cloud (reference
    ``nn/pool/__init__.py:fps``): the index array of ``num_samples``
    (default ``ceil(ratio * N)``) rows, from row 0, each next row the
    argmax of the running minimum distance to those chosen.

    The JAX package ignores ``batch`` and ``random_start``: it samples a
    batch of clouds as one and always starts at row 0. The port refuses
    both (``NotImplementedError``) rather than answer another question
    than the one asked (ROADMAP Queue 3)."""
    if random_start:
        raise NotImplementedError(
            'fps(random_start=True): the JAX package always starts at row 0')
    if batch is not None and batch.numel() and bool(
            (batch != batch[0]).any()):
        raise NotImplementedError(
            'fps over a batch of several clouds: the JAX package samples '
            'one cloud; call fps once a cloud')
    n = pos.shape[0]
    s = num_samples or max(1, math.ceil(ratio * n))
    sel = [torch.zeros(1, dtype=torch.long, device=pos.device)]
    mind = torch.full((n,), math.inf, dtype=pos.dtype, device=pos.device)
    with torch.no_grad():
        for _ in range(1, s):
            # distance to the most recent selected point; index_select
            # keeps the loop free of host reads
            last = pos.index_select(0, sel[-1])
            mind = torch.minimum(mind, ((pos - last) ** 2).sum(-1))
            sel.append(mind.argmax().view(1))
    return torch.cat(sel)


def nearest(x: torch.Tensor, y: torch.Tensor,
            batch_x: Optional[torch.Tensor] = None,
            batch_y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Index of the nearest y-row for every x-row (reference ``nearest``)."""
    idx, _ = _knn_indices(x, y, 1, batch_x, batch_y, None, None,
                          exclude_self=False)
    return idx[:, 0]


def voxel_grid(pos: torch.Tensor, size, batch: Optional[torch.Tensor] = None,
               start=None, end=None) -> torch.Tensor:
    """Voxel cluster ids (reference ``nn/pool/voxel_grid.py``): a raveled
    voxel id per point, not compacted; ``end`` is ignored, as in the JAX
    package."""
    dim = pos.shape[-1]
    size = torch.as_tensor(size, dtype=pos.dtype,
                           device=pos.device).broadcast_to((dim,))
    lo = (pos.min(0).values if start is None
          else torch.as_tensor(start, dtype=pos.dtype, device=pos.device))
    cell = torch.floor((pos - lo) / size).long()
    hi = cell.max(0).values + 1
    mult = torch.cat([torch.cumprod(hi.flip(0), 0).flip(0)[1:],
                      hi.new_ones(1)])
    vid = (cell * mult).sum(-1)
    if batch is not None:
        vid = vid + batch.long() * hi.prod()
    return vid


def approx_knn(x: torch.Tensor, y: torch.Tensor, k: int,
               batch_x: Optional[torch.Tensor] = None,
               batch_y: Optional[torch.Tensor] = None):
    """Approximate KNN (reference ``nn/pool/approx_knn.py``, pynndescent
    backed): the exact search, an alias kept for the API, as in the JAX
    package."""
    return knn(x, y, k, batch_x, batch_y)


def approx_knn_graph(x: torch.Tensor, k: int,
                     batch: Optional[torch.Tensor] = None,
                     loop: bool = False, flow: str = 'source_to_target'):
    """(reference ``approx_knn.py:approx_knn_graph``): the exact
    :func:`knn_graph`, see :func:`approx_knn`."""
    return knn_graph(x, k, batch, loop, flow=flow)


def decimation_indices(ptr, decimation_factor, seed: int = 0, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cloud random downsampling by ``decimation_factor`` (reference
    ``nn/pool/decimation.py:9``): each cloud keeps ``max(1, floor(count /
    factor))`` random points, drawn on the host with numpy as in the JAX
    package; returns ``(indices, new_ptr)`` on ``ptr``'s device when it is
    a tensor, else on ``device``."""
    if decimation_factor < 1:
        raise ValueError(
            f"The argument `decimation_factor` should be higher than (or "
            f"equal to) 1 for downsampling. (got {decimation_factor})")
    if isinstance(ptr, torch.Tensor):
        device = ptr.device
        ptr = ptr.cpu().numpy()
    else:
        device = resolve_device(device)
        ptr = np.asarray(ptr)
    count = ptr[1:] - ptr[:-1]
    decim_count = np.maximum(count // decimation_factor, 1).astype(ptr.dtype)
    rng = np.random.default_rng(seed)
    idx = np.concatenate([
        ptr[i] + rng.permutation(count[i])[:decim_count[i]]
        for i in range(len(count))]) if len(count) else np.zeros(0, ptr.dtype)
    new_ptr = np.concatenate([[0], np.cumsum(decim_count)])
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(new_ptr, device=device))
