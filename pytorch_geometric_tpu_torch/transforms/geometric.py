"""Geometric (point-cloud / mesh) transforms.

Counterpart of ``pytorch_geometric_tpu/transforms/geometric.py`` (reference
``knn_graph.py``, ``radius_graph.py``, ``distance.py``, ``cartesian.py``,
``polar.py``, ``spherical.py``, ``center.py``, ``normalize_scale.py``,
``random_jitter.py``, ``random_flip.py``, ``random_rotate.py``,
``random_scale.py``, ``random_shear.py``, ``sample_points.py``,
``grid_sampling.py``). Host numpy, as in the JAX package, with the same
arithmetic and the same seeded ``numpy`` generators, so every result is
bitwise the JAX package's; the new fields are CPU tensors with the dtypes
``jnp.asarray`` gives (:func:`..data.data.as_tensor`).
"""

from typing import Optional

import numpy as np

from .base import BaseTransform
from ..data import Data
from ..data.data import as_tensor, host


def _coo(data) -> np.ndarray:
    return host(data.edge_index)


class Center(BaseTransform):
    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)
        return data.replace(pos=as_tensor(pos - pos.mean(0)))


class NormalizeScale(BaseTransform):
    """Center + scale into (-1, 1) (reference ``normalize_scale.py``)."""

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)
        pos = pos - pos.mean(0)
        scale = (1.0 / np.abs(pos).max()) * 0.999999
        return data.replace(pos=as_tensor(pos * scale))


class KNNGraph(BaseTransform):
    """Build fixed-k kNN edges from ``pos`` (reference ``knn_graph.py``)."""

    def __init__(self, k: int = 6, loop: bool = False,
                 force_undirected: bool = False):
        self.k = k
        self.loop = loop
        self.force_undirected = force_undirected

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)
        n = pos.shape[0]
        d = ((pos[:, None] - pos[None, :]) ** 2).sum(-1)
        if not self.loop:
            np.fill_diagonal(d, np.inf)
        k = min(self.k, n - (0 if self.loop else 1))
        nbr = np.argpartition(d, k - 1, axis=1)[:, :k]
        row = nbr.reshape(-1)
        col = np.repeat(np.arange(n), k)
        coo = np.stack([row, col]).astype(np.int32)
        if self.force_undirected:
            from ..utils.coalesce import to_undirected
            coo = to_undirected(coo, num_nodes=n)
        return data.replace(edge_index=as_tensor(coo))


class RadiusGraph(BaseTransform):
    """(reference ``radius_graph.py``): host side, dynamic E."""

    def __init__(self, r: float, loop: bool = False,
                 max_num_neighbors: int = 32):
        self.r = r
        self.loop = loop
        self.max_num_neighbors = max_num_neighbors

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)
        n = pos.shape[0]
        d = ((pos[:, None] - pos[None, :]) ** 2).sum(-1)
        if not self.loop:
            np.fill_diagonal(d, np.inf)
        rows, cols = np.nonzero(d <= self.r * self.r)
        # cap the neighbours of each centre, in row order
        keep = np.ones(len(rows), bool)
        cnt = {}
        for i, c in enumerate(cols):
            cnt[c] = cnt.get(c, 0) + 1
            if cnt[c] > self.max_num_neighbors:
                keep[i] = False
        coo = np.stack([rows[keep], cols[keep]]).astype(np.int32)
        return data.replace(edge_index=as_tensor(coo))


class Distance(BaseTransform):
    """Append edge length to edge_attr (reference ``distance.py``)."""

    def __init__(self, norm: bool = True, cat: bool = True):
        self.norm = norm
        self.cat = cat

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)
        coo = _coo(data)
        d = np.linalg.norm(pos[coo[1]] - pos[coo[0]], axis=-1)[:, None]
        if self.norm and d.max() > 0:
            d = d / d.max()
        if data.edge_attr is not None and self.cat:
            d = np.concatenate([host(data.edge_attr), d], -1)
        return data.replace(edge_attr=as_tensor(d.astype(np.float32)))


class Cartesian(BaseTransform):
    """Append relative cartesian offsets (reference ``cartesian.py``)."""

    def __init__(self, norm: bool = True, cat: bool = True):
        self.norm = norm
        self.cat = cat

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)
        coo = _coo(data)
        # reference cartesian.py:44 is pos[row] - pos[col] (its polar and
        # spherical take the opposite direction)
        cart = pos[coo[0]] - pos[coo[1]]
        if self.norm and cart.size and np.abs(cart).max() > 0:
            cart = cart / (2 * np.abs(cart).max()) + 0.5
        if data.edge_attr is not None and self.cat:
            cart = np.concatenate([host(data.edge_attr), cart], -1)
        return data.replace(edge_attr=as_tensor(cart.astype(np.float32)))


class Polar(BaseTransform):
    """2-D polar edge attributes (reference ``polar.py``)."""

    def __init__(self, norm: bool = True, cat: bool = True):
        self.norm = norm
        self.cat = cat

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)[:, :2]
        coo = _coo(data)
        d = pos[coo[1]] - pos[coo[0]]
        rho = np.linalg.norm(d, axis=-1)
        theta = np.arctan2(d[:, 1], d[:, 0])
        theta = np.where(theta < 0, theta + 2 * np.pi, theta)
        if self.norm:
            rho = rho / max(rho.max(), 1e-12)
            theta = theta / (2 * np.pi)
        ea = np.stack([rho, theta], -1)
        if data.edge_attr is not None and self.cat:
            ea = np.concatenate([host(data.edge_attr), ea], -1)
        return data.replace(edge_attr=as_tensor(ea.astype(np.float32)))


class Spherical(BaseTransform):
    """3-D spherical edge attributes (reference ``spherical.py``)."""

    def __init__(self, norm: bool = True, cat: bool = True):
        self.norm = norm
        self.cat = cat

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)
        coo = _coo(data)
        d = pos[coo[1]] - pos[coo[0]]
        rho = np.linalg.norm(d, axis=-1)
        theta = np.arctan2(d[:, 1], d[:, 0])
        theta = np.where(theta < 0, theta + 2 * np.pi, theta)
        # the clip keeps zero-length (self-loop) edges finite where the
        # reference gives nan (spherical.py: acos(z / 0))
        phi = np.arccos(np.clip(d[:, 2] / np.maximum(rho, 1e-12), -1, 1))
        if self.norm:
            rho = rho / max(rho.max(), 1e-12)
            theta = theta / (2 * np.pi)
            phi = phi / np.pi
        ea = np.stack([rho, theta, phi], -1)
        if data.edge_attr is not None and self.cat:
            ea = np.concatenate([host(data.edge_attr), ea], -1)
        return data.replace(edge_attr=as_tensor(ea.astype(np.float32)))


class RandomJitter(BaseTransform):
    """(reference ``random_jitter.py``)."""

    def __init__(self, translate: float, seed: Optional[int] = None):
        self.translate = translate
        self.rng = np.random.default_rng(seed)

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)
        jitter = self.rng.uniform(-self.translate, self.translate,
                                  pos.shape)
        return data.replace(pos=as_tensor((pos + jitter).astype(np.float32)))


class RandomFlip(BaseTransform):
    """(reference ``random_flip.py``)."""

    def __init__(self, axis: int = 0, p: float = 0.5,
                 seed: Optional[int] = None):
        self.axis = axis
        self.p = p
        self.rng = np.random.default_rng(seed)

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos).copy()
        if self.rng.random() < self.p:
            pos[:, self.axis] = -pos[:, self.axis]
        return data.replace(pos=as_tensor(pos))


class RandomRotate(BaseTransform):
    """(reference ``random_rotate.py``)."""

    def __init__(self, degrees: float, axis: int = 0,
                 seed: Optional[int] = None):
        self.degrees = degrees
        self.axis = axis
        self.rng = np.random.default_rng(seed)

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)
        deg = np.pi * self.rng.uniform(-self.degrees, self.degrees) / 180
        s, c = np.sin(deg), np.cos(deg)
        if pos.shape[-1] == 2:
            m = np.array([[c, -s], [s, c]])
        elif self.axis == 0:
            m = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        elif self.axis == 1:
            m = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        else:
            m = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        return data.replace(pos=as_tensor((pos @ m.T).astype(np.float32)))


class RandomScale(BaseTransform):
    """(reference ``random_scale.py``)."""

    def __init__(self, scales, seed: Optional[int] = None):
        self.scales = scales
        self.rng = np.random.default_rng(seed)

    def __call__(self, data: Data) -> Data:
        s = self.rng.uniform(*self.scales)
        return data.replace(pos=as_tensor(
            (host(data.pos) * s).astype(np.float32)))


class RandomShear(BaseTransform):
    """(reference ``random_shear.py``)."""

    def __init__(self, shear: float, seed: Optional[int] = None):
        self.shear = shear
        self.rng = np.random.default_rng(seed)

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)
        dim = pos.shape[-1]
        m = self.rng.uniform(-self.shear, self.shear, (dim, dim))
        np.fill_diagonal(m, 1.0)
        return data.replace(pos=as_tensor((pos @ m.T).astype(np.float32)))


class SamplePoints(BaseTransform):
    """Sample points uniformly from mesh faces (reference
    ``sample_points.py``): faces drawn by area, then a point uniform in
    each (the reflected barycentric draw)."""

    def __init__(self, num: int, remove_faces: bool = True,
                 include_normals: bool = False,
                 seed: Optional[int] = None):
        self.num = num
        self.remove_faces = remove_faces
        self.include_normals = include_normals
        self.rng = np.random.default_rng(seed)

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)
        face = host(data.face)
        v0, v1, v2 = pos[face[0]], pos[face[1]], pos[face[2]]
        area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
        prob = area / max(area.sum(), 1e-12)
        idx = self.rng.choice(len(prob), self.num, p=prob)
        u = self.rng.random((self.num, 1))
        v = self.rng.random((self.num, 1))
        flip = (u + v > 1)
        u = np.where(flip, 1 - u, u)
        v = np.where(flip, 1 - v, v)
        pts = v0[idx] + u * (v1[idx] - v0[idx]) + v * (v2[idx] - v0[idx])
        up = {'pos': as_tensor(pts.astype(np.float32))}
        if self.include_normals:
            nrm = np.cross(v1[idx] - v0[idx], v2[idx] - v0[idx])
            nrm = nrm / np.maximum(
                np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
            up['normal'] = as_tensor(nrm.astype(np.float32))
        if self.remove_faces:
            up['face'] = None
        return data.replace(num_nodes=self.num, **up)


class GridSampling(BaseTransform):
    """Voxel-grid cluster + mean pooling (reference ``grid_sampling.py``);
    ``y`` by each cluster's majority vote."""

    def __init__(self, size):
        self.size = size

    def __call__(self, data: Data) -> Data:
        pos = host(data.pos)
        size = np.broadcast_to(np.asarray(self.size, np.float64),
                               (pos.shape[-1],))
        cell = np.floor((pos - pos.min(0)) / size).astype(np.int64)
        _, cluster, counts = np.unique(cell, axis=0, return_inverse=True,
                                       return_counts=True)
        k = len(counts)
        new_pos = np.zeros((k, pos.shape[-1]))
        np.add.at(new_pos, cluster, pos)
        new_pos = new_pos / counts[:, None]
        up = {'pos': as_tensor(new_pos.astype(np.float32))}
        if data.x is not None:
            x = host(data.x)
            nx = np.zeros((k, x.shape[-1]))
            np.add.at(nx, cluster, x)
            up['x'] = as_tensor((nx / counts[:, None]).astype(np.float32))
        if 'y' in data.keys() and data.y is not None:
            y = host(data.y)
            c = int(y.max()) + 1
            votes = np.zeros((k, c), np.int64)
            np.add.at(votes, (cluster, y), 1)
            up['y'] = as_tensor(votes.argmax(-1))
        if data.edge_index is not None:
            coo = _coo(data)
            new_coo = cluster[coo]
            keep = new_coo[0] != new_coo[1]
            from ..utils.coalesce import coalesce
            new_coo = coalesce(new_coo[:, keep], num_nodes=k)
            up['edge_index'] = as_tensor(new_coo.astype(np.int32))
        return data.replace(num_nodes=k, **up)
