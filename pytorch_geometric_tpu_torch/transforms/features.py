"""Feature transforms and positional encodings.

Counterpart of ``pytorch_geometric_tpu/transforms/features.py`` (reference
``normalize_features.py``, ``svd_feature_reduction.py``,
``one_hot_degree.py``, ``target_indegree.py``, ``local_degree_profile.py``,
``constant.py``, ``add_positional_encoding.py``,
``feature_propagation.py``). Host numpy, as in the JAX package, and the
same arithmetic, so the results are bitwise the JAX package's; the new
fields are CPU tensors with the dtypes ``jnp.asarray`` gives
(:func:`..data.data.as_tensor`). ``FeaturePropagation`` diffuses with the
port's ``gcn_norm`` and ``scatter`` on CPU tensors.
"""

from typing import Optional

import numpy as np
import torch

from .base import BaseTransform
from ..data import Data
from ..data.data import as_tensor, host


def _coo(data) -> np.ndarray:
    return host(data.edge_index)


class NormalizeFeatures(BaseTransform):
    """Row-normalise attributes to sum 1 (reference
    ``normalize_features.py``): shift by the global min, divide by the row
    sums clamped to at least 1."""

    def __init__(self, attrs=('x',)):
        self.attrs = attrs

    def __call__(self, data: Data) -> Data:
        up = {}
        for k in self.attrs:
            v = data[k]
            if v is None:
                continue
            v = host(v).astype(np.float32)
            if v.size:
                v = v - v.min()
            s = v.sum(-1, keepdims=True)
            up[k] = as_tensor(v / np.maximum(s, 1.0))
        return data.replace(**up)


class SVDFeatureReduction(BaseTransform):
    """Dimensionality reduction by truncated SVD (reference
    ``svd_feature_reduction.py``)."""

    def __init__(self, out_channels: int):
        self.out_channels = out_channels

    def __call__(self, data: Data) -> Data:
        x = host(data.x)
        if x.shape[-1] <= self.out_channels:
            return data
        u, s, _ = np.linalg.svd(x, full_matrices=False)
        x = u[:, :self.out_channels] * s[:self.out_channels]
        return data.replace(x=as_tensor(x.astype(np.float32)))


class Constant(BaseTransform):
    """Append a constant feature (reference ``constant.py``)."""

    def __init__(self, value: float = 1.0, cat: bool = True):
        self.value = value
        self.cat = cat

    def __call__(self, data: Data) -> Data:
        c = np.full((data.num_nodes, 1), self.value, np.float32)
        if data.x is not None and self.cat:
            x = np.concatenate([host(data.x), c], -1)
        else:
            x = c
        return data.replace(x=as_tensor(x))


class OneHotDegree(BaseTransform):
    """Append the one-hot (in-)degree, capped at ``max_degree`` (reference
    ``one_hot_degree.py``)."""

    def __init__(self, max_degree: int, in_degree: bool = False,
                 cat: bool = True):
        self.max_degree = max_degree
        self.in_degree = in_degree
        self.cat = cat

    def __call__(self, data: Data) -> Data:
        coo = _coo(data)
        idx = coo[1] if self.in_degree else coo[0]
        deg = np.minimum(np.bincount(idx, minlength=data.num_nodes),
                         self.max_degree)
        oh = np.eye(self.max_degree + 1, dtype=np.float32)[deg]
        if data.x is not None and self.cat:
            oh = np.concatenate([host(data.x), oh], -1)
        return data.replace(x=as_tensor(oh))


class TargetIndegree(BaseTransform):
    """Edge attribute = the destination's in-degree, divided by the largest
    with ``norm`` (reference ``target_indegree.py``)."""

    def __init__(self, norm: bool = True, cat: bool = True):
        self.norm = norm
        self.cat = cat

    def __call__(self, data: Data) -> Data:
        coo = _coo(data)
        deg = np.bincount(coo[1], minlength=data.num_nodes).astype(
            np.float32)
        if self.norm and deg.max() > 0:
            deg = deg / deg.max()
        ea = deg[coo[1]][:, None]
        if data.edge_attr is not None and self.cat:
            ea = np.concatenate([host(data.edge_attr), ea], -1)
        return data.replace(edge_attr=as_tensor(ea))


class LocalDegreeProfile(BaseTransform):
    """Append ``[deg, min, max, mean, std]`` of the neighbours' degrees
    (reference ``local_degree_profile.py``): ``deg`` counts each node's
    edges as source (row), the neighbour degrees ``deg[col]`` are
    aggregated onto the row."""

    def __call__(self, data: Data) -> Data:
        n = data.num_nodes
        coo = _coo(data)
        deg = np.bincount(coo[0], minlength=n).astype(np.float32)
        nd = deg[coo[1]]
        mn = np.full(n, np.inf, np.float32)
        mx = np.full(n, -np.inf, np.float32)
        np.minimum.at(mn, coo[0], nd)
        np.maximum.at(mx, coo[0], nd)
        s = np.zeros(n, np.float32)
        np.add.at(s, coo[0], nd)
        cnt = np.maximum(deg, 1)
        mean = s / cnt
        s2 = np.zeros(n, np.float32)
        np.add.at(s2, coo[0], nd * nd)
        var = np.maximum(s2 / cnt - mean ** 2, 0)
        mn[~np.isfinite(mn)] = 0
        mx[~np.isfinite(mx)] = 0
        prof = np.stack([deg, mn, mx, mean, np.sqrt(var)], -1)
        if data.x is not None:
            prof = np.concatenate([host(data.x), prof], -1)
        return data.replace(x=as_tensor(prof))


class AddLaplacianEigenvectorPE(BaseTransform):
    """The ``k`` smallest nontrivial eigenvectors of ``L = I - D^-1/2 A
    D^-1/2`` (reference ``add_positional_encoding.py``): out-degree, the
    graph as it is (no symmetrisation), self loops dropped, float64. With
    ``is_undirected`` ``eigh``; else the general ``eig``, its vectors sorted
    by eigenvalue. The signs are numpy's (the reference draws random signs),
    so the encoding is deterministic. Stored under ``attr_name``, or
    appended to ``x`` when it is None."""

    def __init__(self, k: int,
                 attr_name: Optional[str] = 'laplacian_eigenvector_pe',
                 is_undirected: bool = False):
        self.k = k
        self.attr_name = attr_name
        self.is_undirected = is_undirected

    def __call__(self, data: Data) -> Data:
        n = data.num_nodes
        coo = _coo(data)
        w = (host(data.edge_weight).astype(np.float64)
             if data.edge_weight is not None
             else np.ones(coo.shape[1], np.float64))
        keep = coo[0] != coo[1]
        a = np.zeros((n, n), np.float64)
        np.add.at(a, (coo[0][keep], coo[1][keep]), w[keep])
        deg = a.sum(1)
        dis = np.where(deg > 0, 1 / np.sqrt(np.maximum(deg, 1e-12)), 0)
        lap = np.eye(n) - dis[:, None] * a * dis[None, :]
        if self.is_undirected:
            vals, vecs = np.linalg.eigh(lap)
        else:
            vals, vecs = np.linalg.eig(lap)
            vecs = np.real(vecs[:, vals.argsort()])
        pe = np.real(vecs[:, 1:self.k + 1])
        if pe.shape[1] < self.k:
            pe = np.pad(pe, ((0, 0), (0, self.k - pe.shape[1])))
        pe = pe.astype(np.float32)
        if self.attr_name:
            return data.replace(**{self.attr_name: as_tensor(pe)})
        return data.replace(x=as_tensor(np.concatenate([host(data.x), pe],
                                                       -1)))


class AddRandomWalkPE(BaseTransform):
    """Random-walk landing probabilities ``diag(P^k)``, ``k = 1 ..
    walk_length`` (reference ``add_positional_encoding.py``), float64 on
    the host: a node's out-degree counts duplicate edges, while its dense
    row entry is assigned ``1 / deg`` (a duplicate overwrites, it does not
    add)."""

    def __init__(self, walk_length: int,
                 attr_name: Optional[str] = 'random_walk_pe'):
        self.walk_length = walk_length
        self.attr_name = attr_name

    def __call__(self, data: Data) -> Data:
        n = data.num_nodes
        coo = _coo(data)
        deg = np.bincount(coo[0], minlength=n).astype(np.float64)
        p = np.zeros((n, n), np.float64)
        p[coo[0], coo[1]] = 1.0 / np.maximum(deg, 1)[coo[0]]
        pk = p.copy()
        pes = [np.diag(pk)]
        for _ in range(self.walk_length - 1):
            pk = pk @ p
            pes.append(np.diag(pk))
        pe = np.stack(pes, -1).astype(np.float32)
        return data.replace(**{self.attr_name: as_tensor(pe)})


class FeaturePropagation(BaseTransform):
    """Fill missing features by diffusion (reference
    ``feature_propagation.py``): ``num_iterations`` rounds of ``x <- D^-1/2
    A D^-1/2 x`` (no self loops), the known entries reset after each.
    ``missing_mask`` given, else ``data[missing_mask_key]``, else the NaNs
    of ``x``."""

    def __init__(self, missing_mask=None, num_iterations: int = 40,
                 missing_mask_key: str = 'missing_mask'):
        self.missing_mask = missing_mask
        self.key = missing_mask_key
        self.num_iterations = num_iterations

    def __call__(self, data: Data) -> Data:
        from ..nn.conv.gcn_conv import gcn_norm
        from ..ops import scatter
        n = data.num_nodes
        miss = (self.missing_mask if self.missing_mask is not None
                else data[self.key])
        miss = host(miss) if miss is not None else np.isnan(host(data.x))
        x0 = torch.from_numpy(
            np.nan_to_num(host(data.x)).astype(np.float32))
        coo, w = gcn_norm(as_tensor(_coo(data)), None, n,
                          add_self_loops=False)
        known = torch.from_numpy(~np.asarray(miss, bool))
        src = coo[0].long().clamp(max=n - 1)
        dst = coo[1].long().clamp(max=n - 1)
        out = x0
        for _ in range(self.num_iterations):
            out = scatter(out[src] * w[:, None], dst, n, 'sum')
            out = torch.where(known, x0, out)
        return data.replace(x=out)
