"""The port's ``utils/coalesce.py`` and ``transforms/geometric.py`` against
the JAX package's, on the CPU: the same numpy point clouds, meshes and
edge lists through both, every output held bitwise (``assert_array_equal``,
dtype included). The seeded transforms run three times in a row from one
seed, so their generators' streams are held too. Point clouds hold
duplicated points and the edge lists duplicate edges and self loops."""

import importlib

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.transforms import geometric as jg
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.transforms import geometric as tg

# the packages' ``utils.coalesce`` name the function; these are the modules
jc = importlib.import_module('pytorch_geometric_tpu.utils.coalesce')
tc = importlib.import_module('pytorch_geometric_tpu_torch.utils.coalesce')

N, E = 30, 90


def _edges(seed, n=N, e=E):
    rng = np.random.default_rng(seed)
    coo = rng.integers(0, n, (2, e))
    coo[:, :8] = coo[:, 8:16]              # duplicate edges
    coo[1, 16:20] = coo[0, 16:20]          # self loops
    return coo.astype(np.int32)


def _same(got, ref, what=''):
    if isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _same(g, r, f'{what}[{i}]')
        return
    if isinstance(ref, (bool, np.bool_)):
        assert got == ref and type(got) is type(ref), what
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _attr(seed, dtype, e=E, width=3):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == 'f':
        return rng.standard_normal((e, width)).astype(dtype)
    return rng.integers(-50, 50, (e, width)).astype(dtype)


# -- utils/coalesce.py --------------------------------------------------------
@pytest.mark.parametrize('form', ['numpy', 'tensor', 'EdgeIndex'])
@pytest.mark.parametrize('by_row', [True, False])
def test_sort_edge_index_matches_jax(by_row, form):
    coo, attr = _edges(1), _attr(2, np.float32)
    arg = {'numpy': coo, 'tensor': torch.from_numpy(coo),
           'EdgeIndex': EdgeIndex(coo, (N, N), device='cpu')}[form]
    _same(tc.sort_edge_index(arg, sort_by_row=by_row),
          jc.sort_edge_index(coo, sort_by_row=by_row))
    _same(tc.sort_edge_index(arg, torch.from_numpy(attr), by_row),
          jc.sort_edge_index(coo, attr, by_row))


@pytest.mark.parametrize('reduce', ['sum', 'add', 'mean', 'min', 'max'])
@pytest.mark.parametrize('dtype', [np.float32, np.float64, np.int32])
def test_coalesce_matches_jax(reduce, dtype):
    coo, attr = _edges(3), _attr(4, dtype)
    _same(tc.coalesce(torch.from_numpy(coo), torch.from_numpy(attr), N,
                      reduce),
          jc.coalesce(coo, attr, N, reduce), reduce)


def test_coalesce_lists_and_defaults_match_jax():
    coo = _edges(5)
    attrs = [_attr(6, np.float32), _attr(7, np.int32, width=1)[:, 0]]
    _same(tc.coalesce(coo), jc.coalesce(coo))
    _same(tc.coalesce(coo, num_nodes=N + 5), jc.coalesce(coo, num_nodes=N + 5))
    for reduce in ('sum', 'mean', 'max'):
        _same(tc.coalesce(coo, [torch.from_numpy(a) for a in attrs], N,
                          reduce), jc.coalesce(coo, attrs, N, reduce), reduce)
    with pytest.raises(ValueError, match='Unknown reduce'):
        tc.coalesce(coo, attrs[0], N, 'prod')
    empty = np.zeros((2, 0), np.int32)
    _same(tc.coalesce(empty), jc.coalesce(empty))


def test_undirected_and_isolated_match_jax():
    coo, attr = _edges(8), _attr(9, np.float32)
    _same(tc.to_undirected(coo), jc.to_undirected(coo))
    _same(tc.to_undirected(coo, torch.from_numpy(attr), N, 'mean'),
          jc.to_undirected(coo, attr, N, 'mean'))
    _same(tc.to_undirected(coo, [attr, attr[:, 0]], N, 'max'),
          jc.to_undirected(coo, [attr, attr[:, 0]], N, 'max'))
    und = jc.to_undirected(coo)
    for e in (coo, und):
        _same(tc.is_undirected(torch.from_numpy(e)), jc.is_undirected(e))
    assert tc.is_undirected(und) and not tc.is_undirected(coo)
    # nodes 25.. appear only in self loops or not at all
    sparse = coo.copy()
    sparse[sparse >= 25] = 3
    sparse[:, -3:] = [[27, 28, 28], [27, 28, 28]]
    for e in (coo, sparse):
        _same(tc.contains_isolated_nodes(e, N),
              jc.contains_isolated_nodes(e, N))
        _same(tc.remove_isolated_nodes(torch.from_numpy(e), N),
              jc.remove_isolated_nodes(e, N))


# -- transforms/geometric.py --------------------------------------------------
def _cloud(seed, n=N, dim=3):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, dim)).astype(np.float32)
    pos[:4] = pos[4:8]                     # duplicated points
    return pos


def _mesh(seed):
    """A closed octahedron-like mesh: 6 vertices, 8 triangles, jittered."""
    rng = np.random.default_rng(seed)
    pos = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                    [0, 0, -1]], np.float32)
    pos += 0.1 * rng.standard_normal(pos.shape).astype(np.float32)
    face = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5],
                     [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32).T
    return pos, face


def _fields(seed, dim=3, edges=True, extra=True):
    rng = np.random.default_rng(seed)
    f = {'pos': _cloud(seed, dim=dim)}
    if edges:
        f['edge_index'] = _edges(seed + 1)
    if extra:
        f['x'] = rng.standard_normal((N, 5)).astype(np.float32)
        f['y'] = rng.integers(0, 4, N).astype(np.int32)
        f['edge_attr'] = rng.random((E, 2)).astype(np.float32)
    return f


def _both(fields, **kw):
    return (JData(**fields, **kw),
            Data(**{k: v.copy() for k, v in fields.items()}, **kw))


def _same_data(jd, td, what):
    assert sorted(jd.keys()) == sorted(td.keys()), (what, jd.keys(),
                                                   td.keys())
    assert jd.num_nodes == td.num_nodes, what
    for k in jd.keys():
        got = td[k]
        assert isinstance(got, torch.Tensor) and got.device.type == 'cpu', k
        _same(got, jd[k], f'{what}: {k}')


CASES = {
    'Center': lambda m: m.Center(),
    'NormalizeScale': lambda m: m.NormalizeScale(),
    'KNNGraph': lambda m: m.KNNGraph(k=5),
    'KNNGraph loop undirected': lambda m: m.KNNGraph(k=4, loop=True,
                                                     force_undirected=True),
    'RadiusGraph': lambda m: m.RadiusGraph(1.2, max_num_neighbors=3),
    'RadiusGraph loop': lambda m: m.RadiusGraph(0.9, loop=True),
    'Distance': lambda m: m.Distance(),
    'Distance raw alone': lambda m: m.Distance(norm=False, cat=False),
    'Cartesian': lambda m: m.Cartesian(),
    'Cartesian raw alone': lambda m: m.Cartesian(norm=False, cat=False),
    'Polar': lambda m: m.Polar(),
    'Polar raw': lambda m: m.Polar(norm=False),
    'Spherical': lambda m: m.Spherical(),
    'Spherical raw alone': lambda m: m.Spherical(norm=False, cat=False),
    'RandomJitter': lambda m: m.RandomJitter(0.05, seed=11),
    'RandomFlip': lambda m: m.RandomFlip(axis=1, seed=12),
    'RandomRotate x': lambda m: m.RandomRotate(40, axis=0, seed=13),
    'RandomRotate y': lambda m: m.RandomRotate(40, axis=1, seed=13),
    'RandomRotate z': lambda m: m.RandomRotate(180, axis=2, seed=14),
    'RandomScale': lambda m: m.RandomScale((0.8, 1.2), seed=15),
    'RandomShear': lambda m: m.RandomShear(0.2, seed=16),
    'GridSampling': lambda m: m.GridSampling(0.7),
    'GridSampling per axis': lambda m: m.GridSampling([0.5, 1.0, 0.8]),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_transform_matches_jax(name):
    """Three calls in a row (a seeded transform's stream), each on a fresh
    cloud."""
    jt, tt = CASES[name](jg), CASES[name](tg)
    for rep in range(3):
        jd, td = _both(_fields(20 + rep), num_nodes=N)
        _same_data(jt(jd), tt(td), f'{name} call {rep}')


@pytest.mark.parametrize('name', ['Center', 'NormalizeScale', 'Polar',
                                  'RandomRotate z', 'RandomShear',
                                  'RandomFlip', 'GridSampling'])
def test_transform_2d_and_bare_match_jax(name):
    """Planar clouds, and clouds without ``x``, ``y`` or ``edge_attr``."""
    jt, tt = CASES[name](jg), CASES[name](tg)
    for rep in range(2):
        jd, td = _both(_fields(30 + rep, dim=2, extra=False), num_nodes=N)
        _same_data(jt(jd), tt(td), f'{name} call {rep}')


@pytest.mark.parametrize('normals', [False, True])
@pytest.mark.parametrize('remove', [True, False])
def test_sample_points_matches_jax(normals, remove):
    pos, face = _mesh(40)
    jt = jg.SamplePoints(200, remove_faces=remove, include_normals=normals,
                         seed=41)
    tt = tg.SamplePoints(200, remove_faces=remove, include_normals=normals,
                         seed=41)
    for rep in range(3):
        jd, td = _both({'pos': pos, 'face': face}, num_nodes=6)
        _same_data(jt(jd), tt(td), f'call {rep}')


def test_sample_points_then_normalize_takes_tensors():
    """The path through which ``chip_smoke.py`` draws its clouds: mesh
    fields already tensors, NormalizeScale then SamplePoints."""
    pos, face = _mesh(42)
    jd = jg.SamplePoints(64, seed=3)(jg.NormalizeScale()(
        JData(pos=pos, face=face, num_nodes=6)))
    td = tg.SamplePoints(64, seed=3)(tg.NormalizeScale()(
        Data(pos=torch.from_numpy(pos), face=torch.from_numpy(face),
             num_nodes=6)))
    _same_data(jd, td, 'chain')
    assert 'face' not in td.keys() and td.num_nodes == 64
