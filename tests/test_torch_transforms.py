"""The port's ``transforms`` (``base.py`` and ``features.py``) against the
JAX package's, on the CPU: the same numpy graph through both, every output
field held bitwise (``assert_array_equal``, dtype included). The graphs
hold duplicate edges (``AddRandomWalkPE`` assigns, it does not add) and
self loops (``AddLaplacianEigenvectorPE`` drops them); the directed graph
takes the Laplacian's general ``eig`` branch, the undirected one
``eigh``."""

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu import transforms as jt
from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu_torch import transforms as tt
from pytorch_geometric_tpu_torch.data import Data

N, E, F_IN = 24, 70, 7


def _graph(seed, undirected=False, weighted=False):
    rng = np.random.default_rng(seed)
    coo = rng.integers(0, N, (2, E))
    coo[:, :6] = coo[:, 6:12]              # duplicate edges
    coo[1, 12:15] = coo[0, 12:15]          # self loops
    if undirected:
        coo = np.unique(np.concatenate([coo, coo[::-1]], 1), axis=1)
    fields = dict(x=rng.standard_normal((N, F_IN)).astype(np.float32),
                  edge_index=coo.astype(np.int32),
                  edge_attr=rng.random((coo.shape[1], 2)).astype(np.float32))
    if weighted:
        fields['edge_weight'] = rng.random(coo.shape[1]).astype(np.float32)
    return fields


def _both(fields):
    return (JData(num_nodes=N, **fields),
            Data(num_nodes=N, **{k: v.copy() for k, v in fields.items()}))


def _same(jout, tout, keys):
    for k in keys:
        ref = np.asarray(jout[k])
        got = tout[k]
        assert isinstance(got, torch.Tensor) and got.device.type == 'cpu', k
        got = got.numpy()
        assert got.dtype == ref.dtype, (k, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=k)


def _missing(seed):
    fields = _graph(seed)
    miss = np.random.default_rng(seed + 1).random((N, F_IN)) < 0.3
    fields['x'] = np.where(miss, np.nan, fields['x']).astype(np.float32)
    return fields, miss


CASES = {
    'NormalizeFeatures': (lambda m: m.NormalizeFeatures(), ['x']),
    'SVDFeatureReduction': (lambda m: m.SVDFeatureReduction(4), ['x']),
    'SVDFeatureReduction wide': (lambda m: m.SVDFeatureReduction(9), ['x']),
    'Constant': (lambda m: m.Constant(0.5), ['x']),
    'Constant alone': (lambda m: m.Constant(2.0, cat=False), ['x']),
    'OneHotDegree': (lambda m: m.OneHotDegree(4), ['x']),
    'OneHotDegree in': (lambda m: m.OneHotDegree(6, in_degree=True,
                                                 cat=False), ['x']),
    'TargetIndegree': (lambda m: m.TargetIndegree(), ['edge_attr']),
    'TargetIndegree raw': (lambda m: m.TargetIndegree(norm=False,
                                                      cat=False),
                           ['edge_attr']),
    'LocalDegreeProfile': (lambda m: m.LocalDegreeProfile(), ['x']),
    'AddRandomWalkPE': (lambda m: m.AddRandomWalkPE(20), ['random_walk_pe']),
    'AddRandomWalkPE named': (lambda m: m.AddRandomWalkPE(3, 'pe'), ['pe']),
    'AddLaplacianEigenvectorPE': (lambda m: m.AddLaplacianEigenvectorPE(5),
                                  ['laplacian_eigenvector_pe']),
    'AddLaplacianEigenvectorPE into x': (
        lambda m: m.AddLaplacianEigenvectorPE(3, attr_name=None), ['x']),
    'Compose': (lambda m: m.Compose([m.Constant(1.0), m.LocalDegreeProfile(),
                                     m.AddRandomWalkPE(4)]),
                ['x', 'random_walk_pe']),
}


@pytest.mark.parametrize('name', sorted(CASES))
@pytest.mark.parametrize('undirected', [False, True])
def test_transform_is_bitwise_the_jax_package(name, undirected):
    make, keys = CASES[name]
    jd, td = _both(_graph(3, undirected))
    _same(make(jt)(jd), make(tt)(td), keys)


def test_laplacian_pe_weighted_and_both_branches_bitwise():
    """Edge weights, ``is_undirected`` (``eigh``) on an undirected graph,
    the general ``eig`` on a directed one, and k past N - 1 (zero
    padded)."""
    for undirected in (False, True):
        jd, td = _both(_graph(5, undirected, weighted=True))
        for k in (4, N + 2):
            make = (lambda m, k=k: m.AddLaplacianEigenvectorPE(
                k, is_undirected=undirected))
            _same(make(jt)(jd), make(tt)(td), ['laplacian_eigenvector_pe'])


def test_random_walk_pe_assigns_duplicates():
    """A doubled edge counts twice in the degree but is written once: the
    landing probability of a 2-cycle with one edge doubled."""
    coo = np.array([[0, 0, 0, 1], [1, 1, 2, 0]], np.int32)
    out = tt.AddRandomWalkPE(2)(Data(edge_index=coo, num_nodes=3))
    pe = out.random_walk_pe.numpy()
    # P[0, 1] = 1/3 (assigned once, deg 3), P[1, 0] = 1
    np.testing.assert_allclose(pe[:, 1], [1 / 3, 1 / 3, 0], rtol=1e-6)
    assert np.all(pe[:, 0] == 0)


@pytest.mark.parametrize('given', ['nan', 'mask', 'key'])
def test_feature_propagation_is_bitwise_the_jax_package(given):
    fields, miss = _missing(11)
    if given == 'key':
        fields['missing_mask'] = miss
    jd, td = _both(fields)
    kw = {'missing_mask': miss} if given == 'mask' else {}
    jout = jt.FeaturePropagation(num_iterations=12, **kw)(jd)
    tout = tt.FeaturePropagation(num_iterations=12, **kw)(td)
    _same(jout, tout, ['x'])


def test_transforms_exports_and_repr():
    assert set(tt.__all__) <= set(jt.__all__)
    c = tt.Compose([tt.Constant(), tt.NormalizeFeatures()])
    assert repr(c) == repr(jt.Compose([jt.Constant(), jt.NormalizeFeatures()]))
    with pytest.raises(NotImplementedError):
        tt.BaseTransform()(None)
