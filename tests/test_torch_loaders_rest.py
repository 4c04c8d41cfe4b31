"""The rest of the port's loaders against the JAX package's, on the CPU:
ShaDow, ``RandomNodeLoader``, ``ImbalancedSampler`` and
``DynamicBatchSampler`` (``loader/graph_saint.py``), ``ppr``
(``utils/extra.py``), both IBMB loaders in each batch order
(``loader/ibmb.py``), the list loaders and mixins
(``loader/list_loader.py``), ``TemporalData`` and ``TemporalDataLoader``
(``data/temporal.py``, ``loader/temporal.py``) and the legacy
``NeighborSampler`` (``loader/legacy.py``, native and numpy, each against
the JAX package's sampler of its kind). The same inputs, made from a numpy
seed, go into both packages; every batch, index and value must be equal,
bit for bit and dtype for dtype. Also: the ``__init__``\\ s export what the
JAX package's export for these names."""

import numpy as np
import pytest
import torch

import pytorch_geometric_tpu.csrc as jcsrc
import pytorch_geometric_tpu.data as jdata_pkg
import pytorch_geometric_tpu.loader as jloader
import pytorch_geometric_tpu.utils as jutils
from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import TemporalData as JTemporalData
from pytorch_geometric_tpu_torch import csrc
from pytorch_geometric_tpu_torch import data as data_pkg
from pytorch_geometric_tpu_torch import loader
from pytorch_geometric_tpu_torch import utils
from pytorch_geometric_tpu_torch.data import Data, TemporalData

N, E = 120, 600


def _eq(got, ref, what=''):
    if hasattr(ref, 'sparse_size'):
        # a batch's EdgeIndex: its size and COO
        assert tuple(got.sparse_size) == tuple(ref.sparse_size), what
        got, ref = got.coo, ref.coo
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (
        what, got.dtype, ref.dtype, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _data_equal(got, ref):
    assert sorted(got.keys()) == sorted(ref.keys())
    assert got.num_nodes == ref.num_nodes
    for k in ref.keys():
        _eq(got[k], ref[k], k)


def _graph(seed=0, n=N, e=E):
    rng = np.random.default_rng(seed)
    coo = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    fields = dict(x=rng.standard_normal((n, 4)).astype(np.float32),
                  edge_index=coo.astype(np.int32), y=rng.integers(0, 5, n),
                  train_mask=rng.random(n) < 0.5)
    return JData(num_nodes=n, **fields), Data(num_nodes=n, **fields)


@pytest.mark.parametrize('depth,num_neighbors,batch_size,shuffle', [
    (2, 3, 5, False), (3, 2, 7, True)])
def test_shadow_matches_jax(depth, num_neighbors, batch_size, shuffle):
    jd, d = _graph(1)
    idx = np.random.default_rng(2).random(N) < 0.3
    kw = dict(depth=depth, num_neighbors=num_neighbors, node_idx=idx,
              batch_size=batch_size, shuffle=shuffle, seed=4)
    got = list(loader.ShaDowKHopSampler(d, **kw))
    ref = list(jloader.ShaDowKHopSampler(jd, **kw))
    assert len(got) == len(ref) == len(loader.ShaDowKHopSampler(d, **kw))
    for g, r in zip(got, ref):
        _data_equal(g, r)


@pytest.mark.parametrize('num_parts,shuffle', [(4, False), (7, True)])
def test_random_node_loader_matches_jax(num_parts, shuffle):
    jd, d = _graph(3)
    got = list(loader.RandomNodeLoader(d, num_parts, shuffle, seed=1))
    ref = list(jloader.RandomNodeLoader(jd, num_parts, shuffle, seed=1))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _data_equal(g, r)


@pytest.mark.parametrize('num_samples', [None, 50])
def test_imbalanced_sampler_matches_jax(num_samples):
    y = np.random.default_rng(5).choice(4, 200, p=[0.7, 0.2, 0.07, 0.03])
    s = loader.ImbalancedSampler(torch.from_numpy(y), num_samples, seed=3)
    js = jloader.ImbalancedSampler(y, num_samples, seed=3)
    _eq(s.weights, js.weights)
    assert len(s) == len(js)
    for _ in range(2):
        _eq(np.array(list(s)), np.array(list(js)))


@pytest.mark.parametrize('mode,max_num,shuffle', [('node', 40, False),
                                                  ('edge', 70, True)])
def test_dynamic_batch_sampler_matches_jax(mode, max_num, shuffle):
    rng = np.random.default_rng(6)
    sizes = rng.integers(3, 20, 30)
    graphs = [(rng.integers(0, n, (2, 2 * n)), n) for n in sizes]
    ds = [Data(edge_index=c, num_nodes=int(n)) for c, n in graphs]
    jds = [JData(edge_index=c, num_nodes=int(n)) for c, n in graphs]
    got = list(loader.DynamicBatchSampler(ds, max_num, mode, shuffle, 2))
    ref = list(jloader.DynamicBatchSampler(jds, max_num, mode, shuffle, 2))
    assert got == ref and len(got) > 1


@pytest.mark.parametrize('alpha,eps', [(0.15, 1e-4), (0.3, 1e-3)])
def test_ppr_matches_jax(alpha, eps):
    coo = np.random.default_rng(7).integers(0, 60, (2, 300))
    got = utils.ppr(torch.from_numpy(coo), 60, alpha, eps)
    ref = jutils.ppr(coo, 60, alpha, eps)
    _eq(got[0], ref[0], 'coo')
    _eq(got[1], ref[1], 'values')
    assert utils.get_ppr is utils.ppr


def _ibmb_batches_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _data_equal(g, r)


@pytest.mark.parametrize('order', ['order', 'sample', 'rand'])
def test_ibmb_node_loader_matches_jax(order):
    jd, d = _graph(8, n=90, e=450)
    outs = np.random.default_rng(9).choice(90, 40, replace=False)
    kw = dict(batch_order=order, output_indices=outs,
              num_nodes_per_batch=8, num_auxiliary_nodes=6, seed=2)
    s = loader.IBMBNodeLoader(d, **kw)
    js = jloader.IBMBNodeLoader(jd, **kw)
    assert len(s) == len(js)
    for (o, a), (jo, ja) in zip(s._pairs, js._pairs):
        _eq(o, jo, 'outputs')
        _eq(a, ja, 'auxiliary')
    for _ in range(2):
        _ibmb_batches_equal(list(s), list(js))


@pytest.mark.parametrize('order', ['order', 'sample', 'rand'])
def test_ibmb_batch_loader_matches_jax(order):
    jd, d = _graph(10, n=150, e=700)
    train = np.random.default_rng(11).random(150) < 0.5
    kw = dict(batch_order=order, num_partitions=5, input_nodes=train,
              batch_expand_ratio=0.5, approximate_ppr_iterations=20,
              seed=1)
    s = loader.IBMBBatchLoader(d, **kw)
    js = jloader.IBMBBatchLoader(jd, **kw)
    assert len(s) == len(js)
    for (o, a), (jo, ja) in zip(s._pairs, js._pairs):
        _eq(o, jo, 'outputs')
        _eq(a, ja, 'auxiliary')
    for _ in range(2):
        _ibmb_batches_equal(list(s), list(js))


def test_list_loaders_match_jax():
    rng = np.random.default_rng(12)
    graphs = [dict(x=rng.standard_normal((6, 3)).astype(np.float32),
                   adj=(rng.random((6, 6)) < 0.4).astype(np.float32),
                   y=rng.integers(0, 2, 6)) for _ in range(11)]
    ds = [Data(num_nodes=6, **g) for g in graphs]
    jds = [JData(num_nodes=6, **g) for g in graphs]
    for shuffle in (False, True):
        dl = loader.DataListLoader(ds, batch_size=4, shuffle=shuffle,
                                   seed=3)
        jdl = jloader.DataListLoader(jds, batch_size=4, shuffle=shuffle,
                                     seed=3)
        assert len(dl) == len(jdl) == 3
        got = [[ds.index(g) for g in b] for b in dl]
        ref = [[jds.index(g) for g in b] for b in jdl]
        assert got == ref
        dd = loader.DenseDataLoader(ds, batch_size=4, shuffle=shuffle,
                                    seed=3)
        jdd = jloader.DenseDataLoader(jds, batch_size=4, shuffle=shuffle,
                                      seed=3)
        assert len(dd) == len(jdd)
        for _ in range(2):
            for g, r in zip(list(dd), list(jdd)):
                _data_equal(g, r)
                assert g.x.shape[0] in (4, 3)
    z = loader.ZipLoader([[1, 2, 3], 'ab'])
    assert len(z) == 2 and list(z) == list(jloader.ZipLoader([[1, 2, 3],
                                                              'ab']))
    for mixin, call in ((loader.AffinityMixin, 'enable_cpu_affinity'),
                        (loader.MultithreadingMixin,
                         'enable_multithreading')):
        with getattr(mixin(), call)():
            pass


def _events(seed, n=40, m=23):
    rng = np.random.default_rng(seed)
    return dict(src=rng.integers(0, n, m), dst=rng.integers(0, n, m),
                t=np.sort(rng.integers(0, 1000, m)),
                msg=rng.standard_normal((m, 3)).astype(np.float32),
                y=rng.integers(0, 2, m))


def _temporal_equal(got, ref):
    for k in ('src', 'dst', 't', 'msg', 'y'):
        _eq(getattr(got, k), getattr(ref, k), k)
    assert got.num_events == ref.num_events == len(got)
    assert got.num_nodes == ref.num_nodes


def test_temporal_data_and_loader_match_jax():
    ev = _events(13)
    td, jtd = TemporalData(**ev), JTemporalData(**ev)
    _temporal_equal(td, jtd)
    _temporal_equal(td[3:9], jtd[3:9])
    for g, r in zip(td.train_val_test_split(0.2, 0.1),
                    jtd.train_val_test_split(0.2, 0.1)):
        _temporal_equal(g, r)
    no_msg = TemporalData(ev['src'], ev['dst'], ev['t'])
    assert no_msg.msg.shape == (23, 0) and no_msg.y is None
    assert TemporalData(np.zeros(0), np.zeros(0), np.zeros(0)).num_nodes == 0
    for ratio in (0.0, 1.5):
        dl = loader.TemporalDataLoader(td, batch_size=5,
                                       neg_sampling_ratio=ratio, seed=4)
        jdl = jloader.TemporalDataLoader(jtd, batch_size=5,
                                         neg_sampling_ratio=ratio, seed=4)
        assert len(dl) == len(jdl) == 5
        got, ref = list(dl), list(jdl)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _temporal_equal(g, r)
            if ratio:
                _eq(g.neg_dst, r.neg_dst, 'neg_dst')
            else:
                assert not hasattr(g, 'neg_dst')


@pytest.fixture(params=['native', 'numpy'])
def path(request, monkeypatch):
    """Both packages on the native sampler, or both on their numpy one."""
    native = request.param == 'native'
    if native:
        assert jcsrc.WITH_NATIVE_SAMPLER and csrc.WITH_NATIVE_SAMPLER
    monkeypatch.setattr(jcsrc, 'WITH_NATIVE_SAMPLER', native)
    monkeypatch.setattr(csrc, 'WITH_NATIVE_SAMPLER', native)
    return request.param


@pytest.mark.parametrize('sizes,batch_size,shuffle,drop_last', [
    ([4], 10, False, False), ([3, 2], 7, True, False),
    ([5, 3, 2], 16, True, True)])
@pytest.mark.parametrize('as_data', [False, True])
def test_legacy_neighbor_sampler_matches_jax(path, sizes, batch_size,
                                             shuffle, drop_last, as_data):
    jd, d = _graph(14)
    coo = np.asarray(jd.edge_index)
    node_idx = np.random.default_rng(15).random(N) < 0.6
    kw = dict(sizes=sizes, node_idx=node_idx, batch_size=batch_size,
              shuffle=shuffle, drop_last=drop_last, seed=6)
    s = loader.NeighborSampler(d if as_data else torch.tensor(coo), **kw)
    js = jloader.NeighborSampler(jd if as_data else coo, **kw)
    assert len(s) == len(js) and repr(s) == repr(js)
    got, ref = list(s), list(js)
    assert len(got) == len(ref) == len(s)
    for (bs, n_id, adjs), (jbs, jn_id, jadjs) in zip(got, ref):
        assert bs == jbs
        _eq(n_id, jn_id, 'n_id')
        if len(sizes) == 1:
            adjs, jadjs = [adjs], [jadjs]
        assert len(adjs) == len(jadjs) == len(sizes)
        for a, ja in zip(adjs, jadjs):
            assert isinstance(a, loader.EdgeIndexAdj)
            _eq(a.edge_index, ja.edge_index, 'edge_index')
            _eq(a.e_id, ja.e_id, 'e_id')
            assert a.size == ja.size
            assert a.to('cpu') is a


def test_exports_match_jax():
    """Every name the JAX package's ``loader`` exports is exported by the
    port's, and the aliases are the same objects; ``data`` resolves the
    reference's deprecated loader names; ``utils`` and ``nn.conv`` export
    this slice's names."""
    import pytorch_geometric_tpu.nn.conv as jconv
    from pytorch_geometric_tpu_torch.nn import conv
    from pytorch_geometric_tpu_torch.nn import models
    # the port exports one more: the hetero batches' EdgeIndex builder
    assert set(loader.__all__) - set(jloader.__all__) == {
        'batch_edge_index_dict'}
    for name in jloader.__all__:
        assert hasattr(loader, name), name
    assert loader.NodeLoader is loader.NeighborLoader
    assert loader.LinkLoader is loader.LinkNeighborLoader
    for name in jdata_pkg._LOADER_ALIASES:
        assert getattr(data_pkg, name) is getattr(loader, name)
    with pytest.raises(AttributeError):
        data_pkg.NotALoader
    assert 'TemporalData' in data_pkg.__all__
    for name in ('cluster_order', 'ppr', 'get_ppr'):
        assert name in utils.__all__ and name in jutils.__all__
    for name in ('GraphConv', 'ClusterGCNConv'):
        assert name in conv.__all__ and name in jconv.__all__
    assert 'random_walk' in models.__all__
