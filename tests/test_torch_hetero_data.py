"""The port's heterogeneous containers, layouts, samplers and loaders
against the JAX package's, on the CPU, bit for bit and dtype for dtype.

The same seeded numpy graph goes into both packages: ``HeteroData`` and its
``to_homogeneous``; ``HeteroBatch`` both ways, with and without budgets;
the ``DataLoader``'s hetero collation; ``build_typed_layout`` /
``build_ragged_layout``; ``build_hgt_flash_layouts`` (with and without the
source-sorted copy); ``HeteroNeighborSampler`` and ``HGTSampler`` over
several batches in a row (so the random streams are held too), and both
loaders with shuffling and the padded last batch; each sampler on the
native path and on the numpy path, against the JAX package's of the same
path. Also: ``chip_smoke.py``'s copy of the hetero bench's graph builder
against ``benchmarks/hetero_bench.py``'s."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

import pytorch_geometric_tpu.csrc as jcsrc
from pytorch_geometric_tpu.data.hetero_batch import HeteroBatch as JBatch
from pytorch_geometric_tpu.data.hetero_data import HeteroData as JData
from pytorch_geometric_tpu.loader import DataLoader as JDataLoader
from pytorch_geometric_tpu.loader import HeteroNeighborLoader as JLoader
from pytorch_geometric_tpu.loader.hetero_loader import HGTLoader as JHGTLoader
from pytorch_geometric_tpu.ops import build_hgt_flash_layouts as j_layouts
from pytorch_geometric_tpu.ops.grouped import (
    build_ragged_layout as j_ragged, build_typed_layout as j_typed)
from pytorch_geometric_tpu.sampler.base import NodeSamplerInput as JInput
from pytorch_geometric_tpu.sampler.hetero import (
    HGTSampler as JHGTSampler, HeteroNeighborSampler as JSampler)
from pytorch_geometric_tpu_torch import EdgeIndex, csrc
from pytorch_geometric_tpu_torch.data import HeteroBatch, HeteroData
from pytorch_geometric_tpu_torch.data.data import host
from pytorch_geometric_tpu_torch.loader import (DataLoader, HGTLoader,
                                                HeteroNeighborLoader)
from pytorch_geometric_tpu_torch.ops import (build_hgt_flash_layouts,
                                             build_ragged_layout,
                                             build_typed_layout)
from pytorch_geometric_tpu_torch.sampler import (HGTSampler,
                                                 HeteroNeighborSampler,
                                                 NodeSamplerInput)

ROOT = Path(__file__).resolve().parents[1]
NODES = {'paper': 40, 'author': 55, 'institution': 6, 'field': 9}
EDGES = {('author', 'writes', 'paper'): 120,
         ('paper', 'cites', 'paper'): 90,
         ('paper', 'has_topic', 'field'): 70,
         ('author', 'affiliated_with', 'institution'): 30}


def _eq(got, ref, what=''):
    """``got`` (a port tensor, EdgeIndex or array) equals ``ref`` (a JAX or
    numpy array) bit for bit, with the same dtype and shape."""
    g, r = host(got), np.asarray(ref.coo if hasattr(ref, 'coo') else ref)
    assert g.dtype == r.dtype, (what, g.dtype, r.dtype)
    np.testing.assert_array_equal(g, r, err_msg=what)


def _graph(seed=0, scale=1):
    """The MAG-like schema at a tiny size, its reverses added; the same
    arrays go into a JAX and a port ``HeteroData``."""
    rng = np.random.default_rng(seed)
    nodes = {t: n * scale for t, n in NODES.items()}
    arrays = {}
    for (s, r, d), e in EDGES.items():
        coo = np.stack([rng.integers(0, nodes[s], e * scale),
                        rng.integers(0, nodes[d], e * scale)])
        arrays[(s, r, d)] = coo.astype(np.int32)
        if s != d:
            arrays[(d, f'rev_{r}', s)] = coo[::-1].copy()
    x = {t: rng.standard_normal((n, 8)).astype(np.float32)
         for t, n in nodes.items()}
    y = rng.integers(0, 4, nodes['paper']).astype(np.int32)
    out = []
    for cls in (JData, HeteroData):
        d = cls()
        for t in nodes:
            d[t].x = x[t]
        d['paper'].y = y
        for et, coo in arrays.items():
            d[et].edge_index = coo
        out.append(d)
    return out[0], out[1], nodes, arrays


@pytest.fixture(params=['native', 'numpy'])
def path(request, monkeypatch):
    """Both packages on the native sampler, or both on their numpy one."""
    native = request.param == 'native'
    if native:
        assert jcsrc.WITH_NATIVE_SAMPLER and csrc.WITH_NATIVE_SAMPLER
    monkeypatch.setattr(jcsrc, 'WITH_NATIVE_SAMPLER', native)
    monkeypatch.setattr(csrc, 'WITH_NATIVE_SAMPLER', native)
    return request.param


def test_hetero_data_and_to_homogeneous():
    jd, td, nodes, arrays = _graph()
    assert td.node_types == jd.node_types
    assert td.edge_types == jd.edge_types
    assert td.metadata() == jd.metadata()
    assert td.num_nodes_dict() == jd.num_nodes_dict()
    assert td['paper', 'cites', 'paper'].num_edges == 90
    for t in nodes:
        _eq(td.x_dict[t], jd.x_dict[t], t)
    for et in arrays:
        _eq(td.edge_index_dict[et], jd.edge_index_dict[et], str(et))
    assert sorted(td.collect('x')) == sorted(jd.collect('x'))
    # a 2-tuple key names ('src', 'to', 'dst'), as in the JAX package
    e = HeteroData()
    e['a', 'b'].edge_index = np.zeros((2, 3), np.int64)
    assert e.edge_types == [('a', 'to', 'b')]
    jh, th = jd.to_homogeneous(), td.to_homogeneous()
    assert th.num_nodes == jh.num_nodes == sum(nodes.values())
    for k in ('edge_index', 'x', 'node_type', 'edge_type'):
        _eq(th[k], jh[k], k)
    # without the type vectors, and without x when widths differ
    jd['field'].x = np.zeros((nodes['field'], 3), np.float32)
    td['field'].x = np.zeros((nodes['field'], 3), np.float32)
    jh = jd.to_homogeneous(add_node_type=False, add_edge_type=False)
    th = td.to_homogeneous(add_node_type=False, add_edge_type=False)
    assert sorted(th.keys()) == sorted(
        k for k in ('edge_index', 'x', 'node_type', 'edge_type')
        if getattr(jh, k, None) is not None) == ['edge_index']
    _eq(th.edge_index, jh.edge_index)


def _hetero_list(cls, seed, count=3):
    rng = np.random.default_rng(seed)
    out = []
    for g in range(count):
        d = cls()
        na, nb = 3 + g, 5 - g
        d['a'].x = rng.standard_normal((na, 4)).astype(np.float32)
        d['a'].y = rng.integers(0, 3, na).astype(np.int64)
        d['b'].x = rng.standard_normal((nb, 2)).astype(np.float32)
        d['a', 'r', 'b'].edge_index = np.stack(
            [rng.integers(0, na, 4 + g), rng.integers(0, nb, 4 + g)])
        d['a', 'r', 'b'].edge_attr = rng.standard_normal(
            (4 + g, 3)).astype(np.float32)
        d['b', 's', 'b'].edge_index = np.stack(
            [rng.integers(0, nb, 2 + g), rng.integers(0, nb, 2 + g)])
        d.label = np.int64(g)
        out.append(d)
    return out


def _batches_equal(tb, jb):
    assert tb.num_graphs == jb.num_graphs
    assert tb.node_types == jb.node_types
    assert tb.edge_types == jb.edge_types
    for t in jb.node_types:
        assert sorted(tb[t].keys()) == sorted(jb[t].keys()), t
        for k in jb[t].keys():
            _eq(tb[t].get(k), jb[t].get(k), (t, k))
    for et in jb.edge_types:
        assert sorted(tb[et].keys()) == sorted(jb[et].keys()), et
        for k in jb[et].keys():
            _eq(tb[et].get(k), jb[et].get(k), (et, k))
        tei, jei = tb[et].edge_index, jb[et].edge_index
        assert isinstance(tei, EdgeIndex)
        assert tei.sparse_size == tuple(jei.sparse_size)
        assert tei.num_real_edges == int(jei.num_real_edges)
    _eq(tb.label, jb.label, 'label')
    for t, m in jb.node_mask_dict().items():
        _eq(tb.node_mask_dict()[t], m, t)


@pytest.mark.parametrize('padded', [False, True])
def test_hetero_batch_both_ways(padded):
    jl, tl = _hetero_list(JData, 1), _hetero_list(HeteroData, 1)
    kw = {}
    if padded:
        kw = dict(pad_num_nodes={'a': 16, 'b': 13},
                  pad_num_edges={('a', 'r', 'b'): 20, ('b', 's', 'b'): 9})
    jb = JBatch.from_hetero_list(jl, **kw)
    tb = HeteroBatch.from_hetero_list(tl, **kw)
    _batches_equal(tb, jb)
    for tg, jg in zip(tb.to_hetero_list(), jb.to_hetero_list()):
        assert tg.metadata() == jg.metadata()
        for t in jg.node_types:
            for k in jg[t].keys():
                _eq(tg[t].get(k), jg[t].get(k), (t, k))
        for et in jg.edge_types:
            for k in jg[et].keys():
                _eq(tg[et].get(k), jg[et].get(k), (et, k))
        _eq(tg.label, jg.label, 'label')
    with pytest.raises(ValueError, match='too small'):
        HeteroBatch.from_hetero_list(tl, pad_num_nodes={'a': 2})


@pytest.mark.parametrize('pad', [True, False])
def test_dataloader_collates_hetero_graphs(pad):
    jl, tl = _hetero_list(JData, 2, 5), _hetero_list(HeteroData, 2, 5)
    jloader = JDataLoader(jl, batch_size=2, shuffle=True, pad=pad, seed=3)
    tloader = DataLoader(tl, batch_size=2, shuffle=True, pad=pad, seed=3)
    assert len(tloader) == len(jloader) == 3
    for tb, jb in zip(tloader, jloader):
        assert isinstance(tb, HeteroBatch)
        _batches_equal(tb, jb)


def test_typed_and_ragged_layouts():
    rng = np.random.default_rng(4)
    types = rng.integers(0, 5, 57)
    types[types == 3] = 1            # an empty type
    for bucket in (None, 40):
        j, t = j_typed(types, 5, bucket), build_typed_layout(
            types, 5, bucket, device='cpu')
        assert t.bucket == j.bucket
        _eq(t.perm, j.perm, 'perm')
        _eq(t.inv, j.inv, 'inv')
    with pytest.raises(ValueError, match='bucket'):
        build_typed_layout(types, 5, 2, device='cpu')
    j, t = j_ragged(types, 5), build_ragged_layout(types, 5, device='cpu')
    for k in ('order', 'unorder', 'group_sizes'):
        _eq(getattr(t, k), getattr(j, k), k)
    assert t.host_sizes == tuple(np.asarray(j.group_sizes).tolist())


@pytest.mark.parametrize('dual', ['1', '0'])
def test_hgt_flash_layouts(monkeypatch, dual):
    monkeypatch.setenv('PGT_ATTN_BWD_SRC_SORTED', dual)
    _, _, nodes, arrays = _graph(5)
    arrays = dict(arrays)
    # padded edges (both endpoints at the counts) and one relation whose
    # source type has no features: it must drop out of both
    coo = arrays[('author', 'writes', 'paper')]
    arrays[('author', 'writes', 'paper')] = np.concatenate(
        [coo, [[nodes['author']] * 3, [nodes['paper']] * 3]], 1)
    meta = (tuple(nodes), tuple(arrays))
    for feature_types in (None, {'paper', 'author', 'field'}):
        jl = j_layouts(meta, arrays, nodes, chunk=16,
                       feature_types=feature_types)
        tl = build_hgt_flash_layouts(meta, arrays, nodes, chunk=16,
                                     feature_types=feature_types,
                                     device='cpu')
        assert sorted(tl) == sorted(jl)
        for t in jl:
            assert tl[t].e_tot == jl[t].e_tot
            for k in ('s_ch', 'd_ch', 'rel_ch', 's_t', 'd_t', 'rel_t'):
                if getattr(jl[t], k) is None:
                    assert getattr(tl[t], k) is None
                else:
                    _eq(getattr(tl[t], k), getattr(jl[t], k), (t, k))


def _outputs_equal(got, ref):
    for k, r in vars(ref).items():
        g = getattr(got, k)
        if isinstance(r, dict):
            assert list(g) == list(r), k
            for kk in r:
                if isinstance(r[kk], list):
                    assert g[kk] == r[kk], (k, kk)
                else:
                    _eq(g[kk], r[kk], (k, kk))
        else:
            assert g == r, k


def _sample_both(jd, td, nodes, jcls, tcls, **kw):
    js, ts = jcls(jd, [4, 3], seed=11, **kw), tcls(td, [4, 3], seed=11, **kw)
    rng = np.random.default_rng(2)
    for bs in (6, 6, 9):
        seeds = rng.integers(0, nodes['paper'], bs)
        ts.batch_size = js.batch_size = bs
        _outputs_equal(ts.sample_from_nodes('paper', NodeSamplerInput(
            node=seeds)), js.sample_from_nodes('paper', JInput(node=seeds)))
    seeds = np.arange(5)
    _outputs_equal(ts.sample_from_nodes('author', NodeSamplerInput(
        node=seeds)), js.sample_from_nodes('author', JInput(node=seeds)))


@pytest.mark.parametrize('sampler', ['neighbor', 'hgt'])
def test_hetero_samplers(path, sampler):
    jd, td, nodes, _ = _graph(7)
    _sample_both(jd, td, nodes, *((JHGTSampler, HGTSampler)
                                  if sampler == 'hgt'
                                  else (JSampler, HeteroNeighborSampler)))


def test_hetero_sampler_with_replacement_native(monkeypatch):
    """The native path with replacement (the JAX package's numpy path
    raises there: its per-row bounds do not broadcast)."""
    assert jcsrc.WITH_NATIVE_SAMPLER and csrc.WITH_NATIVE_SAMPLER
    jd, td, nodes, _ = _graph(9)
    _sample_both(jd, td, nodes, JSampler, HeteroNeighborSampler,
                 replace=True)


@pytest.mark.parametrize('loader', ['neighbor', 'hgt'])
def test_hetero_loaders(path, loader):
    jd, td, nodes, _ = _graph(8)
    jcls, tcls = ((JHGTLoader, HGTLoader) if loader == 'hgt'
                  else (JLoader, HeteroNeighborLoader))
    idx = np.arange(3, 3 + 23)
    jl = jcls(jd, [3, 2], ('paper', idx), batch_size=7, shuffle=True,
              seed=4)
    tl = tcls(td, [3, 2], ('paper', idx), batch_size=7, shuffle=True,
              seed=4)
    assert len(tl) == len(jl) == 4
    n = 0
    for tb, jb in zip(tl, jl):
        n += 1
        assert tb.metadata() == jb.metadata()
        for t in jb.node_types:
            assert sorted(tb[t].keys()) == sorted(jb[t].keys())
            for k in jb[t].keys():
                _eq(tb[t].get(k), jb[t].get(k), (t, k))
        for et in jb.edge_types:
            assert sorted(tb[et].keys()) == sorted(jb[et].keys())
            for k in jb[et].keys():
                _eq(tb[et].get(k), jb[et].get(k), (et, k))
    assert n == 4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', ROOT / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_builds_the_hetero_bench_graph():
    """``chip_smoke.py::build_mag_like`` is ``benchmarks/hetero_bench.py``'s
    graph: the same seed gives the same nodes, edges, features and
    labels."""
    sys.path.insert(0, str(ROOT / 'benchmarks'))
    try:
        import hetero_bench
    finally:
        sys.path.remove(str(ROOT / 'benchmarks'))
    cs = _chip_smoke()
    for scale, seed in ((0.001, 0), (0.0005, 3)):
        ref = hetero_bench.build_mag_like(scale, seed)
        got = cs.build_mag_like(scale, seed)
        assert got[0] == ref[0]
        assert list(got[1]) == list(ref[1])
        for et in ref[1]:
            _eq(got[1][et], ref[1][et], str(et))
        for t in ref[2]:
            _eq(got[2][t], ref[2][t], t)
        _eq(got[3], ref[3], 'y')
