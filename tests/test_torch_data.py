"""The port's graph containers (``data/data.py``, ``data/batch.py``) and the
graph-list ``DataLoader`` / ``Collater`` against the JAX package's, on the
CPU: the same numpy graphs, made from a seed, go into both, and every field
of every result must be equal, dtype and shape included (the JAX package
narrows 64-bit values to 32 bits, and so does the port for anything that is
not a tensor already). The port keeps a tensor it is given where it is,
without a copy."""

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Batch as JBatch, Data as JData
from pytorch_geometric_tpu.loader import DataLoader as JDataLoader
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.data import Batch, Data
from pytorch_geometric_tpu_torch.loader import Collater, DataLoader


def _graph(rng, n, e, with_face=False):
    g = dict(x=rng.standard_normal((n, 5)),                    # float64
             edge_index=np.stack([rng.integers(0, n, e),
                                  rng.integers(0, n, e)]),     # int64
             edge_attr=rng.standard_normal((e, 3)).astype(np.float32),
             y=rng.integers(0, 4, 1),                          # per graph
             node_label=rng.integers(0, 3, n).astype(np.int64),
             mask=rng.random(n) < 0.5)
    if with_face:
        g['face'] = rng.integers(0, n, (3, 4))
    return g


def _graphs(seed, count=4, with_face=False):
    rng = np.random.default_rng(seed)
    return [_graph(rng, int(rng.integers(5, 12)), int(rng.integers(6, 20)),
                   with_face) for _ in range(count)]


def _fields_equal(got, ref):
    """Every field of ``ref`` (a JAX Data or Batch) equals ``got``'s, dtype
    and shape included; an EdgeIndex by its COO and sparse size."""
    assert sorted(got.keys()) == sorted(ref.keys())
    for k in ref.keys():
        r, g = ref[k], got[k]
        if hasattr(r, 'coo'):
            assert isinstance(g, EdgeIndex), k
            assert tuple(g.sparse_size) == tuple(r.sparse_size), k
            assert g.num_real_edges == r.num_real_edges, k
            r, g = r.coo, g.coo
        r, g = np.asarray(r), g.numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, (k, g.dtype,
                                                           r.dtype)
        np.testing.assert_array_equal(g, r, err_msg=k)


def test_data_fields_and_sizes_match_jax():
    g = _graphs(0, 1)[0]
    ref, got = JData(**g), Data(**g)
    _fields_equal(got, ref)
    assert got.num_nodes == ref.num_nodes == len(g['x'])
    assert got.num_edges == ref.num_edges
    assert got.num_node_features == ref.num_node_features == 5
    assert got.num_edge_features == ref.num_edge_features == 3
    # the sizes without x: from pos, then from the edge index
    for kw in ({'pos': g['x']}, {'edge_index': g['edge_index']}):
        assert Data(**kw).num_nodes == JData(**kw).num_nodes
    ei = EdgeIndex(g['edge_index'].astype(np.int32), (40, 40), device='cpu')
    assert Data(edge_index=ei).num_nodes == 40
    assert Data(edge_index=ei).num_edges == g['edge_index'].shape[1]
    assert Data().num_nodes is None and Data().num_edges == 0


def test_data_replace_setattr_and_rules_match_jax():
    g = _graphs(1, 1)[0]
    ref, got = JData(**g), Data(**g)
    new_x = np.ones((len(g['x']), 2))
    ref2 = ref.replace(x=new_x, y=None, num_nodes=99, tag='a')
    got2 = got.replace(x=new_x, y=None, num_nodes=99, tag='a')
    assert got2.num_nodes == ref2.num_nodes == 99
    assert got2.tag == 'a' and 'y' not in got2 and 'y' in got
    assert got2.x.dtype == torch.float32 and got2.x.shape == (len(g['x']), 2)
    got.extra = np.arange(3)
    ref.extra = np.arange(3)
    assert got.extra.dtype == torch.int32
    np.testing.assert_array_equal(got['extra'].numpy(), np.asarray(ref.extra))
    got.extra = None
    assert 'extra' not in got and got.missing is None
    del got['mask']
    assert 'mask' not in got
    for key, value in (('edge_index', got.edge_index), ('face', np.zeros(3)),
                       ('face', np.zeros((3, 2))), ('x', got.x),
                       ('batch_index', np.zeros(4))):
        assert Data.cat_dim(key, value) == JData.cat_dim(key, value), key
        assert got.inc(key, value) == ref.inc(key, value), key


def test_data_keeps_tensors_where_they_are():
    """A tensor goes into the store as it is: not copied, not moved, not
    narrowed; an EdgeIndex too."""
    x = torch.randn(6, 3, dtype=torch.float64)
    coo = torch.tensor([[0, 1, 2], [1, 2, 3]])
    ei = EdgeIndex(coo, (6, 6), device='cpu')
    d = Data(x=x, edge_index=coo, w=ei)
    assert d.x is x and d.edge_index is coo and d.w is ei
    assert d.x.dtype == torch.float64 and d.edge_index.dtype == torch.int64
    d2 = d.replace(x=x[:, :1])
    assert d2.x.data_ptr() == x.data_ptr() and d2.edge_index is coo


@pytest.mark.parametrize('pad', [False, True])
@pytest.mark.parametrize('with_face', [False, True])
def test_batch_matches_jax(pad, with_face):
    graphs = _graphs(2, with_face=with_face)
    n = sum(len(g['x']) for g in graphs)
    e = sum(g['edge_index'].shape[1] for g in graphs)
    kw = dict(pad_num_nodes=n + 7, pad_num_edges=e + 5) if pad else {}
    ref = JBatch.from_data_list([JData(**g) for g in graphs], **kw)
    got = Batch.from_data_list([Data(**g) for g in graphs], **kw)
    _fields_equal(got, ref)
    assert got.num_nodes == ref.num_nodes
    assert got.num_graphs == ref.num_graphs == len(graphs)
    assert got.num_real_nodes == ref.num_real_nodes == n
    assert got.num_real_edges == ref.num_real_edges == e
    np.testing.assert_array_equal(got.node_mask.numpy(),
                                  np.asarray(ref.node_mask))
    for a, b in zip(got.to_data_list(), ref.to_data_list()):
        _fields_equal(a, b)
        assert a.num_nodes == b.num_nodes


def test_batch_refusals_match_jax():
    graphs = _graphs(3)
    for cls, dcls in ((Batch, Data), (JBatch, JData)):
        with pytest.raises(ValueError, match='empty'):
            cls.from_data_list([])
        with pytest.raises(ValueError, match='budget'):
            cls.from_data_list([dcls(**g) for g in graphs], pad_num_nodes=3)
        bad = [dcls(**graphs[0]), dcls(x=graphs[1]['x'],
                                       edge_index=graphs[1]['edge_index'])]
        with pytest.raises(ValueError, match='missing'):
            cls.from_data_list(bad)


@pytest.mark.parametrize('pad', [True, False])
@pytest.mark.parametrize('shuffle,drop_last', [(False, False), (True, False),
                                               (True, True)])
def test_dataloader_collation_matches_jax(pad, shuffle, drop_last):
    graphs = _graphs(4, count=11)
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, pad=pad,
              seed=5)
    ref = JDataLoader([JData(**g) for g in graphs], **kw)
    got = DataLoader([Data(**g) for g in graphs], **kw)
    assert len(got) == len(ref) == (2 if drop_last else 3)
    batches = list(got)
    assert len(batches) == len(ref)
    for a, b in zip(batches, ref):
        _fields_equal(a, b)
        assert a.num_nodes == b.num_nodes
    # the padded node budget is a bucket with room for a dump row
    if pad:
        assert batches[0].num_nodes > batches[0].num_real_nodes


def test_collater_buckets_match_jax():
    from pytorch_geometric_tpu.loader.dataloader import Collater as JCollater
    graphs = _graphs(6, count=3)
    kw = dict(node_buckets=[8, 64], edge_buckets=[16, 128])
    got = Collater(**kw)([Data(**g) for g in graphs])
    ref = JCollater(**kw)([JData(**g) for g in graphs])
    _fields_equal(got, ref)
    assert got.num_nodes == ref.num_nodes == 64
