"""The rest of the port's ``data/`` and its dataset parsers against the JAX
package's, on the CPU.

Parsers: each npz, text, big-graph and social class parses raw files of its
format written here at a tiny size (self loops and duplicate edges where
the format allows them) to the same graphs as the JAX class from the same
bytes, bit for bit, dtypes included; one parametrised test a family. Then
``data/stores.py`` (puts, indexed puts and gets, the CSC and CSR of a
stored COO), ``summary.py``, ``hypergraph.py`` (the hyperedge count, and
``to`` keeping the class), ``database.py`` (a SQLite round trip, a database
written by one package read by the other, ``RocksDatabase`` without
``rocksdict``, ``OnDiskDataset``), ``datapipes.py`` (a registered transform
and padded batches) and ``lightning.py`` (each module's batches), each
against the JAX package's: exact. ``download_url`` on a file already there
(no network), and the four extractors on archives made here."""

import bz2
import gzip
import json
import shutil
import tarfile
import zipfile

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

from pytorch_geometric_tpu import data as jdata
from pytorch_geometric_tpu import datasets as jds
from pytorch_geometric_tpu.data import datapipes as jpipes
from pytorch_geometric_tpu.data import lightning as jlight
from pytorch_geometric_tpu_torch import data as tdata
from pytorch_geometric_tpu_torch import datasets as tds


def _same_data(got, want, what=''):
    assert got.num_nodes == want.num_nodes, what
    assert sorted(got.keys()) == sorted(want.keys()), what
    for k in want.keys():
        g = got[k]
        g = (g.coo if hasattr(g, 'coo') else g).numpy()
        w = np.asarray(want[k].coo if hasattr(want[k], 'coo') else want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f'{what} {k}')


# -- raw files -------------------------------------------------------------
def _edges(rng, n, e):
    """Random edges with a self loop and a duplicate."""
    coo = rng.integers(0, n, (2, e))
    coo[:, 0] = 3
    coo[:, 1] = coo[:, 2]
    return coo


def _benchmark_npz(path, rng, n=30, f=8, e=90, attrs=True):
    """The GNN-benchmark npz: CSR adjacency and attributes, labels."""
    coo = _edges(rng, n, e)
    adj = sp.csr_matrix((np.ones(e, np.float32), (coo[0], coo[1])), (n, n))
    out = dict(adj_data=adj.data, adj_indices=adj.indices,
               adj_indptr=adj.indptr, adj_shape=adj.shape,
               labels=rng.integers(0, 4, n))
    if attrs:
        x = sp.csr_matrix(rng.random((n, f)) * (rng.random((n, f)) < 0.3))
        out.update(attr_data=x.data, attr_indices=x.indices,
                   attr_indptr=x.indptr, attr_shape=x.shape)
    np.savez(path, **out)


def _geom_gcn(raw, rng, name, n=25, f=6, e=70, actor=False, splits=None):
    """geom-gcn text files: features and labels, edges, optional splits."""
    lines = ['node_id\tfeature\tlabel']
    for i in range(n):
        if actor:
            feats = sorted(set(rng.integers(0, 932, 4).tolist()))
        else:
            feats = rng.integers(0, 2, f).tolist()
        lines.append(f'{i}\t{",".join(map(str, feats))}\t'
                     f'{rng.integers(0, 5)}')
    (raw / 'out1_node_feature_label.txt').write_text('\n'.join(lines)
                                                      + '\n')
    coo = _edges(rng, n, e)
    (raw / 'out1_graph_edges.txt').write_text(
        'node_id\tnode_id\n'
        + ''.join(f'{a}\t{b}\n' for a, b in coo.T))
    for i in range(splits or 0):
        m = rng.permutation(n)
        masks = [np.isin(np.arange(n), m[a:b])
                 for a, b in ((0, 15), (15, 20), (20, n))]
        np.savez(raw / f'{name}_split_0.6_0.2_{i}.npz',
                 **dict(zip(('train_mask', 'val_mask', 'test_mask'), masks)))


def _saint(raw, rng, multilabel, n=40, f=5, e=120):
    coo = _edges(rng, n, e)
    adj = sp.csr_matrix((np.ones(e), (coo[0], coo[1])), (n, n))
    np.savez(raw / 'adj_full.npz', data=adj.data, indices=adj.indices,
             indptr=adj.indptr, shape=adj.shape)
    np.save(raw / 'feats.npy', rng.standard_normal((n, f)))
    cmap = {str(i): (rng.integers(0, 2, 3).tolist() if multilabel
                     else int(rng.integers(0, 6))) for i in range(n)}
    (raw / 'class_map.json').write_text(json.dumps(cmap))
    perm = rng.permutation(n).tolist()
    (raw / 'role.json').write_text(json.dumps(
        {'tr': perm[:20], 'va': perm[20:28], 'te': perm[28:]}))


def _reddit(raw, rng, n=40, f=5, e=120):
    np.savez(raw / 'reddit_data.npz', feature=rng.standard_normal((n, f)),
             label=rng.integers(0, 9, n), node_types=rng.integers(1, 4, n))
    coo = _edges(rng, n, e)
    sp.save_npz(raw / 'reddit_graph.npz',
                sp.coo_matrix((np.ones(e), (coo[0], coo[1])), (n, n)))


def _fte(path, rng, n=30, f=4, e=80, features=True):
    """An npz of features / target / edges ``[E, 2]``."""
    out = dict(target=rng.integers(0, 3, n), edges=_edges(rng, n, e).T)
    if features:
        out['features'] = rng.standard_normal((n, f))
    np.savez(path, **out)


def _airports(raw, rng, name, n=20, e=50):
    ids = rng.permutation(1000)[:n] + 100
    (raw / f'labels-{name}-airports.txt').write_text(
        'node label\n' + ''.join(f'{i} {rng.integers(0, 4)}\n' for i in ids))
    coo = ids[_edges(rng, n, e)]
    (raw / f'{name}-airports.edgelist').write_text(
        ''.join(f'{a} {b}\n' for a, b in coo.T))


def _wikics(raw, rng, n=20, f=4):
    links = [sorted(set(rng.integers(0, n, 3).tolist())) for _ in range(n)]
    (raw / 'data.json').write_text(json.dumps({
        'features': rng.standard_normal((n, f)).tolist(),
        'labels': rng.integers(0, 3, n).tolist(), 'links': links,
        'train_masks': rng.integers(0, 2, (4, n)).tolist(),
        'val_masks': rng.integers(0, 2, (4, n)).tolist(),
        'test_mask': rng.integers(0, 2, n).tolist()}))


def _ppi(raw, rng, split, n=30, f=4, e=90):
    coo = _edges(rng, n, e)
    (raw / f'{split}_graph.json').write_text(json.dumps(
        {'links': [{'source': int(a), 'target': int(b)} for a, b in coo.T]}))
    np.save(raw / f'{split}_feats.npy', rng.standard_normal((n, f)))
    np.save(raw / f'{split}_labels.npy', rng.integers(0, 2, (n, 5)))
    np.save(raw / f'{split}_graph_id.npy', np.repeat([1, 2, 3], 10))


def _heterophilous(path, rng, n=25, f=4, e=60):
    np.savez(path, node_features=rng.standard_normal((n, f)),
             node_labels=rng.integers(0, 5, n), edges=_edges(rng, n, e).T,
             train_masks=rng.integers(0, 2, (10, n)),
             val_masks=rng.integers(0, 2, (10, n)),
             test_masks=rng.integers(0, 2, (10, n)))


def _linkx(path, rng, n=25, f=4, e=60):
    coo = _edges(rng, n, e)
    scipy.io.savemat(path, {
        'A': sp.csc_matrix((np.ones(e), (coo[0], coo[1])), (n, n)),
        'node_feat': rng.standard_normal((n, f)),
        'label': rng.integers(0, 2, (1, n))})


def _bitcoin(path, rng, e=60):
    t = np.sort(rng.integers(1_300_000_000, 1_310_000_000, e))
    rows = np.stack([rng.integers(5, 40, e), rng.integers(5, 40, e),
                     rng.integers(-10, 11, e), t], 1)
    np.savetxt(path, rows, fmt='%d', delimiter=',')


def _elliptic(raw, rng, n=30, e=70):
    ids = rng.permutation(5000)[:n] + 1000
    feat = np.concatenate([ids[:, None], rng.integers(1, 50, (n, 1)),
                           rng.standard_normal((n, 3))], 1)
    np.savetxt(raw / 'elliptic_txs_features.csv', feat, delimiter=',')
    coo = ids[_edges(rng, n, e)]
    coo[0, :3] = 7    # an id outside the features: dropped
    (raw / 'elliptic_txs_edgelist.csv').write_text(
        'txId1,txId2\n' + ''.join(f'{a},{b}\n' for a, b in coo.T))
    cls = rng.choice(['1', '2', 'unknown'], n)
    (raw / 'elliptic_txs_classes.csv').write_text(
        'txId,class\n' + ''.join(f'{i},{c}\n' for i, c in zip(ids, cls)))


def _attributed(raw, rng, n=20, f=6, e=50):
    sp.save_npz(raw / 'attrs.npz',
                sp.csr_matrix(rng.random((n, f)) < 0.3, dtype=np.float32))
    coo = _edges(rng, n, e)
    (raw / 'edgelist.txt').write_text(''.join(f'{a} {b}\n'
                                              for a, b in coo.T))
    (raw / 'labels.txt').write_text(''.join(
        f'{i} {rng.integers(0, 3)}\n' for i in range(n)))


def _text_edges(path, rng, n=25, e=60, header=''):
    coo = _edges(rng, n, e)
    path.write_text(header + ''.join(f'{a}\t{b}\n' for a, b in coo.T))


def _polblogs(raw, rng, n=25, e=60):
    coo = _edges(rng, n, e)
    (raw / 'adjacency.tsv').write_text(''.join(
        f'{a}\t{b}\t1\n' for a, b in coo.T))
    (raw / 'labels.tsv').write_text(''.join(
        f'{rng.integers(0, 2)}\n' for _ in range(n)))


def _email(raw, rng, n=25, e=60):
    _text_edges(raw / 'email-Eu-core.txt', rng, n, e)
    (raw / 'email-Eu-core-department-labels.txt').write_text(''.join(
        f'{i} {rng.integers(0, 6)}\n' for i in range(n)))


# family -> case -> (class, args, raw directory under the root, writer)
FAMILIES = {
    'npz': {
        'Amazon photo': ('Amazon', ('Photo',), 'photo/raw', lambda r, g:
                         _benchmark_npz(r / 'amazon_electronics_photo.npz',
                                        g)),
        'Coauthor cs': ('Coauthor', ('CS',), 'cs/raw', lambda r, g:
                        _benchmark_npz(r / 'ms_academic_cs.npz', g)),
        'Coauthor physics': ('Coauthor', ('Physics',), 'physics/raw',
                             lambda r, g: _benchmark_npz(
                                 r / 'ms_academic_phy.npz', g)),
        'CitationFull': ('CitationFull', ('Cora_ML',), 'cora_ml/raw',
                         lambda r, g: _benchmark_npz(r / 'cora_ml.npz', g)),
        'CoraFull no attributes': ('CoraFull', (), 'cora/raw', lambda r, g:
                                   _benchmark_npz(r / 'cora.npz', g,
                                                  attrs=False)),
    },
    'geom-gcn text': {
        'WebKB': ('WebKB', ('Cornell',), 'cornell/raw',
                  lambda r, g: _geom_gcn(r, g, 'cornell', splits=3)),
        'WebKB no splits': ('WebKB', ('Texas',), 'texas/raw',
                            lambda r, g: _geom_gcn(r, g, 'texas')),
        'WikipediaNetwork': ('WikipediaNetwork', ('Chameleon',),
                             'chameleon/raw',
                             lambda r, g: _geom_gcn(r, g, 'chameleon',
                                                    splits=2)),
        'Actor': ('Actor', ('film',), 'film/raw',
                  lambda r, g: _geom_gcn(r, g, 'film', actor=True,
                                         splits=2)),
    },
    'big graphs': {
        'Reddit': ('Reddit', (), 'raw', _reddit),
        'Flickr': ('Flickr', (), 'raw', lambda r, g: _saint(r, g, False)),
        'Reddit2': ('Reddit2', (), 'raw', lambda r, g: _saint(r, g, False)),
        'Yelp': ('Yelp', (), 'raw', lambda r, g: _saint(r, g, True)),
        'AmazonProducts': ('AmazonProducts', (), 'raw',
                           lambda r, g: _saint(r, g, True)),
    },
    'social': {
        'DeezerEurope': ('DeezerEurope', (), 'raw',
                         lambda r, g: _fte(r / 'deezer_europe.npz', g)),
        'LastFMAsia': ('LastFMAsia', (), 'raw',
                       lambda r, g: _fte(r / 'lastfm_asia.npz', g)),
        'FacebookPagePage': ('FacebookPagePage', (), 'raw',
                             lambda r, g: _fte(r / 'facebook.npz', g)),
        'GitHub': ('GitHub', (), 'raw',
                   lambda r, g: _fte(r / 'github.npz', g)),
        'Twitch': ('Twitch', ('de',), 'DE/raw',
                   lambda r, g: _fte(r / 'DE.npz', g)),
        'GemsecDeezer': ('GemsecDeezer', ('HR',), 'HR/raw',
                         lambda r, g: _fte(r / 'HR.npz', g,
                                           features=False)),
        'Airports': ('Airports', ('USA',), 'usa/raw',
                     lambda r, g: _airports(r, g, 'usa')),
        'PolBlogs': ('PolBlogs', (), 'raw', _polblogs),
        'EmailEUCore': ('EmailEUCore', (), 'raw', _email),
        'WikiCS': ('WikiCS', (), 'raw', _wikics),
        'PPI': ('PPI', ('val',), 'raw', lambda r, g: _ppi(r, g, 'val')),
        'HeterophilousGraphDataset': (
            'HeterophilousGraphDataset', ('Roman-empire',),
            'roman_empire/raw',
            lambda r, g: _heterophilous(r / 'roman_empire.npz', g)),
        'LINKXDataset': ('LINKXDataset', ('Penn94',), 'penn94/raw',
                         lambda r, g: _linkx(r / 'penn94.mat', g)),
        'BitcoinOTC': ('BitcoinOTC', (), 'raw', lambda r, g: _bitcoin(
            r / 'soc-sign-bitcoinotc.csv', g)),
        'EllipticBitcoinDataset': ('EllipticBitcoinDataset', (), 'raw',
                                   _elliptic),
        'AttributedGraphDataset': ('AttributedGraphDataset', ('Wiki',),
                                   'wiki/raw', _attributed),
        'SNAPDataset': ('SNAPDataset', ('ego-facebook',),
                        'ego-facebook/raw',
                        lambda r, g: _text_edges(
                            r / 'ego-facebook.txt', g,
                            header='# a SNAP edge list\n')),
    },
}


def _family_case(tmp_path, family, case):
    cls, args, sub, write = FAMILIES[family][case]
    raw = tmp_path / 'jax' / sub
    raw.mkdir(parents=True)
    write(raw, np.random.default_rng(len(case)))
    shutil.copytree(tmp_path / 'jax', tmp_path / 'port')
    want = getattr(jds, cls)(str(tmp_path / 'jax'), *args)
    got = getattr(tds, cls)(str(tmp_path / 'port'), *args)
    again = getattr(tds, cls)(str(tmp_path / 'port'), *args)
    assert len(got) == len(want) == len(again) > 0
    for i in range(len(want)):
        _same_data(got[i], want[i], f'{case} graph {i}')
        _same_data(again[i], want[i], f'{case} graph {i} reloaded')


@pytest.mark.parametrize('case', sorted(FAMILIES['npz']))
def test_npz_family_matches_jax(tmp_path, case):
    _family_case(tmp_path, 'npz', case)


@pytest.mark.parametrize('case', sorted(FAMILIES['geom-gcn text']))
def test_geom_gcn_family_matches_jax(tmp_path, case):
    _family_case(tmp_path, 'geom-gcn text', case)


@pytest.mark.parametrize('case', sorted(FAMILIES['big graphs']))
def test_big_graph_family_matches_jax(tmp_path, case):
    _family_case(tmp_path, 'big graphs', case)


@pytest.mark.parametrize('case', sorted(FAMILIES['social']))
def test_social_family_matches_jax(tmp_path, case):
    _family_case(tmp_path, 'social', case)


def test_read_npz_and_missing_files(tmp_path):
    """``read_npz`` alone; a class without its raw files raises."""
    _benchmark_npz(tmp_path / 'g.npz', np.random.default_rng(0))
    _same_data(tds.read_npz(str(tmp_path / 'g.npz')),
               jds.read_npz(str(tmp_path / 'g.npz')))
    for pkg in (jds, tds):
        with pytest.raises(RuntimeError, match='raw files missing'):
            pkg.Amazon(str(tmp_path / pkg.__name__), 'computers')


# -- stores, summary, hypergraph -------------------------------------------
def test_feature_store_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((10, 3))
    stores = (jdata.InMemoryFeatureStore(), tdata.InMemoryFeatureStore())
    for fs in stores:
        fs['paper', 'x'] = x
        fs.put_tensor(np.full((2, 3), 7.0), 'paper', 'x', index=[4, 1])
        fs.put_tensor(np.arange(10), 'author', 'id')
    (j, t) = stores
    for idx in (None, [0, 4, 1], np.array([9, 2])):
        a = t.get_tensor('paper', 'x', index=idx)
        b = j.get_tensor('paper', 'x', index=idx)
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(t.multi_get_tensor(j.get_all_tensor_attrs()),
                    j.multi_get_tensor(j.get_all_tensor_attrs())):
        np.testing.assert_array_equal(a.numpy(), b)
    assert t.get_all_tensor_attrs() == [
        tdata.TensorAttr(a.group_name, a.attr_name)
        for a in j.get_all_tensor_attrs()]
    assert t.remove_tensor('author', 'id') and not t.remove_tensor('a', 'b')
    with pytest.raises(KeyError):
        t['author', 'id']
    assert tdata.TensorAttr('p', 'x').is_fully_specified()
    assert not tdata.TensorAttr('p').is_fully_specified()


def test_graph_store_matches_jax():
    rng = np.random.default_rng(2)
    coo = rng.integers(0, 12, (2, 40))
    et = ('paper', 'cites', 'paper')
    j, t = jdata.InMemoryGraphStore(), tdata.InMemoryGraphStore()
    for gs in (j, t):
        gs.put_edge_index(coo, et, layout='coo', size=(12, 12))
        gs.put_edge_index(coo[:, :5], 'csr-stored', layout='csr')
    for layout in ('csc', 'csr'):
        for a, b in zip(getattr(t, layout)(et), getattr(j, layout)(et)):
            assert a.numpy().dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(t.coo(et).numpy(), j.coo(et))
    assert [a.layout.value for a in t.get_all_edge_attrs()] == \
        [a.layout.value for a in j.get_all_edge_attrs()]
    for gs in (j, t):
        with pytest.raises(NotImplementedError):
            gs.get_edge_index('csr-stored', 'coo')
        with pytest.raises(KeyError):
            gs.get_edge_index('none')


def test_summary_matches_jax():
    kw = dict(num_graphs=7, avg_num_nodes=15, avg_degree=3, num_channels=2,
              task='graph', seed=4)
    got = tdata.summary(tds.FakeDataset(**kw))
    want = jdata.summary(jds.FakeDataset(**kw))
    assert got.num_graphs == want.num_graphs == 7
    assert repr(got) == repr(want)
    for k in ('num_nodes', 'num_edges'):
        assert vars(getattr(got, k)) == vars(getattr(want, k))
    assert vars(tdata.Stats.from_data([])) == vars(jdata.Stats.from_data([]))


def test_hypergraph_data_matches_jax():
    inc = np.array([[0, 1, 2, 2, 3], [0, 0, 1, 4, 4]])
    x = np.ones((4, 2), np.float32)
    for kw in ({}, {'num_hyperedges': 9}):
        got = tdata.HypergraphData(x=x, edge_index=inc, **kw)
        want = jdata.HypergraphData(x=x, edge_index=inc, **kw)
        assert got.num_hyperedges == want.num_hyperedges
        _same_data(got, want)
        moved = got.to('cpu')
        assert type(moved) is tdata.HypergraphData
        assert moved.num_hyperedges == got.num_hyperedges
        _same_data(moved, want)
    assert tdata.HypergraphData(x=x).num_hyperedges == 0


# -- database --------------------------------------------------------------
def _graphs():
    return list(tds.FakeDataset(num_graphs=3, avg_num_nodes=8, avg_degree=2,
                                num_channels=3, task='graph', seed=2))


def _jgraphs():
    return list(jds.FakeDataset(num_graphs=3, avg_num_nodes=8, avg_degree=2,
                                num_channels=3, task='graph', seed=2))


def test_sqlite_round_trip_matches_jax(tmp_path):
    """Rows written by either package read back the same in both: the
    pickled row format is shared."""
    for writer in ('port', 'jax'):
        path = str(tmp_path / f'{writer}.sqlite')
        db = (tdata.SQLiteDatabase if writer == 'port'
              else jdata.SQLiteDatabase)(path)
        db.multi_insert([0, 1, 2], _graphs() if writer == 'port'
                        else _jgraphs())
        db.insert(5, {'a': 1})
        db.close()
        t, j = tdata.SQLiteDatabase(path), jdata.SQLiteDatabase(path)
        assert len(t) == len(j) == 4
        for i, want in enumerate(_jgraphs()):
            got = t.get(i)
            assert isinstance(got, tdata.Data)
            _same_data(got, j.get(i), f'{writer} row {i}')
            _same_data(got, want, f'{writer} row {i}')
        assert t.get(5) == {'a': 1}
        assert [g.num_nodes for g in t.multi_get([2, 0])] == \
            [g.num_nodes for g in j.multi_get([2, 0])]
        with pytest.raises(KeyError):
            t.get(9)
        t.close()
        j.close()


def test_rocks_database_needs_rocksdict(tmp_path):
    try:
        import rocksdict  # noqa: F401
    except ImportError:
        for pkg in (jdata, tdata):
            with pytest.raises(ImportError, match='rocksdict'):
                pkg.RocksDatabase(str(tmp_path / 'rocks'))
    else:
        db = tdata.RocksDatabase(str(tmp_path / 'rocks'))
        db.insert(0, {'a': 1})
        db.insert(0, {'a': 2})
        assert len(db) == 1 and db.get(0) == {'a': 2}
        db.close()


def test_on_disk_dataset_matches_jax(tmp_path):
    def make(base, graphs):
        class Disk(base):
            def download(self):
                pass

            def process(self):
                for g in graphs:
                    self.append(g)
        return Disk

    want = make(jdata.OnDiskDataset, _jgraphs())(str(tmp_path / 'jax'))
    got = make(tdata.OnDiskDataset, _graphs())(str(tmp_path / 'port'))
    assert len(got) == len(want) == 3
    for i in range(3):
        _same_data(got[i], want[i], f'graph {i}')
    again = make(tdata.OnDiskDataset, [])(str(tmp_path / 'port'))
    assert len(again) == 3
    assert tdata.TensorInfo('float32') == tdata.TensorInfo('float32', (-1,))


# -- datapipes and data modules -------------------------------------------
def test_datapipes_match_jax():
    """A dataset through a registered transform and padded batches of 2
    (the last one short), in both packages."""
    class Scale:
        def __init__(self, s):
            self.s = s

        def __call__(self, d):
            return d.replace(x=d.x * self.s)

    tdata.functional_transform('scale_by')(Scale)
    jdata_pipes = jpipes.functional_transform('scale_by')(Scale)
    assert jdata_pipes is Scale
    kw = dict(num_graphs=5, avg_num_nodes=6, avg_degree=2, num_channels=2,
              task='graph', seed=3)
    t = tdata.Batcher(tdata.DatasetAdapter(tds.FakeDataset(**kw))
                      .scale_by(2.0), 2, max_num_nodes=24,
                      max_num_edges=40)
    j = jpipes.Batcher(jpipes.DatasetAdapter(jds.FakeDataset(**kw))
                       .scale_by(2.0), 2, max_num_nodes=24,
                       max_num_edges=40)
    got, want = list(t), list(j)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_data(g, w)
    assert len(list(tdata.Batcher(tdata.DatasetAdapter(
        tds.FakeDataset(**kw)), 2, drop_last=True))) == 2
    assert len(tdata.DatasetAdapter(tds.FakeDataset(**kw))) == 5
    with pytest.raises(AttributeError):
        tdata.DatasetAdapter([]).not_registered


def _node_data(pkg):
    rng = np.random.default_rng(6)
    n = 60
    return pkg.Data(x=rng.standard_normal((n, 3)).astype(np.float32),
                    edge_index=rng.integers(0, n, (2, 300)),
                    y=rng.integers(0, 3, n), train_mask=rng.random(n) < 0.4,
                    val_mask=rng.random(n) < 0.2, num_nodes=n)


def test_lightning_node_and_link_data_match_jax():
    """``LightningNodeData``'s NeighborLoaders (masks and given nodes) and
    its full-graph form, ``LightningLinkData``'s LinkNeighborLoaders: the
    same batches as the JAX package's modules."""
    kw = dict(num_neighbors=[3, 2], batch_size=8, seed=2)
    t = tdata.LightningNodeData(_node_data(tdata), **kw)
    j = jlight.LightningNodeData(_node_data(jdata), **kw)
    for split in ('train_dataloader', 'val_dataloader'):
        got, want = list(getattr(t, split)()), list(getattr(j, split)())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _same_data(g, w, split)
    with pytest.raises(ValueError, match="no input nodes for split 'test'"):
        t.test_dataloader()
    nodes = np.array([5, 9, 1])
    t = tdata.LightningNodeData(_node_data(tdata),
                                input_test_nodes=torch.from_numpy(nodes),
                                **kw)
    j = jlight.LightningNodeData(_node_data(jdata), input_test_nodes=nodes,
                                 **kw)
    _same_data(next(iter(t.test_dataloader())),
               next(iter(j.test_dataloader())))
    full = tdata.LightningNodeData(_node_data(tdata), loader='full')
    assert full.train_dataloader()[0] is full.data
    edges = np.random.default_rng(8).integers(0, 60, (2, 20))
    t = tdata.LightningLinkData(_node_data(tdata), input_train_edges=edges,
                                **kw)
    j = jlight.LightningLinkData(_node_data(jdata), input_train_edges=edges,
                                 **kw)
    for g, w in zip(t.train_dataloader(), j.train_dataloader()):
        _same_data(g, w, 'link')
    with pytest.raises(ValueError, match="no input edges for split 'val'"):
        t.val_dataloader()


def test_lightning_dataset_matches_jax():
    kw = dict(num_graphs=6, avg_num_nodes=6, avg_degree=2, num_channels=2,
              task='graph', seed=5)
    t = tdata.LightningDataset(tds.FakeDataset(**kw), tds.FakeDataset(**kw),
                               batch_size=4, seed=3)
    j = jlight.LightningDataset(jds.FakeDataset(**kw),
                                jds.FakeDataset(**kw), batch_size=4, seed=3)
    for split in ('train_dataloader', 'val_dataloader'):
        for g, w in zip(getattr(t, split)(), getattr(j, split)()):
            _same_data(g, w, split)
    with pytest.raises(ValueError, match="no 'test_dataset'"):
        t.test_dataloader()
    t.setup('fit')
    t.prepare_data()


# -- download and extract --------------------------------------------------
def test_download_url_uses_the_file_there(tmp_path):
    """No network: each package returns the file already in the folder,
    the name taken from the URL less its query."""
    (tmp_path / 'ind.cora.x').write_bytes(b'cached')
    from pytorch_geometric_tpu.data import download as jdl
    for pkg in (tdata, jdl):
        path = pkg.download_url('https://example.invalid/data/ind.cora.x'
                                '?raw=true', str(tmp_path))
        assert path == str(tmp_path / 'ind.cora.x')
        assert pkg.download_google_url('some-id', str(tmp_path),
                                       'ind.cora.x') == path
    assert (tmp_path / 'ind.cora.x').read_bytes() == b'cached'
    tdata.makedirs(str(tmp_path / 'a' / 'b'))
    assert (tmp_path / 'a' / 'b').is_dir()


def test_extractors_match_jax(tmp_path):
    from pytorch_geometric_tpu.data import extract as jex
    src = tmp_path / 'src'
    (src / 'sub').mkdir(parents=True)
    (src / 'a.txt').write_text('alpha')
    (src / 'sub' / 'b.bin').write_bytes(bytes(range(50)))
    with tarfile.open(tmp_path / 'x.tar.gz', 'w:gz') as f:
        f.add(src, arcname='src')
    with zipfile.ZipFile(tmp_path / 'x.zip', 'w') as f:
        f.write(src / 'a.txt', 'src/a.txt')
        f.write(src / 'sub' / 'b.bin', 'src/sub/b.bin')
    (tmp_path / 'y.txt.bz2').write_bytes(bz2.compress(b'bz2 payload'))
    (tmp_path / 'y.txt.gz').write_bytes(gzip.compress(b'gz payload'))
    for name, pkg in (('port', tdata), ('jax', jex)):
        out = tmp_path / name
        for kind in ('tar', 'zip'):
            pkg_dir = out / kind
            pkg_dir.mkdir(parents=True)
            if kind == 'tar':
                pkg.extract_tar(str(tmp_path / 'x.tar.gz'), str(pkg_dir))
            else:
                pkg.extract_zip(str(tmp_path / 'x.zip'), str(pkg_dir))
            assert (pkg_dir / 'src' / 'a.txt').read_text() == 'alpha'
            assert (pkg_dir / 'src' / 'sub' / 'b.bin').read_bytes() == \
                bytes(range(50))
        for kind, data in (('bz2', b'bz2 payload'), ('gz', b'gz payload')):
            (out / kind).mkdir()
            shutil.copy(tmp_path / f'y.txt.{kind}', out / f'y.txt.{kind}')
            getattr(pkg, f'extract_{kind}')(str(out / f'y.txt.{kind}'),
                                            str(out / kind))
            assert (out / kind / 'y.txt').read_bytes() == data
