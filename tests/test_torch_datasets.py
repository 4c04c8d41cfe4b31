"""The port's ``data/dataset.py``, ``datasets/fake.py`` and
``datasets/tu_dataset.py`` against the JAX package's, on the CPU:
``FakeDataset`` (node and graph tasks, edge attributes) and
``planetoid_like`` bitwise, edge order included; ``TUDataset`` over TU
raw files written here (node labels, attributes, edge labels, graph
labels that need renumbering; and ``chip_smoke.py::proteins_like``'s at a
small size), parsed to the same ``Data`` field for field, with and without
``use_node_attr``, again from the processed file; the ``Dataset`` protocol
(slices, lists, shuffle, transforms, ``pre_filter`` / ``pre_transform``,
the missing-raw-file error) against the JAX package's; the exports of
``datasets``.

Every comparison is exact: values, dtypes and shapes."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from pytorch_geometric_tpu import datasets as jds
from pytorch_geometric_tpu.data import dataset as jdataset
from pytorch_geometric_tpu_torch import datasets as tds
from pytorch_geometric_tpu_torch.data import dataset as tdataset

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _same_data(got, want, what=''):
    assert got.num_nodes == want.num_nodes, what
    assert sorted(got.keys()) == sorted(want.keys()), what
    for k in want.keys():
        g = got[k].numpy()
        w = np.asarray(want[k].coo if hasattr(want[k], 'coo') else want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f'{what} {k}')


@pytest.mark.parametrize('task,edge_dim', [('node', 0), ('graph', 3)])
def test_fake_dataset_matches_jax(task, edge_dim):
    kw = dict(num_graphs=3, avg_num_nodes=20, avg_degree=3, num_channels=4,
              num_classes=3, task=task, seed=7, edge_dim=edge_dim)
    want, got = jds.FakeDataset(**kw), tds.FakeDataset(**kw)
    assert len(got) == len(want) == 3
    for i in range(3):
        _same_data(got[i], want[i], f'graph {i}')
    sub = got[[2, 0]]
    assert len(sub) == 2
    _same_data(sub[0], want[2], 'list index')


def test_planetoid_like_matches_jax():
    kw = dict(num_nodes=60, num_edges=240, num_features=8, num_classes=3,
              train_per_class=4, num_val=10, num_test=20, seed=3)
    _same_data(tds.planetoid_like(**kw), jds.planetoid_like(**kw))


def _write_tu(raw: Path, name: str, rng):
    """A small TU dataset: 4 graphs, node labels 1-3, 2 attributes, edge
    labels 2-4, graph labels -1 / 5 / 9 (renumbered 0 / 1 / 2)."""
    sizes = [5, 3, 6, 4]
    off = np.concatenate([[0], np.cumsum(sizes)])
    edges = []
    for g, n in enumerate(sizes):
        for _ in range(2 * n):
            a, b = rng.integers(0, n, 2)
            edges.append((off[g] + a + 1, off[g] + b + 1))
    edges = np.array(edges)
    raw.mkdir(parents=True)
    files = {
        'A': (edges, '%d'),
        'graph_indicator': (np.repeat(np.arange(1, 5), sizes), '%d'),
        'graph_labels': (np.array([5, -1, 9, 5]), '%d'),
        'node_labels': (rng.integers(1, 4, sum(sizes)), '%d'),
        'node_attributes': (rng.standard_normal((sum(sizes), 2)), '%.5f'),
        'edge_labels': (rng.integers(2, 5, len(edges)), '%d')}
    for suffix, (arr, fmt) in files.items():
        np.savetxt(raw / f'{name}_{suffix}.txt', arr, fmt=fmt,
                   delimiter=', ')


@pytest.mark.parametrize('use_node_attr', [False, True])
def test_tu_dataset_matches_jax(tmp_path, use_node_attr):
    """Both packages parse the same raw files to the same graphs; a second
    instance reads the port's processed file back to the same graphs."""
    _write_tu(tmp_path / 'toy' / 'raw', 'toy', np.random.default_rng(9))
    want = jds.TUDataset(str(tmp_path), 'toy', use_node_attr=use_node_attr)
    got = tds.TUDataset(str(tmp_path), 'toy', use_node_attr=use_node_attr)
    again = tds.TUDataset(str(tmp_path), 'toy',
                          use_node_attr=use_node_attr)
    assert (tmp_path / 'toy' / 'processed' / 'data.pt').exists()
    assert len(got) == len(want) == len(again) == 4
    for i in range(4):
        _same_data(got[i], want[i], f'graph {i}')
        _same_data(again[i], want[i], f'graph {i} reloaded')
    assert got.num_classes == want.num_classes == 3
    assert got.num_features == want.num_features == 3 + 2 * use_node_attr


def test_proteins_like_parses_the_same_on_both(tmp_path):
    """``chip_smoke.py::proteins_like`` (path AC's raw files) at 40 graphs:
    its published shape scaled down (sizes, the largest graph, the pair
    count exact), parsed by both packages to the same graphs."""
    cs = _chip_smoke()
    sizes = cs.proteins_like(str(tmp_path), 4, graphs=40, nodes=1500,
                             pairs=2800, largest=90)
    assert sizes.sum() == 1500 and sizes.max() == 90 and len(sizes) == 40
    want = jds.TUDataset(str(tmp_path), 'PROTEINS_full', use_node_attr=True)
    got = tds.TUDataset(str(tmp_path), 'PROTEINS_full', use_node_attr=True)
    assert len(got) == 40
    assert sum(d.num_edges for d in got) == 2 * 2800
    for i in range(40):
        _same_data(got[i], want[i], f'graph {i}')
        coo = got[i].edge_index.numpy()
        assert (coo[0] != coo[1]).all()
        pairs = set(map(tuple, coo.T.tolist()))
        assert all((b, a) in pairs for a, b in pairs)
    assert got[0].x.shape[1] == 32 and got.num_classes == 2


def _toy(base, data_cls):
    """The same toy dataset on either package: its raw file written by
    ``download``, graph ``i`` with ``i + 2`` nodes."""

    class Toy(base):
        @property
        def raw_file_names(self):
            return ['toy.txt']

        def download(self):
            (Path(self.raw_dir) / 'toy.txt').write_text('4\n')

        def process(self):
            n = int((Path(self.raw_dir) / 'toy.txt').read_text())
            self.save([data_cls(x=np.full((i + 2, 1), float(i), np.float32),
                                edge_index=np.zeros((2, 0), np.int32),
                                y=np.array([i % 2]), num_nodes=i + 2)
                       for i in range(n)])

    return Toy


def test_dataset_protocol_matches_jax(tmp_path):
    """``download`` runs when a raw file is missing; access by int, slice,
    list and iteration; ``shuffle`` by seed; ``transform`` at access,
    ``pre_filter`` and ``pre_transform`` before the save."""
    from pytorch_geometric_tpu.data import Data as JData
    from pytorch_geometric_tpu_torch.data import Data as TData
    kw = dict(transform=lambda d: d.replace(z=np.ones(1, np.float32)),
              pre_filter=lambda d: d.num_nodes != 3,
              pre_transform=lambda d: d.replace(w=np.arange(2)))
    want = _toy(jdataset.InMemoryDataset, JData)(str(tmp_path / 'jax'), **kw)
    got = _toy(tdataset.InMemoryDataset, TData)(str(tmp_path / 'port'),
                                                 **kw)
    assert len(got) == len(want) == 3
    assert got.num_classes == want.num_classes
    for g, w in zip(got[1:], want[1:]):
        _same_data(g, w)
    for g, w in zip(got[[2, 0]], want[[2, 0]]):
        _same_data(g, w)
    for g, w in zip(got.shuffle(5), want.shuffle(5)):
        _same_data(g, w)
    for g, w in zip(got, want):
        _same_data(g, w)
    assert repr(got) == repr(want)


def test_missing_raw_files_raise(tmp_path):
    for pkg in (jds, tds):
        with pytest.raises(RuntimeError, match='raw files missing'):
            pkg.TUDataset(str(tmp_path / pkg.__name__), 'NONE')


def test_datasets_exports():
    """The port's ``datasets`` exports what it ports, each under the JAX
    package's name: the first modules and those of the datasets slice."""
    assert {'FakeDataset', 'planetoid_like', 'TUDataset', 'Planetoid',
            'Amazon', 'Reddit', 'NELL', 'CitationFull', 'SNAPDataset',
            'KarateClub', 'ExplainerDataset'} <= set(tds.__all__)
    assert set(tds.__all__) <= set(jds.__all__)
    assert all(hasattr(tds, n) for n in tds.__all__)
