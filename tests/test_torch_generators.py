"""The port's synthetic generators (``datasets/generators.py``,
``datasets/graph_generator``, ``datasets/motif_generator``) against the
JAX package's, on the CPU: the same seed gives the same graphs bit for bit,
values, dtypes, shapes and edge order, in every class and form (the
legacy and the generator-object ``ExplainerDataset``, a networkx motif,
the heterogeneous fake graphs); the generator objects draw the next seed's
graph on each call, and resolve by name as the JAX package's do."""

import networkx as nx
import numpy as np
import pytest

from pytorch_geometric_tpu import datasets as jds
from pytorch_geometric_tpu.datasets import graph_generator as jgg
from pytorch_geometric_tpu.datasets import motif_generator as jmg
from pytorch_geometric_tpu_torch import datasets as tds
from pytorch_geometric_tpu_torch.datasets import graph_generator as tgg
from pytorch_geometric_tpu_torch.datasets import motif_generator as tmg


def _same_data(got, want, what=''):
    assert type(got).__name__ == type(want).__name__, what
    assert got.num_nodes == want.num_nodes, what
    assert sorted(got.keys()) == sorted(want.keys()), what
    for k in want.keys():
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f'{what} {k}')


def _same_dataset(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        _same_data(got[i], want[i], f'graph {i}')


DATASETS = {
    'karate': ('KarateClub', {}),
    'sbm': ('StochasticBlockModelDataset',
            dict(block_sizes=[20, 30, 15],
                 edge_probs=[[0.3, 0.02, 0.05], [0.02, 0.25, 0.01],
                             [0.05, 0.01, 0.4]], num_channels=5, seed=4)),
    'explainer legacy': ('ExplainerDataset',
                         dict(num_nodes=60, num_motifs=7, seed=2)),
    'ba shapes': ('BAShapes', dict(num_base_nodes=50, num_motifs=6, seed=3)),
    'ba 2 motif': ('BA2MotifDataset', dict(num_graphs=6, seed=5)),
    'ba multi shapes': ('BAMultiShapesDataset', dict(num_graphs=4, seed=1)),
    'infection': ('InfectionDataset',
                  dict(num_nodes=80, edge_prob=0.05, num_infected=6,
                       max_path_length=3, seed=7)),
    'mixhop': ('MixHopSyntheticDataset',
               dict(homophily=0.3, num_nodes=90, num_classes=3, seed=8)),
    'random partition': ('RandomPartitionGraphDataset',
                         dict(num_classes=4, num_nodes_per_class=15,
                              node_homophily_ratio=0.7, seed=9)),
}


@pytest.mark.parametrize('case', sorted(DATASETS))
def test_generated_datasets_match_jax(case):
    name, kw = DATASETS[case]
    _same_dataset(getattr(tds, name)(**kw), getattr(jds, name)(**kw))


def _motif(pkg, which):
    mg = tmg if pkg == 'port' else jmg
    if which == 'networkx':
        return mg.CustomMotif(nx.cycle_graph(4))
    if which == 'cycle':
        return mg.CycleMotif(5)
    if which == 'grid':
        return mg.GridMotif()
    return which


@pytest.mark.parametrize('graph,motif', [
    ('ba', 'house'), ('er', 'cycle'), ('ba', 'grid'), ('tree', 'networkx'),
    ('grid', 'house')])
def test_explainer_generator_form_matches_jax(graph, motif):
    """``ExplainerDataset(graph_generator, motif_generator, num_motifs)``:
    the base graph and the attached motifs, masks and labels."""
    def make(pkg):
        gg = tgg if pkg == 'port' else jgg
        base = {'ba': lambda: gg.BAGraph(40, 2, seed=3),
                'er': lambda: gg.ERGraph(30, 0.1, seed=4),
                'tree': lambda: gg.TreeGraph(4, 2, undirected=True),
                'grid': lambda: gg.GridGraph(5, 6)}[graph]()
        ds = tds if pkg == 'port' else jds
        return ds.ExplainerDataset(base, motif_generator=_motif(pkg, motif),
                                   num_motifs=5, seed=6)
    _same_dataset(make('port'), make('jax'))


def test_graph_generators_match_jax():
    """Each call draws the next seed's graph; ``resolve`` by name, class or
    instance; the tree in both orientations; the grid's positions."""
    for cls, args in (('BAGraph', (30, 3)), ('ERGraph', (25, 0.2))):
        got, want = getattr(tgg, cls)(*args), getattr(jgg, cls)(*args)
        first = got()
        _same_data(first, want(), f'{cls} first')
        second = got()
        _same_data(second, want(), f'{cls} second')
        assert not np.array_equal(first.edge_index.numpy(),
                                  second.edge_index.numpy())
        assert repr(got) == repr(want)
    for undirected in (False, True):
        _same_data(tgg.TreeGraph(3, 3, undirected)(),
                   jgg.TreeGraph(3, 3, undirected)(), 'tree')
        e, d = tgg.tree(2, 4, undirected)
        je, jd = jgg.tree(2, 4, undirected)
        np.testing.assert_array_equal(e, je)
        np.testing.assert_array_equal(d, jd)
    _same_data(tgg.GridGraph(3, 4, dtype=np.float64)(),
               jgg.GridGraph(3, 4, dtype=np.float64)(), 'grid')
    for query in ('ba', 'bagraph', tgg.BAGraph):
        assert isinstance(tgg.GraphGenerator.resolve(query, 10, 2),
                          tgg.BAGraph)
    g = tgg.ERGraph(5, 0.5)
    assert tgg.GraphGenerator.resolve(g) is g
    with pytest.raises(ValueError, match='Could not resolve'):
        tgg.GraphGenerator.resolve('nothing')


def test_motif_generators_match_jax():
    for which in ('cycle', 'grid', 'networkx'):
        _same_data(_motif('port', which)(), _motif('jax', which)(), which)
    _same_data(tmg.HouseMotif()(), jmg.HouseMotif()(), 'house')
    assert isinstance(tmg.MotifGenerator.resolve('house'), tmg.HouseMotif)
    assert isinstance(tmg.MotifGenerator.resolve('cyclemotif', 4),
                      tmg.CycleMotif)
    assert repr(tmg.CycleMotif(6)) == repr(jmg.CycleMotif(6))
    with pytest.raises(ValueError, match="Expected a motif structure"):
        tmg.CustomMotif([1, 2])
    with pytest.raises(ValueError, match='motif_generator requires'):
        tds.ExplainerDataset(30, motif_generator='house')


def test_ba_graph_and_numeric_generators_match_jax():
    """``ba_graph`` over one ``rng``; the port's copies of the JAX
    package's ``utils/misc.py`` generators, directed and undirected."""
    from pytorch_geometric_tpu.utils import misc
    np.testing.assert_array_equal(
        tds.ba_graph(np.random.default_rng(3), 40, 3),
        jds.ba_graph(np.random.default_rng(3), 40, 3))
    for directed in (False, True):
        np.testing.assert_array_equal(
            tgg.erdos_renyi_graph(30, 0.1, directed, seed=2),
            misc.erdos_renyi_graph(30, 0.1, directed, seed=2))
        probs = [[0.3, 0.05], [0.05, 0.2]]
        np.testing.assert_array_equal(
            tgg.stochastic_blockmodel_graph([10, 14], probs, directed, 5),
            misc.stochastic_blockmodel_graph([10, 14], probs, directed, 5))
    np.testing.assert_array_equal(tgg.barabasi_albert_graph(25, 3, 4),
                                  misc.barabasi_albert_graph(25, 3, 4))
    for a, b in zip(tgg.grid(4, 3), misc.grid(4, 3)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_fake_hetero_dataset_matches_jax():
    kw = dict(num_graphs=2, num_node_types=3, num_edge_types=4,
              avg_num_nodes=20, avg_degree=3, num_channels=5, seed=11)
    got, want = tds.FakeHeteroDataset(**kw), jds.FakeHeteroDataset(**kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.node_types == w.node_types
        assert g.edge_types == w.edge_types
        for t in w.node_types:
            for k in ('x', 'y'):
                a = getattr(g[t], k).numpy()
                b = np.asarray(getattr(w[t], k))
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        for et in w.edge_types:
            np.testing.assert_array_equal(g[et].edge_index.numpy(),
                                          np.asarray(w[et].edge_index))


def test_transform_applies_once():
    """A generated single-graph dataset applies ``transform`` to its
    graph once, as the JAX package's does."""
    calls = []

    def tf(d):
        calls.append(1)
        return d.replace(z=np.ones(1, np.float32))
    ds = tds.KarateClub(transform=tf)
    assert len(ds) == 1 and ds[0].z is not None and ds[0] is ds[0]
    assert calls == [1]
