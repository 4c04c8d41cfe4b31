"""The port's partitioner and Cluster-GCN loaders (``loader/cluster.py`` on
the port's build of ``csrc/partition.cpp``, ``utils/reorder.py::
cluster_order``) against the JAX package's, on the CPU.

The same graphs, made from a numpy seed by ``benchmarks/partition_quality.
py``'s SBM and power-law generators at small size, go into both packages:
``partition_graph`` (native and numpy multilevel, LDG), ``select_hubs``,
``partition_graph_hubs``, ``edge_cut``, ``effective_edge_cut`` and
``cluster_order`` must be equal bit for bit; ``ClusterData``'s partition
and every ``ClusterLoader`` batch (``n_id``, ``e_id``, ``edge_index``,
``x``, ``y``, ``edge_attr`` and the masks, field for field and dtype for
dtype), shuffled under a seed. The native paths are held against the JAX
package's native build, the numpy paths against its numpy pipeline
(``PGT_DISABLE_NATIVE_PARTITION``, the switch both packages read).

Also: three Adam steps of the JAX package's Cluster-GCN example
(``examples/cluster_gcn.py``: GCN, mean cross-entropy, optax Adam 0.01) and
of ``chip_smoke.py``'s path T model (GraphSAGE over the batch's training
nodes, Adam 0.005) against the port's on the same batches from the same
weights, losses within 1e-5 relative; and ``chip_smoke.py``'s Reddit-shaped
generator at toy scale."""

import ctypes
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.loader import cluster as jcluster
from pytorch_geometric_tpu.nn.models import GCN as JGCN
from pytorch_geometric_tpu.nn.models import GraphSAGE as JGraphSAGE
from pytorch_geometric_tpu.utils import reorder as jreorder
from pytorch_geometric_tpu_torch import EdgeIndex, csrc
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.loader import (ClusterData, ClusterLoader,
                                                cluster)
from pytorch_geometric_tpu_torch.nn.models import GCN, GraphSAGE
from pytorch_geometric_tpu_torch.utils import cluster_order

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'pytorch_geometric_tpu_torch'


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PQ = _load('partition_quality_under_test', 'benchmarks/partition_quality.py')


def _graphs():
    rng = np.random.default_rng(0)
    sbm = PQ.sbm_graph(rng, n=1500, blocks=10, p_in=0.03, p_out=0.0005)
    power = PQ.power_law_graph(np.random.default_rng(1), n=900, m=4)
    return {'sbm': sbm, 'power_law': power}


GRAPHS = _graphs()


@pytest.fixture(params=['native', 'numpy'])
def path(request, monkeypatch):
    """Both packages on their native partitioner, or both on numpy."""
    if request.param == 'native':
        assert csrc.partition_library() is not None
        monkeypatch.delenv('PGT_DISABLE_NATIVE_PARTITION', raising=False)
    else:
        monkeypatch.setenv('PGT_DISABLE_NATIVE_PARTITION', '1')
    return request.param


def _eq(got, ref, what=''):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (
        what, got.dtype, ref.dtype, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize('graph', sorted(GRAPHS))
@pytest.mark.parametrize('parts,seed', [(8, 0), (5, 3)])
def test_partition_graph_matches_jax(path, graph, parts, seed):
    coo, n = GRAPHS[graph]
    got = cluster.partition_graph(coo, n, parts, seed=seed)
    ref = jcluster.partition_graph(coo, n, parts, seed=seed)
    _eq(got, ref, f'{path} {graph}')
    assert len(np.unique(got)) == parts
    # the port takes a tensor or an EdgeIndex as well as an array
    _eq(cluster.partition_graph(torch.from_numpy(coo), n, parts, seed=seed),
        ref)
    _eq(cluster.partition_graph(EdgeIndex(coo, (n, n), device='cpu'), n,
                                parts, seed=seed), ref)


@pytest.mark.parametrize('graph', sorted(GRAPHS))
def test_ldg_and_tiny_graphs_match_jax(graph):
    coo, n = GRAPHS[graph]
    _eq(cluster.partition_graph(coo, n, 6, method='ldg', seed=2),
        jcluster.partition_graph(coo, n, 6, method='ldg', seed=2))
    # no more nodes than parts: the LDG sweep as well
    small = coo[:, (coo[0] < 12) & (coo[1] < 12)]
    _eq(cluster.partition_graph(small, 12, 16),
        jcluster.partition_graph(small, 12, 16))


def test_numpy_pipeline_without_the_library(monkeypatch):
    """No partitioner library (no ``g++``): the numpy pipeline runs and cuts
    the JAX package's numpy partition."""
    coo, n = GRAPHS['sbm']
    monkeypatch.setattr(csrc, 'partition_library', lambda: None)
    got = cluster.partition_graph(coo, n, 8)
    monkeypatch.setenv('PGT_DISABLE_NATIVE_PARTITION', '1')
    _eq(got, jcluster.partition_graph(coo, n, 8))


@pytest.mark.parametrize('graph', sorted(GRAPHS))
@pytest.mark.parametrize('hubs', [{'hub_frac': 0.02},
                                  {'hub_threshold': 30}])
def test_hubs_and_cuts_match_jax(path, graph, hubs):
    coo, n = GRAPHS[graph]
    _eq(cluster.select_hubs(coo, n, **hubs),
        jcluster.select_hubs(coo, n, **hubs))
    parts, hub = cluster.partition_graph_hubs(coo, n, 6, seed=1, **hubs)
    jparts, jhub = jcluster.partition_graph_hubs(coo, n, 6, seed=1, **hubs)
    _eq(parts, jparts, 'parts')
    _eq(hub, jhub, 'hub mask')
    assert cluster.edge_cut(coo, parts) == jcluster.edge_cut(coo, jparts)
    assert (cluster.effective_edge_cut(coo, parts, hub)
            == jcluster.effective_edge_cut(coo, jparts, jhub))
    # a graph of self loops only cuts nothing
    loops = np.stack([np.arange(5), np.arange(5)])
    assert cluster.edge_cut(loops, np.arange(5)) == 0.0
    assert cluster.effective_edge_cut(loops, np.arange(5),
                                      np.zeros(5, bool)) == 0.0


@pytest.mark.parametrize('graph', sorted(GRAPHS))
def test_cluster_order_matches_jax(path, graph):
    coo, n = GRAPHS[graph]
    for block in (128, 300):
        _eq(cluster_order(coo, n, block), jreorder.cluster_order(coo, n,
                                                                 block))


def _data(graph, seed=0):
    coo, n = GRAPHS[graph]
    rng = np.random.default_rng(seed)
    fields = dict(
        x=rng.standard_normal((n, 5)).astype(np.float32),
        edge_index=coo.astype(np.int32),
        edge_attr=rng.standard_normal((coo.shape[1], 2)).astype(np.float32),
        y=rng.integers(0, 4, n),
        train_mask=rng.random(n) < 0.6, val_mask=rng.random(n) < 0.2,
        test_mask=rng.random(n) < 0.2)
    return JData(num_nodes=n, **fields), Data(num_nodes=n, **fields)


def _batch_equal(got, ref):
    assert sorted(got.keys()) == sorted(ref.keys())
    assert got.num_nodes == ref.num_nodes
    for k in ref.keys():
        _eq(got[k], ref[k], k)


@pytest.mark.parametrize('graph', sorted(GRAPHS))
@pytest.mark.parametrize('batch_size,shuffle,seed', [(1, False, 0),
                                                     (3, True, 0),
                                                     (4, True, 5)])
def test_cluster_loader_matches_jax(path, graph, batch_size, shuffle, seed):
    jdata, data = _data(graph, seed)
    jcd = jcluster.ClusterData(jdata, 10, seed=seed)
    cd = ClusterData(data, 10, seed=seed)
    for f in ('partptr', 'node_perm', 'parts'):
        _eq(getattr(cd.partition, f), getattr(jcd.partition, f), f)
    _eq(cd._inv, jcd._inv)
    assert len(cd) == len(jcd) == 10
    _batch_equal(cd[3], jcd[3])
    loader = ClusterLoader(cd, batch_size=batch_size, shuffle=shuffle,
                           seed=seed)
    jloader = jcluster.ClusterLoader(jcd, batch_size=batch_size,
                                     shuffle=shuffle, seed=seed)
    assert len(loader) == len(jloader)
    for _ in range(2):                      # two epochs: the rng moves on
        got, ref = list(loader), list(jloader)
        assert len(got) == len(ref) == len(loader)
        for g, r in zip(got, ref):
            _batch_equal(g, r)


def test_cluster_data_gathers_where_the_features_lie():
    """``subgraph`` gathers x, y and the masks on the device of the
    ``Data``'s tensors (here the CPU's; ``meta`` tensors stay ``meta``),
    never through numpy."""
    _, data = _data('sbm')
    meta = data.replace(x=data.x.to('meta'), y=data.y.to('meta'),
                        train_mask=data.train_mask.to('meta'))
    batch = ClusterData(meta, 6)[2]
    assert batch.x.device.type == 'meta' and batch.y.device.type == 'meta'
    assert batch.train_mask.device.type == 'meta'
    assert batch.x.shape == (int(batch.n_id.shape[0]), 5)
    assert batch.edge_index.device.type == 'cpu'


def test_partitioner_is_the_ports_own_build():
    """The partitioner library is built from the port's copy of
    ``partition.cpp`` into the port's build directory (never the JAX
    package's ``csrc.load()``), keyed by host like the sampler's, with the
    JAX package's argument types bound; its source is the JAX package's
    below its header comment."""
    lib = csrc.partition_library()
    assert type(lib) is ctypes.CDLL
    path = csrc.host_path(csrc.PARTITION_SOURCE)
    assert path.parent == PKG / '_build' and path.is_file()
    assert path.name.startswith('libpartition-')
    assert path != csrc.sampler_path()
    assert [t.__name__ for t in lib.multilevel_partition.argtypes] == [
        'LP_c_long', 'LP_c_long', 'LP_c_double', 'c_long', 'c_long',
        'c_ulong', 'c_double', 'LP_c_int']
    port = (PKG / 'csrc' / 'partition.cpp').read_text()
    jax_src = (ROOT / 'pytorch_geometric_tpu' / 'csrc' /
               'partition.cpp').read_text()
    body = jax_src[jax_src.index('#include'):]
    assert port.endswith(body)
    assert csrc.HOST_FLAGS[:2] == ('-O3', '-march=native')


# -- training steps --------------------------------------------------------------
STEPS = 3


def _jax_steps(model, params, tx, batches, loss_of):
    opt = tx.init(params)
    losses = []
    for b in batches:
        loss, g = jax.value_and_grad(loss_of)(params, *b)
        upd, opt = tx.update(g, opt)
        params = optax.apply_updates(params, upd)
        losses.append(float(loss))
    return losses


def _port_steps(model, lr, batches, loss_of):
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses = []
    for b in batches:
        opt.zero_grad(set_to_none=True)
        loss = loss_of(*b)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def test_cluster_gcn_example_steps_match_jax():
    """``examples/cluster_gcn.py``'s step (GCN 64 x 2 -> 10 over each
    cluster batch's raw COO, mean cross-entropy, Adam 0.01), three batches
    of a shuffled ``ClusterLoader``, in both packages."""
    coo, n = GRAPHS['sbm']
    rng = np.random.default_rng(7)
    fields = dict(x=rng.standard_normal((n, 16)).astype(np.float32),
                  edge_index=coo.astype(np.int32),
                  y=rng.integers(0, 10, n))
    jb = list(jcluster.ClusterLoader(jcluster.ClusterData(
        JData(num_nodes=n, **fields), 16), batch_size=4, shuffle=True,
        seed=0))[:STEPS]
    tb = list(ClusterLoader(ClusterData(Data(num_nodes=n, **fields), 16),
                            batch_size=4, shuffle=True, seed=0))[:STEPS]
    jm = JGCN(hidden_channels=64, num_layers=2, out_channels=10)
    jbatches = [(jnp.asarray(np.asarray(b.x)),
                 jnp.asarray(np.asarray(b.edge_index)),
                 jnp.asarray(np.asarray(b.y))) for b in jb]
    params = jm.init(jax.random.PRNGKey(0), *jbatches[0][:2])

    def jloss(p, x, ei, y):
        return optax.softmax_cross_entropy_with_integer_labels(
            jm.apply(p, x, ei), y).mean()

    ref = _jax_steps(jm, params, optax.adam(0.01), jbatches, jloss)
    tm = GCN(16, 64, 2, 10, device='cpu')
    tm.load_state_dict(flax_to_state_dict(params))
    got = _port_steps(tm, 0.01, [(b.x, b.edge_index, b.y.long())
                                 for b in tb],
                      lambda x, ei, y: F.cross_entropy(tm(x, ei), y))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_path_t_steps_match_jax():
    """``chip_smoke.py``'s path T step at toy width: GraphSAGE over each
    batch's ``EdgeIndex`` (the segment-sum SpMM's plain version on the CPU),
    cross-entropy over the batch's training nodes, Adam 0.005, against the
    JAX package's GraphSAGE with optax Adam on the same batches."""
    jdata, data = _data('power_law', 4)
    jb = list(jcluster.ClusterLoader(jcluster.ClusterData(jdata, 12),
                                     batch_size=3, shuffle=True))[:STEPS]
    tb = list(ClusterLoader(ClusterData(data, 12), batch_size=3,
                            shuffle=True))[:STEPS]
    jm = JGraphSAGE(hidden_channels=16, num_layers=2, out_channels=4)
    jbatches = [(jnp.asarray(np.asarray(b.x)),
                 jnp.asarray(np.asarray(b.edge_index)),
                 jnp.asarray(np.asarray(b.y)),
                 jnp.asarray(np.asarray(b.train_mask), jnp.float32))
                for b in jb]
    params = jm.init(jax.random.PRNGKey(1), *jbatches[0][:2])

    def jloss(p, x, ei, y, m):
        ce = optax.softmax_cross_entropy_with_integer_labels(
            jm.apply(p, x, ei), y)
        return (ce * m).sum() / m.sum()

    ref = _jax_steps(jm, params, optax.adam(0.005), jbatches, jloss)
    tm = GraphSAGE(5, 16, 2, 4, device='cpu')
    tm.load_state_dict(flax_to_state_dict(params))

    def tloss(x, ei, y, m):
        ce = F.cross_entropy(tm(x, ei), y, reduction='none')
        return (ce * m).sum() / m.sum()

    batches = []
    for b in tb:
        nb = b.num_nodes
        ei = EdgeIndex(b.edge_index, (nb, nb), device='cpu').fill_cache(
            blocked=False)
        batches.append((b.x, ei, b.y.long(), b.train_mask.float()))
    got = _port_steps(tm, 0.005, batches, tloss)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_chip_smoke_reddit_generator():
    """``chip_smoke.py::reddit_like`` at toy scale: Reddit's counts scaled,
    every pair stored in both directions, no self loop, most pairs inside
    a community; labels and training mask of the right sizes."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for scale, seed in ((0.002, 0), (0.004, 3)):
        coo, y, train = cs.reddit_like(scale, seed)
        n = int(round(cs.REDDIT_NODES * scale))
        pairs = int(round(cs.REDDIT_PAIRS * scale))
        assert coo.dtype == np.int32 and coo.shape == (2, 2 * pairs)
        assert y.shape == (n,) and train.shape == (n,)
        assert int(train.sum()) == int(round(cs.REDDIT_TRAIN * scale))
        assert coo.min() >= 0 and coo.max() < n
        assert not (coo[0] == coo[1]).any()
        np.testing.assert_array_equal(coo[:, pairs:], coo[::-1, :pairs])
        assert y.min() >= 0 and y.max() < cs.REDDIT_C
        # same seed, same graph
        again = cs.reddit_like(scale, seed)
        np.testing.assert_array_equal(again[0], coo)
        np.testing.assert_array_equal(again[1], y)
    # at a scale with several communities, about 80 % of the pairs stay
    # inside one (plus the uniform pairs that land inside by chance)
    rng = np.random.default_rng(0)
    coo, comm = cs.community_graph(4000, 40_000, 100, 0.8, rng)
    inside = (comm[coo[0]] == comm[coo[1]]).mean()
    assert 0.79 < inside < 0.82
    assert not (coo[0] == coo[1]).any()
