"""The port's loaders against the JAX package's, on the CPU.

* ``NeighborLoader`` (both ``filter_features`` modes, ``num_workers`` 0 and
  2, shuffled and not, a boolean ``input_nodes``, ``drop_last``) and
  ``LinkNeighborLoader``: every field of every batch equal to the JAX
  package's, bit for bit and dtype for dtype, on the native sampler and on
  the numpy one (each package on its own of the same kind);
* ``PrefetchLoader`` on the CPU: the loader's batches in its order, plain
  and threaded, an error of the loader raised to the consumer, and a
  consumer that stops early stopping the producer thread; ``CachedLoader``;
* ``basic_gnn_inference``: GCN (with full-graph ``edge_weight``) and
  GraphSAGE, the JAX package's weights carried across by
  ``convert.flax_to_state_dict``, within 1e-5 of the JAX package's result
  (float32 sums in another order), and, with every node's whole
  neighbourhood sampled, within 1e-5 of the full-graph forward."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_geometric_tpu.csrc as jcsrc
from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.loader import (
    LinkNeighborLoader as JLinkNeighborLoader,
    NeighborLoader as JNeighborLoader)
from pytorch_geometric_tpu.nn.models import (GCN as JGCN,
                                             GraphSAGE as JGraphSAGE,
                                             basic_gnn_inference as
                                             jbasic_gnn_inference)
from pytorch_geometric_tpu_torch import EdgeIndex, csrc
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.loader import (CachedLoader,
                                                LinkNeighborLoader,
                                                NeighborLoader,
                                                PrefetchLoader)
from pytorch_geometric_tpu_torch.nn.models import (GCN, GraphSAGE,
                                                   basic_gnn_inference)

N, E, F = 200, 1100, 6


@pytest.fixture(params=['native', 'numpy'])
def path(request, monkeypatch):
    """Both packages on the native sampler, or both on their numpy one."""
    native = request.param == 'native'
    if native:
        assert jcsrc.WITH_NATIVE_SAMPLER and csrc.WITH_NATIVE_SAMPLER
    monkeypatch.setattr(jcsrc, 'WITH_NATIVE_SAMPLER', native)
    monkeypatch.setattr(csrc, 'WITH_NATIVE_SAMPLER', native)
    return request.param


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    fields = dict(
        x=rng.standard_normal((N, F)).astype(np.float32),
        edge_index=np.stack([rng.integers(0, N, E),
                             rng.integers(0, N, E)]).astype(np.int32),
        edge_attr=rng.standard_normal((E, 2)).astype(np.float32),
        y=rng.integers(0, 4, N))
    return JData(num_nodes=N, **fields), Data(num_nodes=N, **fields), rng


def _batches_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g.keys()) == sorted(r.keys())
        assert g.num_nodes == r.num_nodes
        for k in r.keys():
            a, b = g[k].numpy(), np.asarray(r[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                               b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize('workers', [0, 2])
@pytest.mark.parametrize('filter_features', [True, False])
@pytest.mark.parametrize('shuffle', [False, True])
def test_neighbor_loader_matches_jax(path, workers, filter_features,
                                     shuffle):
    jdata, data, _ = _graph(1)
    kw = dict(num_neighbors=[4, 3], batch_size=48, shuffle=shuffle, seed=7,
              num_workers=workers, filter_features=filter_features)
    ref = list(JNeighborLoader(jdata, **kw))
    loader = NeighborLoader(data, **kw)
    got = list(loader)
    assert len(loader) == len(ref) == 5
    _batches_equal(got, ref)
    assert got[-1].batch_size.item() == N - 4 * 48


def test_neighbor_loader_threads_under_stress():
    """More sampling threads than cores, switching every microsecond:
    the batches come in order and equal the serial loader's, bit for bit
    (each batch draws from its own seed; the native library is built once,
    under a lock)."""
    import os
    import sys
    _, data, _ = _graph(8)
    kw = dict(num_neighbors=[6, 4], batch_size=8, shuffle=True, seed=11)
    serial = list(NeighborLoader(data, **kw))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threaded = list(NeighborLoader(
            data, num_workers=2 * (os.cpu_count() or 4), **kw))
    finally:
        sys.setswitchinterval(interval)
    assert len(threaded) == len(serial) == N // 8
    for a, b in zip(threaded, serial):
        for k in b.keys():
            assert torch.equal(a[k], b[k]), k


def test_neighbor_loader_inputs_match_jax(path):
    """A boolean ``input_nodes`` mask (as a tensor), ``drop_last``, a
    replacement draw and the seeds' features gathered by ``n_id``."""
    jdata, data, rng = _graph(2)
    mask = rng.random(N) < 0.4
    kw = dict(num_neighbors=[5], batch_size=16, shuffle=True, seed=3,
              drop_last=True, replace=path == 'native')
    ref = list(JNeighborLoader(jdata, input_nodes=mask, **kw))
    got = list(NeighborLoader(data, input_nodes=torch.from_numpy(mask),
                              **kw))
    assert len(got) == mask.sum() // 16
    _batches_equal(got, ref)
    b = got[0]
    nm = b.node_mask.numpy()
    np.testing.assert_array_equal(
        b.x.numpy()[nm], jdata.x[np.asarray(b.n_id)[nm]])


@pytest.mark.parametrize('neg', [0.0, 1.0])
def test_link_neighbor_loader_matches_jax(path, neg):
    jdata, data, rng = _graph(3)
    label = rng.integers(0, 2, E).astype(np.float32)
    kw = dict(num_neighbors=[3, 2], neg_sampling_ratio=neg, batch_size=64,
              shuffle=True, seed=2)
    ref = list(JLinkNeighborLoader(jdata, edge_label=label, **kw))
    got = list(LinkNeighborLoader(data, edge_label=label, **kw))
    assert len(got) == -(-E // 64)
    _batches_equal(got, ref)


def test_prefetch_loader_keeps_order_and_raises():
    _, data, _ = _graph(4)

    def mk():
        return NeighborLoader(data, num_neighbors=[4, 4], batch_size=64,
                              seed=0)

    plain = [b.n_id for b in mk()]
    for kw in ({}, {'num_threads': 1}, {'num_threads': 2, 'queue_size': 1},
               {'put': False, 'num_threads': 1}):
        loader = PrefetchLoader(mk(), device='cpu', **kw)
        assert len(loader) == len(plain)
        got = [b.n_id for b in loader]
        assert len(got) == len(plain)
        for a, b in zip(got, plain):
            assert torch.equal(a, b)

    class Boom:
        def __iter__(self):
            yield {'x': np.ones(3)}
            raise RuntimeError('sampler exploded')

    for threads in (0, 1):
        with pytest.raises(RuntimeError, match='exploded'):
            list(PrefetchLoader(Boom(), device='cpu', num_threads=threads))
    # a numpy leaf becomes a tensor on the way, as device_put makes it one
    got = list(PrefetchLoader([{'x': np.ones(3)}], device='cpu'))
    assert isinstance(got[0]['x'], torch.Tensor)


def test_prefetch_loader_abandoned_stops_its_producer():
    """A consumer that stops after one batch of an endless loader: the
    producer thread notices within its put timeout and ends."""
    made = []

    class Endless:
        def __iter__(self):
            while True:
                made.append(1)
                yield {'i': torch.tensor(len(made))}

    before = threading.active_count()
    it = iter(PrefetchLoader(Endless(), device='cpu', num_threads=1,
                             queue_size=2))
    assert int(next(it)['i']) == 1
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    # bounded: the producer ran at most the queue's depth plus a few ahead
    assert len(made) <= 5


def test_cached_loader_keeps_the_first_pass():
    _, data, _ = _graph(5)
    loader = NeighborLoader(data, num_neighbors=[3], batch_size=50,
                            shuffle=True, seed=1)
    calls = []
    cached = CachedLoader(loader, transform=lambda b: calls.append(1) or b,
                          device='cpu')
    first = [b.n_id for b in cached]
    second = [b.n_id for b in cached]
    assert len(calls) == len(loader) == 4
    assert all(a is b for a, b in zip(first, second))
    cached.clear()
    assert [b.n_id for b in cached][0] is not first[0]


# -- layer-wise inference ------------------------------------------------------
def _gcn_case():
    """The JAX package's test_wave5 protocol: cached full-graph GCN norms on
    the raw edges, a 2-layer GCN without its own normalisation."""
    from pytorch_geometric_tpu.nn import gcn_norm
    rng = np.random.default_rng(6)
    n = 150
    coo = np.stack([rng.integers(0, n, 900), rng.integers(0, n, 900)])
    x = rng.standard_normal((n, 8)).astype(np.float32)
    coo_n, w = gcn_norm(jnp.asarray(coo.astype(np.int32)), None, n)
    coo_n, w = np.asarray(coo_n), np.asarray(w)
    kw = {'normalize': False, 'add_self_loops': False}
    jm = JGCN(hidden_channels=16, num_layers=2, out_channels=3,
              conv_kwargs=kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), coo_n,
                     edge_weight=w)
    model = GCN(8, 16, 2, 3, conv_kwargs=kw, device='cpu')
    return jm, params, model, x, coo_n, w, n


def _sage_case():
    rng = np.random.default_rng(7)
    n = 160
    coo = np.stack([rng.integers(0, n, 1000),
                    rng.integers(0, n, 1000)]).astype(np.int32)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    jm = JGraphSAGE(hidden_channels=16, num_layers=2, out_channels=3,
                    norm='layer_norm')
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), coo)
    model = GraphSAGE(8, 16, 2, 3, norm='layer_norm', device='cpu')
    return jm, params, model, x, coo, None, n


@pytest.mark.parametrize('case', [_gcn_case, _sage_case])
@pytest.mark.parametrize('fanout', [4, 'all'])
def test_basic_gnn_inference_matches_jax(case, fanout):
    jm, params, model, x, coo, w, n = case()
    model.load_state_dict(flax_to_state_dict(params))
    k = n if fanout == 'all' else fanout
    ref = np.asarray(jbasic_gnn_inference(
        jm, params, JData(x=x, edge_index=coo, num_nodes=n), batch_size=32,
        num_neighbors_per_layer=k, edge_weight=w))
    got = basic_gnn_inference(model, Data(x=x, edge_index=coo, num_nodes=n),
                              batch_size=32, num_neighbors_per_layer=k,
                              edge_weight=w)
    assert got.shape == ref.shape == (n, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    if fanout == 'all':
        # every neighbourhood whole: the full-graph forward
        ei = EdgeIndex(coo, (n, n), device='cpu').fill_cache(blocked=False)
        kw = {} if w is None else {'edge_weight': torch.from_numpy(w)}
        with torch.no_grad():
            full = model(torch.from_numpy(x), ei, **kw)
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, float(
                                       full.abs().max())))


def test_basic_gnn_inference_refuses_jk():
    model = GraphSAGE(4, 8, 2, 3, jk='cat', device='cpu')
    data = Data(x=np.zeros((5, 4), np.float32),
                edge_index=np.array([[0, 1], [1, 2]]), num_nodes=5)
    with pytest.raises(ValueError, match='jk=None'):
        basic_gnn_inference(model, data)
