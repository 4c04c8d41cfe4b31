"""The port's random walks, GraphSAINT samplers and the convolutions of
Cluster-GCN and GraphSAINT against the JAX package's, on the CPU.

* ``random_walk`` (``nn/models/node2vec.py``; the port's native build of
  ``csrc/sampler.cpp``'s ``random_walk`` and the numpy path), unbiased and
  ``p`` / ``q``-biased, with dead ends: the walks bit for bit, each path
  against the JAX package's path of the same kind;
* ``GraphSAINTNodeSampler``, ``GraphSAINTEdgeSampler`` and
  ``GraphSAINTRandomWalkSampler`` (``loader/graph_saint.py``), with and
  without ``sample_coverage``: ``node_norm``, ``edge_norm`` and every batch
  (``n_id``, ``e_id``, ``edge_index``, ``x``, ``y``, the masks and the
  batch's norms), field for field and dtype for dtype;
* ``GraphConv`` and ``ClusterGCNConv`` (``nn/conv/graph_conv.py``): forward
  and gradients (input and every parameter) against the flax modules with
  their parameters carried across by ``convert.flax_to_state_dict``, over
  a raw COO and over an ``EdgeIndex`` (the weighted SpMM's plain version),
  rtol 1e-4 / atol 1e-5;
* three Adam steps of the JAX package's GraphSAINT example
  (``examples/graph_saint.py``: GraphSAGE, node-normalised cross-entropy,
  optax Adam 0.01) and of ``chip_smoke.py``'s path U model (GraphConv x 3,
  ``edge_norm / deg[col]`` weights, ``(nll * node_norm).sum()``, Adam
  0.001) against the port's, losses within 1e-5 relative;
* ``chip_smoke.py``'s Flickr-shaped generator at toy scale."""

import ctypes
import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import pytorch_geometric_tpu.csrc as jcsrc
from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.loader import graph_saint as jsaint
from pytorch_geometric_tpu.nn.conv import ClusterGCNConv as JClusterGCNConv
from pytorch_geometric_tpu.nn.conv import GraphConv as JGraphConv
from pytorch_geometric_tpu.nn.models import GraphSAGE as JGraphSAGE
from pytorch_geometric_tpu.nn.models import node2vec as jnode2vec
from pytorch_geometric_tpu_torch import EdgeIndex, csrc
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.loader import (GraphSAINTEdgeSampler,
                                                GraphSAINTNodeSampler,
                                                GraphSAINTRandomWalkSampler)
from pytorch_geometric_tpu_torch.nn.conv import ClusterGCNConv, GraphConv
from pytorch_geometric_tpu_torch.nn.models import GraphSAGE, random_walk
from pytorch_geometric_tpu_torch.nn.models import node2vec

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'pytorch_geometric_tpu_torch'
N, E = 300, 1800


@pytest.fixture(params=['native', 'numpy'])
def path(request, monkeypatch):
    """Both packages on their native random walk, or both on numpy (the
    JAX package walks natively whenever its ``csrc.load()`` gives a
    library)."""
    if request.param == 'native':
        assert jcsrc.load() is not None and csrc.WITH_NATIVE_SAMPLER
    else:
        monkeypatch.setattr(jcsrc, 'load', lambda: None)
        monkeypatch.setattr(csrc, 'WITH_NATIVE_SAMPLER', False)
    return request.param


def _eq(got, ref, what=''):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (
        what, got.dtype, ref.dtype, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _graph(seed=0, n=N, e=E, dead_ends=True):
    rng = np.random.default_rng(seed)
    coo = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    if dead_ends:
        # nodes 0-9 have no out-edge: a walk there stays put
        coo = coo[:, coo[0] >= 10]
    fields = dict(x=rng.standard_normal((n, 6)).astype(np.float32),
                  edge_index=coo.astype(np.int32), y=rng.integers(0, 3, n),
                  train_mask=rng.random(n) < 0.5,
                  val_mask=rng.random(n) < 0.25)
    return JData(num_nodes=n, **fields), Data(num_nodes=n, **fields), coo


@pytest.mark.parametrize('p,q', [(1.0, 1.0), (0.5, 2.0), (4.0, 0.25)])
@pytest.mark.parametrize('length', [1, 5])
def test_random_walk_matches_jax(path, p, q, length):
    _, _, coo = _graph(1)
    start = np.random.default_rng(2).integers(0, N, 80)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    got = random_walk(rng, coo, N, start, length, p, q)
    ref = jnode2vec.random_walk(jrng, coo, N, start, length, p, q)
    _eq(got, ref)
    assert (got[:, 0] == start).all()
    # the generators moved alike: the next draw agrees
    assert rng.integers(0, 1 << 40) == jrng.integers(0, 1 << 40)
    # a CSR built once walks as the edge index does
    csr = node2vec._CSR(torch.from_numpy(coo), N)
    _eq(random_walk(np.random.default_rng(3), csr, N, start, length, p, q),
        ref)


def test_random_walk_is_the_ports_own_build():
    """The native walk is ``random_walk`` in the port's own ``CDLL`` build
    of its copy of ``sampler.cpp`` (never the JAX package's library), its
    argument types bound; the copy's walk is the JAX source's."""
    lib = csrc.sampler_library()
    assert type(lib) is ctypes.CDLL
    assert csrc.sampler_path().parent == PKG / '_build'
    assert lib.random_walk.argtypes is not None
    assert lib.random_walk.restype is None
    port = (PKG / 'csrc' / 'sampler.cpp').read_text()
    jax_src = (ROOT / 'pytorch_geometric_tpu' / 'csrc' /
               'sampler.cpp').read_text()
    walk = jax_src[jax_src.index('// node2vec-style random walks'):
                   jax_src.index('}  // extern "C"')]
    assert walk in port
    assert node2vec.csrc is csrc


SAMPLERS = {'node': (GraphSAINTNodeSampler, jsaint.GraphSAINTNodeSampler),
            'edge': (GraphSAINTEdgeSampler, jsaint.GraphSAINTEdgeSampler),
            'rw': (GraphSAINTRandomWalkSampler,
                   jsaint.GraphSAINTRandomWalkSampler)}


def _batches_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g.keys()) == sorted(r.keys())
        assert g.num_nodes == r.num_nodes
        for k in r.keys():
            _eq(g[k], r[k], k)


@pytest.mark.parametrize('kind', sorted(SAMPLERS))
@pytest.mark.parametrize('coverage', [0, 4])
def test_saint_samplers_match_jax(path, kind, coverage):
    jdata, data, _ = _graph(4)
    cls, jcls = SAMPLERS[kind]
    kw = dict(batch_size=40, num_steps=3, sample_coverage=coverage, seed=5)
    if kind == 'rw':
        kw['walk_length'] = 3
    s, js = cls(data, **kw), jcls(jdata, **kw)
    if coverage:
        _eq(s.node_norm, js.node_norm, 'node_norm')
        _eq(s.edge_norm, js.edge_norm, 'edge_norm')
    else:
        assert s.node_norm is None and s.edge_norm is None
    assert len(s) == len(js) == 3
    for _ in range(2):
        _batches_equal(list(s), list(js))


def test_random_walk_sampler_walks_natively(monkeypatch):
    """On the native path every batch is walked by the library."""
    _, data, _ = _graph(6)
    calls = []
    native = node2vec._random_walk_native
    monkeypatch.setattr(node2vec, '_random_walk_native',
                        lambda *a: calls.append(1) or native(*a))
    s = GraphSAINTRandomWalkSampler(data, 30, walk_length=2, num_steps=2,
                                    sample_coverage=2)
    n_norm = len(calls)
    assert n_norm > 0
    list(s)
    assert len(calls) == n_norm + 2


# -- convolutions -----------------------------------------------------------------
TOL = dict(rtol=1e-4, atol=1e-5)


def _conv_inputs(seed, n_src, n_dst, weighted):
    rng = np.random.default_rng(seed)
    e = 700
    coo = np.stack([rng.integers(0, n_src, e),
                    rng.integers(0, n_dst, e)]).astype(np.int32)
    if n_src == n_dst:
        # a few self loops (ClusterGCNConv drops or keeps them)
        coo[1, :20] = coo[0, :20]
    x = rng.standard_normal((n_src, 12)).astype(np.float32)
    x_dst = rng.standard_normal((n_dst, 12)).astype(np.float32)
    w = rng.random(e).astype(np.float32) if weighted else None
    return coo, x, x_dst, w


def _grads_close(tm, tx, jgrads, jgx):
    ref = flax_to_state_dict(jgrads)
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)


@pytest.mark.parametrize('aggr', ['add', 'mean'])
@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('bipartite', [False, True])
@pytest.mark.parametrize('layout', ['coo', 'edge_index'])
def test_graph_conv_matches_flax(aggr, weighted, bipartite, layout):
    n_src, n_dst = (50, 30) if bipartite else (40, 40)
    coo, x, x_dst, w = _conv_inputs(len(aggr) + weighted, n_src, n_dst,
                                    weighted)
    jm = JGraphConv(out_channels=9, aggr=aggr)
    jx = (jnp.asarray(x), jnp.asarray(x_dst)) if bipartite else \
        jnp.asarray(x)
    jw = None if w is None else jnp.asarray(w)
    params = jm.init(jax.random.PRNGKey(0), jx, jnp.asarray(coo),
                     edge_weight=jw)
    cot = np.random.default_rng(9).standard_normal((n_dst, 9)).astype(
        np.float32)

    def jf(p, xs):
        xin = (xs, jnp.asarray(x_dst)) if bipartite else xs
        out = jm.apply(p, xin, jnp.asarray(coo), edge_weight=jw)
        return (out * cot).sum(), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tm = GraphConv((12, 12) if bipartite else 12, 9, aggr=aggr,
                   device='cpu')
    tm.load_state_dict(flax_to_state_dict(params))
    tx = torch.from_numpy(x).requires_grad_()
    ei = (torch.from_numpy(coo) if layout == 'coo' else
          EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache(
              blocked=False))
    xin = (tx, torch.from_numpy(x_dst)) if bipartite else tx
    out = tm(xin, ei, None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    _grads_close(tm, tx, jgp, jgx)


@pytest.mark.parametrize('diag_lambda', [0.0, 0.7])
@pytest.mark.parametrize('add_self_loops', [True, False])
@pytest.mark.parametrize('layout', ['coo', 'edge_index'])
def test_cluster_gcn_conv_matches_flax(diag_lambda, add_self_loops, layout):
    n = 45
    coo, x, _, _ = _conv_inputs(3, n, n, False)
    jm = JClusterGCNConv(out_channels=7, diag_lambda=diag_lambda,
                         add_self_loops=add_self_loops)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                     jnp.asarray(coo))
    cot = np.random.default_rng(8).standard_normal((n, 7)).astype(
        np.float32)

    def jf(p, xs):
        out = jm.apply(p, xs, jnp.asarray(coo))
        return (out * cot).sum(), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tm = ClusterGCNConv(12, 7, diag_lambda=diag_lambda,
                        add_self_loops=add_self_loops, device='cpu')
    tm.load_state_dict(flax_to_state_dict(params))
    tx = torch.from_numpy(x).requires_grad_()
    ei = (torch.from_numpy(coo) if layout == 'coo' else
          EdgeIndex(coo, (n, n), device='cpu').fill_cache(blocked=False))
    out = tm(tx, ei)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    _grads_close(tm, tx, jgp, jgx)


def test_convs_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for cls in (GraphConv, ClusterGCNConv):
        with pytest.raises(RuntimeError, match='no CUDA card'):
            cls(4, 4)


# -- training steps ---------------------------------------------------------------
STEPS = 3


def _adam_losses_jax(loss_of, params, lr, batches):
    tx = optax.adam(lr)
    opt = tx.init(params)
    losses = []
    for b in batches:
        loss, g = jax.value_and_grad(loss_of)(params, *b)
        upd, opt = tx.update(g, opt)
        params = optax.apply_updates(params, upd)
        losses.append(float(loss))
    return losses


def _adam_losses_port(model, loss_of, lr, batches):
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses = []
    for b in batches:
        opt.zero_grad(set_to_none=True)
        loss = loss_of(*b)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def _saint_batches(seed, n, e):
    rng = np.random.default_rng(seed)
    coo = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    coo = np.concatenate([coo, coo[::-1]], 1).astype(np.int32)
    fields = dict(x=rng.standard_normal((n, 10)).astype(np.float32),
                  edge_index=coo, y=rng.integers(0, 6, n))
    kw = dict(batch_size=60, walk_length=2, num_steps=STEPS,
              sample_coverage=3, seed=0)
    jb = list(jsaint.GraphSAINTRandomWalkSampler(JData(num_nodes=n,
                                                       **fields), **kw))
    tb = list(GraphSAINTRandomWalkSampler(Data(num_nodes=n, **fields), **kw))
    return coo, jb, tb


def test_graph_saint_example_steps_match_jax():
    """``examples/graph_saint.py``'s step: GraphSAGE 64 x 2 -> 6 over each
    batch's raw COO, cross-entropy weighted by ``node_norm`` (sum over the
    norm's sum), Adam 0.01, three random-walk batches in both packages."""
    _, jb, tb = _saint_batches(11, 400, 1500)
    jm = JGraphSAGE(hidden_channels=64, num_layers=2, out_channels=6)
    jbatches = [(jnp.asarray(np.asarray(b.x)),
                 jnp.asarray(np.asarray(b.edge_index)),
                 jnp.asarray(np.asarray(b.y)),
                 jnp.asarray(np.asarray(b.node_norm))) for b in jb]
    params = jm.init(jax.random.PRNGKey(0), *jbatches[0][:2])

    def jloss(p, x, ei, y, nn_):
        ce = optax.softmax_cross_entropy_with_integer_labels(
            jm.apply(p, x, ei), y)
        return (ce * nn_).sum() / nn_.sum()

    ref = _adam_losses_jax(jloss, params, 0.01, jbatches)
    tm = GraphSAGE(10, 64, 2, 6, device='cpu')
    tm.load_state_dict(flax_to_state_dict(params))

    def tloss(x, ei, y, nn_):
        ce = F.cross_entropy(tm(x, ei), y, reduction='none')
        return (ce * nn_).sum() / nn_.sum()

    got = _adam_losses_port(tm, tloss, 0.01, [
        (b.x, b.edge_index, b.y.long(), b.node_norm) for b in tb])
    np.testing.assert_allclose(got, ref, rtol=1e-5)


class _JSaintNet(fnn.Module):
    """``chip_smoke.py::saint_net`` in flax, at toy width."""
    hidden: int
    classes: int

    @fnn.compact
    def __call__(self, x, ei, w):
        xs = []
        for i in range(3):
            x = jax.nn.relu(JGraphConv(out_channels=self.hidden,
                                       aggr='add', name=f'conv_{i}')(
                x, ei, edge_weight=w))
            xs.append(x)
        out = fnn.Dense(self.classes, name='lin')(jnp.concatenate(xs, -1))
        return jax.nn.log_softmax(out, -1)


def test_path_u_steps_match_jax():
    """``chip_smoke.py``'s path U step at toy width: three GraphConvs over
    each batch's ``EdgeIndex`` with ``edge_norm / deg[col]`` weights (the
    weighted SpMM's plain version on the CPU), ``(nll * node_norm).sum()``,
    Adam 0.001, against the same model in flax with optax Adam."""
    n = 400
    coo, jb, tb = _saint_batches(12, n, 1500)
    inv_deg = (1.0 / np.bincount(coo[1], minlength=n)[coo[1]]).astype(
        np.float32)
    jm = _JSaintNet(hidden=16, classes=6)

    def jweights(b):
        return jnp.asarray(np.asarray(b.edge_norm)
                           * inv_deg[np.asarray(b.e_id)])

    jbatches = [(jnp.asarray(np.asarray(b.x)),
                 jnp.asarray(np.asarray(b.edge_index)), jweights(b),
                 jnp.asarray(np.asarray(b.y)),
                 jnp.asarray(np.asarray(b.node_norm))) for b in jb]
    params = jm.init(jax.random.PRNGKey(2), *jbatches[0][:3])

    def jloss(p, x, ei, w, y, nn_):
        logp = jm.apply(p, x, ei, w)
        nll = -jnp.take_along_axis(logp, y[:, None], 1)[:, 0]
        return (nll * nn_).sum()

    ref = _adam_losses_jax(jloss, params, 0.001, jbatches)
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    # the chip's model at toy width, loaded with flax's weights
    cs.FLICKR_F, cs.PU_HIDDEN, cs.FLICKR_C = 10, 16, 6
    tm = cs.saint_net(torch, 'cpu', 0)
    sd = flax_to_state_dict(params)
    tm.load_state_dict(sd)
    inv_deg_t = torch.from_numpy(inv_deg)

    def tloss(x, ei, w, y, nn_):
        nll = F.nll_loss(tm(x, ei, w), y, reduction='none')
        return (nll * nn_).sum()

    batches = []
    for b in tb:
        nb = b.num_nodes
        ei = EdgeIndex(b.edge_index, (nb, nb), device='cpu').fill_cache(
            blocked=False)
        batches.append((b.x, ei, b.edge_norm * inv_deg_t[b.e_id.long()],
                        b.y.long(), b.node_norm))
    got = _adam_losses_port(tm, tloss, 0.001, batches)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_chip_smoke_flickr_generator():
    """``chip_smoke.py::flickr_like`` at toy scale: Flickr's counts scaled,
    every pair in both directions, no self loop, labels in range."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for scale, seed in ((0.01, 0), (0.02, 2)):
        coo, y = cs.flickr_like(scale, seed)
        n = int(round(cs.FLICKR_NODES * scale))
        pairs = int(round(cs.FLICKR_PAIRS * scale))
        assert coo.dtype == np.int32 and coo.shape == (2, 2 * pairs)
        assert y.shape == (n,) and y.min() >= 0 and y.max() < cs.FLICKR_C
        assert coo.min() >= 0 and coo.max() < n
        assert not (coo[0] == coo[1]).any()
        np.testing.assert_array_equal(coo[:, pairs:], coo[::-1, :pairs])
        np.testing.assert_array_equal(cs.flickr_like(scale, seed)[0], coo)
    # the full-size counts are Flickr's published ones
    assert cs.FLICKR_NODES == 89_250 and 2 * cs.FLICKR_PAIRS == 899_756
