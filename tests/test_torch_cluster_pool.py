"""The port's ``nn/pool/cluster_pool.py`` against the JAX package's, on the
CPU: ``graclus`` bitwise (weighted and not), ``avg_pool`` / ``max_pool``
bitwise, ``avg_pool_x`` / ``max_pool_x``, ``EdgePooling``'s device score
in its three methods and its host merge (equal scores among them: the
merge takes the same edge order on both), ``ASAPooling`` (edge weights,
an edge mask, existing self loops with their own weights, the output
loops), ``MemPooling`` on a node list and a dense batch and its
``kl_loss``, ``ClusterPooling`` in its three methods, and
``chip_smoke.py``'s path AC model (``mem_pool_net``) over three Adam
steps against the JAX package's ``examples/mem_pool.py`` model.

Tolerances: outputs within 1e-5 * max(1, max|ref|), gradients within 1e-4
of each gradient's largest entry (``_torch_parity``); clusters, indices,
masks and the host merges exact."""

import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import close, compare, grad_close, graph, init_variables, t
from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.nn import GraphConv as JGraphConv
from pytorch_geometric_tpu.nn.pool import cluster_pool as jcp
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.nn.pool import cluster_pool as tcp

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device='cpu')
N, E, F, PAD, B = 24, 70, 6, 3, 3
X, COO, MASK, W = graph(41, N, E, F, PAD)
BATCH = np.repeat(np.arange(B), [10, 8, 6]).astype(np.int32)
_inside = BATCH[np.minimum(COO[0], N - 1)] == BATCH[np.minimum(COO[1],
                                                                N - 1)]
COO[1] = np.where(_inside | (COO[0] == N), COO[1], COO[0])
REAL = COO[:, :E]


def _same(got, ref, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                  err_msg=what)


@pytest.mark.parametrize('weighted', [False, True])
def test_graclus_matches_jax_bitwise(weighted):
    w = W[:E] if weighted else None
    want = jcp.graclus(jnp.asarray(REAL), N, None if w is None
                       else jnp.asarray(w), seed=3)
    _same(tcp.graclus(t(REAL), N, t(w), seed=3), want)


@pytest.mark.parametrize('reduce', ['avg', 'max'])
def test_avg_and_max_pool_match_jax(reduce):
    """The coarsened graph bitwise (x, edges, cluster, pos in float32),
    and the ``_x`` forms on tensors."""
    cluster = jcp.graclus(REAL, N, seed=5)
    pos = np.random.default_rng(42).standard_normal((N, 3)).astype(
        np.float32)
    jd = JData(x=X, edge_index=REAL, pos=pos, num_nodes=N)
    td = Data(x=X, edge_index=REAL, pos=pos, num_nodes=N)
    want = getattr(jcp, f'{reduce}_pool')(cluster, jd)
    got = getattr(tcp, f'{reduce}_pool')(t(cluster), td)
    assert got.num_nodes == want.num_nodes
    for key in ('x', 'edge_index', 'cluster', 'pos'):
        _same(got[key], want[key], key)
        assert got[key].numpy().dtype == np.asarray(want[key]).dtype, key
    k = int(cluster.max()) + 1
    ref = getattr(jcp, f'{reduce}_pool_x')(jnp.asarray(cluster),
                                           jnp.asarray(X), k)
    close(getattr(tcp, f'{reduce}_pool_x')(t(cluster).long(), t(X), k),
          ref)


@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('method', ['softmax', 'tanh', 'sigmoid'])
def test_edge_pooling_matches_jax(method, ties):
    """The device score with gradients; then the host merge of one score
    vector on both (with ``ties``, many equal scores: a stable sort puts
    them in edge order on both)."""
    compare(jcp.EdgePooling(in_channels=F, edge_score_method=method),
            tcp.EdgePooling(F, method, **CPU), X, (jnp.asarray(REAL),),
            (t(REAL),))
    score = np.random.default_rng(43).random(E).astype(np.float32)
    if ties:
        score[::2] = score[0]
    want = jcp.EdgePooling.merge(X, jnp.asarray(REAL), score)
    got = tcp.EdgePooling.merge(t(X), t(REAL), t(score))
    for g, w, what in zip(got, want, ('x', 'edge_index', 'cluster')):
        _same(g, w, what)


@pytest.mark.parametrize('case', ['plain', 'weighted loops',
                                  'loops out'])
def test_asap_pooling_matches_jax(case):
    """Every output with the gradients; ``weighted loops``: nodes with one
    or two existing self loops of their own weights (the last loop edge's
    weight wins), under an edge mask that drops one of them."""
    coo, mask, w = COO.copy(), MASK.copy(), W.copy()
    if case == 'weighted loops':
        coo[1, :6] = coo[0, :6]
        coo[:, 6] = coo[:, 2]                  # a node with two loops
        mask[:7] = True
        mask[0] = False
        w[:7] = np.arange(1, 8, dtype=np.float32)
    L = 10
    jargs = (jnp.asarray(coo), jnp.asarray(w), jnp.asarray(BATCH), B, L,
             jnp.asarray(mask))
    targs = (t(coo), t(w), t(BATCH), B, L, t(mask))
    out = case == 'loops out'
    compare(jcp.ASAPooling(in_channels=F, ratio=0.5,
                           add_self_loops_out=out),
            tcp.ASAPooling(F, 0.5, add_self_loops_out=out, **CPU), X,
            jargs, targs)


@pytest.mark.parametrize('layout', ['nodes', 'dense'])
def test_mem_pooling_matches_jax(layout):
    """A batch of three graphs as a node list (padded to N per graph, as
    the JAX package lays it out) and as a masked dense batch; both
    outputs and the gradients."""
    if layout == 'nodes':
        jargs, targs = (jnp.asarray(BATCH), B), (t(BATCH), B)
        x = X
    else:
        x = np.random.default_rng(44).standard_normal((B, 7, F)).astype(
            np.float32)
        m = np.random.default_rng(45).random((B, 7)) < 0.8
        jargs, targs = (None, 1, jnp.asarray(m)), (None, 1, t(m))
    compare(jcp.MemPooling(in_channels=F, out_channels=5, heads=3,
                           num_clusters=4, tau=0.7),
            tcp.MemPooling(F, 5, heads=3, num_clusters=4, tau=0.7, **CPU),
            x, jargs, targs)


def test_mem_pooling_kl_loss_matches_jax():
    """The loss and its gradient for S, with a padded (all-zero) row."""
    s = np.random.default_rng(46).random((3, 9, 4)).astype(np.float32)
    s /= s.sum(-1, keepdims=True)
    s[1, 7:] = 0.0
    loss, g = jax.value_and_grad(jcp.MemPooling.kl_loss)(jnp.asarray(s))
    ts = t(s).requires_grad_()
    tl = tcp.MemPooling.kl_loss(ts)
    tl.backward()
    close(tl, loss)
    grad_close(ts.grad, g)


def _jscore(p, x, coo, not_loop, method, n):
    """The JAX module's edge scores (``cluster_pool.py:351-368``)."""
    src = jnp.minimum(coo[0], n - 1)
    dst = jnp.minimum(coo[1], n - 1)
    raw = (jnp.concatenate([x[src], x[dst]], -1) @ p['lin']['kernel']
           + p['lin']['bias'])[:, 0]
    if method == 'sigmoid':
        return jax.nn.sigmoid(raw)
    if method == 'log_softmax':
        return jax.nn.log_softmax(jnp.where(not_loop, raw, -jnp.inf))
    return jnp.tanh(raw)


def _jpooled(p, x, coo, not_loop, keep, cluster, method, n):
    """The JAX module's pooled rows (``cluster_pool.py:381-396``) at the
    kept edges and clustering its eager run found, for ``jax.grad``."""
    score = _jscore(p, x, coo, not_loop, method, n)
    touched = np.zeros(n, bool)
    touched[coo[0][keep]] = True
    touched[coo[1][keep]] = True
    src = jnp.minimum(coo[0], n - 1)
    dst = jnp.minimum(coo[1], n - 1)
    sv = jnp.where(not_loop, score, 0.0)
    row_w = jnp.zeros((n, n)).at[src, cluster[dst]].add(sv)
    row_w = row_w + (~touched)[:, None] * jax.nn.one_hot(cluster, n)
    return row_w.T @ x


@pytest.mark.parametrize('method', ['tanh', 'sigmoid', 'log_softmax'])
def test_cluster_pooling_matches_jax(method):
    """The JAX module reads its scores back to the host, so it runs
    eagerly: every output against its eager run (clusters, edges and masks
    exact), and the gradients of the pooled rows against ``jax.grad`` of
    its pooled-row formula at the edges it kept and the clustering it
    found. Thresholds that keep part of the edges; the masked edges lie
    inside the node range (the JAX module reads no sentinel row)."""
    th, default = {'tanh': (0.1, 0.0), 'sigmoid': (None, 0.5),
                   'log_softmax': (-4.4, 0.0)}[method]
    jm = jcp.ClusterPooling(in_channels=F, edge_score_method=method,
                            threshold=th)
    coo, mask = REAL.copy(), MASK[:E]
    coo[1, :4] = coo[0, :4]
    # drawn by hand: the module cannot be traced (jax.eval_shape)
    rng = np.random.default_rng(48)
    variables = {'params': {'lin': {
        'kernel': jnp.asarray(rng.standard_normal((2 * F, 1)) / 3.0,
                              jnp.float32),
        'bias': jnp.asarray(rng.standard_normal(1) / 10, jnp.float32)}}}
    want = jm.apply(variables, jnp.asarray(X), coo, jnp.asarray(mask))
    tm = tcp.ClusterPooling(F, method, th, **CPU)
    tm.load_state_dict(flax_to_state_dict(variables))
    tx = t(X).requires_grad_()
    got = tm(tx, t(coo), t(mask))
    close(got[0], want[0], 'pooled')
    for i, what in ((1, 'cluster'), (2, 'edges'), (3, 'edge mask')):
        _same(got[i], want[i], what)
    assert got[4] == want[4] and 1 < want[4] < N
    not_loop = (coo[0] != coo[1]) & mask
    params = variables['params']
    score = _jscore(params, jnp.asarray(X), coo, jnp.asarray(not_loop),
                    method, N)
    keep = np.asarray(score > (default if th is None else th)) & not_loop
    assert 0 < keep.sum() < not_loop.sum()
    cot = np.random.default_rng(47).standard_normal((N, F)).astype(
        np.float32)

    def jf(p, x):
        return (_jpooled(p, x, coo, jnp.asarray(not_loop), keep,
                         np.asarray(want[1]), method, N) * cot).sum()

    gp, gx = jax.grad(jf, (0, 1))(params, jnp.asarray(X))
    (got[0] * t(cot)).sum().backward()
    jg = flax_to_state_dict({'params': gp})
    # a gradient that vanishes in exact arithmetic (log_softmax's bias:
    # the softmax is shift invariant) within 1e-6 of the largest of all
    floor = 1e-6 * max([float(np.abs(np.asarray(gx)).max())]
                       + [float(v.abs().max()) for v in jg.values()])
    grad_close(tx.grad, gx, 'grad x', floor)
    for k, p in tm.named_parameters():
        grad_close(p.grad, jg[k].numpy(), k, floor)


class _JMemNet(fnn.Module):
    """The JAX package's ``examples/mem_pool.py`` net, its layers named as
    ``chip_smoke.py::mem_pool_net`` names them."""
    hidden: int
    classes: int
    heads: int
    clusters: int

    @fnn.compact
    def __call__(self, x, ei, batch, num_graphs):
        h = fnn.leaky_relu(JGraphConv(out_channels=self.hidden,
                                      name='conv1')(x, ei))
        h = fnn.leaky_relu(JGraphConv(out_channels=self.hidden,
                                      name='conv2')(h, ei))
        hp, s1 = jcp.MemPooling(in_channels=self.hidden,
                                out_channels=self.hidden, heads=self.heads,
                                num_clusters=self.clusters,
                                name='pool1')(h, batch=batch,
                                              batch_size=num_graphs)
        out, s2 = jcp.MemPooling(in_channels=self.hidden,
                                 out_channels=self.classes,
                                 heads=self.heads, num_clusters=1,
                                 name='pool2')(hp)
        return out[:, 0], (jcp.MemPooling.kl_loss(s1)
                           + jcp.MemPooling.kl_loss(s2))


def test_path_ac_steps_match_jax():
    """Path AC's model (``chip_smoke.py::mem_pool_net``) at hidden 8, 2
    heads, 3 clusters, over three batches of three graphs: each Adam step's
    loss (cross-entropy + 0.1 KL) within 1e-4 relative and its gradients
    held to flax's, the port at flax's parameters."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dims = dict(hidden=8, classes=2, heads=2, clusters=3)
    rng = np.random.default_rng(49)
    batches = []
    for _ in range(3):
        sizes = rng.integers(4, 9, B)
        n = int(sizes.sum())
        vec = np.repeat(np.arange(B), sizes).astype(np.int32)
        coo = rng.integers(0, n, (2, 4 * n))
        coo[1] = np.where(vec[coo[0]] == vec[coo[1]], coo[1], coo[0])
        # small features: the logits stay near 1, the loss far from 0
        batches.append((0.1 * rng.standard_normal((n, F)).astype(
            np.float32),
                        coo.astype(np.int32), vec, rng.integers(0, 2, B)))
    jm = _JMemNet(**dims)
    x0, coo0, vec0, _ = batches[0]
    variables = init_variables(jm, 0, jnp.asarray(x0), jnp.asarray(coo0),
                               jnp.asarray(vec0), B)
    tm = cs.mem_pool_net(torch, 'cpu', 0, in_channels=F, **dims)

    def jloss(p, x, coo, vec, y):
        logits, kl = jm.apply({'params': p}, x, coo, vec, B)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean() + 0.1 * kl

    params = variables['params']
    tx = optax.adam(1e-3)
    opt = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(jloss))
    for step, (x, coo, vec, y) in enumerate(batches):
        loss, g = grad_fn(params, jnp.asarray(x), jnp.asarray(coo),
                          jnp.asarray(vec), jnp.asarray(y))
        tm.load_state_dict(flax_to_state_dict({'params': params}))
        tm.zero_grad(set_to_none=True)
        logits, kl = tm(t(x), t(coo), t(vec), B)
        tl = torch.nn.functional.cross_entropy(logits, t(y).long()) \
            + 0.1 * kl
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-4,
                                   err_msg=f'loss, step {step}')
        jgrads = flax_to_state_dict({'params': g})
        floor = 1e-6 * max(float(v.abs().max()) for v in jgrads.values())
        for k, p in tm.named_parameters():
            grad_close(p.grad, jgrads[k].numpy(), f'{k}, step {step}', floor)
        upd, opt = tx.update(g, opt)
        params = optax.apply_updates(params, upd)


def test_cluster_pools_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for build in (lambda: tcp.EdgePooling(F), lambda: tcp.ASAPooling(F),
                  lambda: tcp.MemPooling(F, 4),
                  lambda: tcp.ClusterPooling(F)):
        with pytest.raises(RuntimeError, match='no CUDA card'):
            build()
