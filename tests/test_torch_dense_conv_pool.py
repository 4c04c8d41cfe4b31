"""The port's ``nn/dense/dense_conv.py`` and ``nn/dense/dense_pool.py``
against the JAX package's, on the CPU, over a padded batch of three graphs
(a node mask, weighted adjacencies): ``DenseGCNConv`` (plain and
improved, with and without the loops), ``DenseSAGEConv`` (normalised or
not), ``DenseGINConv`` (a trained eps), ``DenseGraphConv`` (add and mean),
``DenseGATConv`` (heads concatenated or averaged), ``dense_diff_pool``,
``dense_mincut_pool``, ``dense_dmon_pool`` and ``DMoNPooling``; and the
exports of ``nn/dense``.

Tolerances: outputs within 1e-5 * max(1, max|ref|), gradients within 1e-4
of each gradient's largest entry (``_torch_parity``)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, compare, grad_close, t
from pytorch_geometric_tpu.nn import dense as jdense_pkg
from pytorch_geometric_tpu.nn.dense import dense_conv as jdc
from pytorch_geometric_tpu.nn.dense import dense_pool as jdp
from pytorch_geometric_tpu_torch.nn import dense as tdense_pkg
from pytorch_geometric_tpu_torch.nn.dense import dense_conv as tdc
from pytorch_geometric_tpu_torch.nn.dense import dense_pool as tdp
from pytorch_geometric_tpu_torch.nn.inits import linear

CPU = dict(device='cpu')
B, N, F, K = 3, 7, 5, 3
_rng = np.random.default_rng(61)
X = _rng.standard_normal((B, N, F)).astype(np.float32)
MASK = np.ones((B, N), bool)
MASK[1, 5:] = False
MASK[2, 4:] = False
ADJ = ((_rng.random((B, N, N)) < 0.4)
       * _rng.uniform(0.5, 1.5, (B, N, N))).astype(np.float32)
ADJ *= (MASK[:, :, None] & MASK[:, None, :])
S_LOGITS = _rng.standard_normal((B, N, K)).astype(np.float32)


def _conv(jm, tm, mask=True, **kw):
    m = MASK if mask else None
    compare(jm, tm, X, (jnp.asarray(ADJ), None if m is None
                        else jnp.asarray(m)),
            (t(ADJ), t(m)), jkw=kw, tkw=kw)


@pytest.mark.parametrize('add_loop', [True, False])
@pytest.mark.parametrize('improved', [False, True])
def test_dense_gcn_conv_matches_jax(improved, add_loop):
    _conv(jdc.DenseGCNConv(out_channels=4, improved=improved),
          tdc.DenseGCNConv(F, 4, improved=improved, **CPU),
          add_loop=add_loop)


@pytest.mark.parametrize('normalize', [False, True])
def test_dense_sage_conv_matches_jax(normalize):
    _conv(jdc.DenseSAGEConv(out_channels=4, normalize=normalize),
          tdc.DenseSAGEConv(F, 4, normalize=normalize, **CPU))


def test_dense_gin_conv_matches_jax():
    """``nn`` a Dense layer, ``eps`` trained (its gradient held too); no
    mask."""
    _conv(jdc.DenseGINConv(nn=fnn.Dense(4), eps_init=0.3, train_eps=True),
          tdc.DenseGINConv(linear(F, 4, **CPU), eps=0.3, train_eps=True,
                           **CPU), mask=False)


@pytest.mark.parametrize('aggr', ['add', 'mean'])
def test_dense_graph_conv_matches_jax(aggr):
    _conv(jdc.DenseGraphConv(out_channels=4, aggr=aggr),
          tdc.DenseGraphConv(F, 4, aggr=aggr, **CPU))


@pytest.mark.parametrize('concat', [True, False])
def test_dense_gat_conv_matches_jax(concat):
    _conv(jdc.DenseGATConv(out_channels=4, heads=2, concat=concat),
          tdc.DenseGATConv(F, 4, heads=2, concat=concat, **CPU))


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('name', ['dense_diff_pool', 'dense_mincut_pool',
                                  'dense_dmon_pool'])
def test_dense_pools_match_jax(name, masked):
    """Every output, and the gradients of their weighted sum for x, the
    adjacency and s (DMoN's s as probabilities, as it takes them)."""
    jf, tf = getattr(jdp, name), getattr(tdp, name)
    s = S_LOGITS
    if name == 'dense_dmon_pool':
        s = np.asarray(jax.nn.softmax(jnp.asarray(s), -1))
    m = MASK if masked else None
    args = (X, ADJ, s)
    want, vjp = jax.vjp(lambda *a: jf(*a, None if m is None
                                      else jnp.asarray(m)),
                        *map(jnp.asarray, args))
    rng = np.random.default_rng(62)
    cots = [rng.standard_normal(np.shape(w)).astype(np.float32)
            for w in want]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    targs = [t(a).requires_grad_() for a in args]
    got = tf(*targs, t(m))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, f'output {i}')
    sum((g * t(c)).sum() for g, c in zip(got, cots)).backward()
    for what, a, g in zip(('x', 'adj', 's'), targs, jgrads):
        grad_close(a.grad, g, f'grad {what}')


@pytest.mark.parametrize('masked', [False, True])
def test_dmon_pooling_matches_jax(masked):
    m = MASK if masked else None
    compare(jdp.DMoNPooling(k=K), tdp.DMoNPooling(F, K, **CPU), X,
            (jnp.asarray(ADJ), None if m is None else jnp.asarray(m)),
            (t(ADJ), t(m)))


def test_dense_exports_match_jax():
    assert set(jdense_pkg.__all__) == set(tdense_pkg.__all__)
    for name in tdense_pkg.__all__:
        assert getattr(tdense_pkg, name) is not None


def test_dense_modules_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for build in (lambda: tdc.DenseGCNConv(F, 4),
                  lambda: tdc.DenseSAGEConv(F, 4),
                  lambda: tdc.DenseGraphConv(F, 4),
                  lambda: tdc.DenseGATConv(F, 4),
                  lambda: tdc.DenseGINConv(torch.nn.Identity(),
                                           train_eps=True),
                  lambda: tdp.DMoNPooling(F, K)):
        with pytest.raises(RuntimeError, match='no CUDA card'):
            build()
