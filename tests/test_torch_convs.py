"""The PyTorch port's GCN normalisation and its GCNConv, SAGEConv and GINConv
against the JAX package, on the same numpy inputs and with the flax weights
converted (``pytorch_geometric_tpu_torch.convert``).

Tolerance: f32, rtol/atol 1e-5 per op (sums and matmuls in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.nn.conv import (GCNConv as JGCNConv,
                                           GINConv as JGINConv,
                                           SAGEConv as JSAGEConv,
                                           cache_gcn_norm as jcache_gcn_norm,
                                           gcn_norm as jgcn_norm)
from pytorch_geometric_tpu.nn.models import MLP as JMLP
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn.conv import (GCNConv, GINConv, SAGEConv,
                                                 cache_gcn_norm, gcn_norm)
from pytorch_geometric_tpu_torch.nn.models import MLP

TOL = dict(rtol=1e-5, atol=1e-5)


def _graph(n, e, f, seed, n_pad=0, loops=5):
    rng = np.random.default_rng(seed)
    coo = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    some = rng.choice(n, loops, replace=False)         # existing self loops
    coo = np.concatenate([coo, np.stack([some, some]),
                          np.full((2, n_pad), n)], axis=1).astype(np.int32)
    w = rng.random(coo.shape[1]).astype(np.float32) + 0.1
    x = rng.standard_normal((n, f)).astype(np.float32)
    return coo, w, x


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _load(module, params):
    module.load_state_dict(flax_to_state_dict(params))
    return module.eval()


@pytest.mark.parametrize('improved', [False, True])
@pytest.mark.parametrize('weighted', [False, True])
def test_gcn_norm_matches_jax(improved, weighted):
    coo, w, _ = _graph(40, 200, 1, seed=1, n_pad=3)
    ref_coo, ref_w = jgcn_norm(jnp.asarray(coo),
                               jnp.asarray(w) if weighted else None, 40,
                               improved)
    out_coo, out_w = gcn_norm(_t(coo), _t(w) if weighted else None, 40,
                              improved)
    np.testing.assert_array_equal(out_coo.numpy(), np.asarray(ref_coo))
    np.testing.assert_allclose(out_w.numpy(), np.asarray(ref_w), **TOL)


@pytest.mark.parametrize('improved', [False, True])
def test_cache_gcn_norm_matches_jax(improved):
    """Both packages bake the normalised adjacency into a dense float32
    cache on a graph this small."""
    n = 40
    coo, _, _ = _graph(n, 200, 1, seed=2, n_pad=2)
    j = jcache_gcn_norm(JEdgeIndex(coo, (n, n)), improved=improved)
    t = cache_gcn_norm(EdgeIndex(coo, (n, n), device='cpu'),
                       improved=improved)
    assert t.weight is None and t.dense_adj.dtype == torch.float32
    np.testing.assert_allclose(t.dense_adj.numpy(), np.asarray(j.dense_adj),
                               **TOL)
    assert t.csc is not None and t.csr is not None


@pytest.mark.parametrize('normalize', [True, False])
@pytest.mark.parametrize('propagate_first', [None, True, False])
@pytest.mark.parametrize('cached', [True, False])
def test_gcn_conv_matches_jax(normalize, propagate_first, cached):
    n = 50
    coo, w, x = _graph(n, 300, 12, seed=3, n_pad=2)
    kw = dict(normalize=normalize, propagate_first=propagate_first)
    jm = JGCNConv(out_channels=16, **kw)
    jei = JEdgeIndex(coo, (n, n)).fill_cache() if cached else \
        jnp.asarray(coo)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jei,
                     jnp.asarray(w))
    ref = jm.apply(params, jnp.asarray(x), jei, jnp.asarray(w))
    tm = _load(GCNConv(12, 16, **kw, device='cpu'), params)
    tei = EdgeIndex(coo, (n, n), device='cpu').fill_cache() if cached \
        else _t(coo)
    with torch.inference_mode():
        out = tm(_t(x), tei, _t(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('project', [False, True])
@pytest.mark.parametrize('bipartite', [False, True])
def test_sage_conv_matches_jax(project, bipartite):
    n_src, n_dst = 50, (30 if bipartite else 50)
    rng = np.random.default_rng(4)
    coo = np.stack([rng.integers(0, n_src, 250),
                    rng.integers(0, n_dst, 250)]).astype(np.int32)
    x_src = rng.standard_normal((n_src, 10)).astype(np.float32)
    x_dst = rng.standard_normal((n_dst, 6 if bipartite else 10)).astype(
        np.float32)
    jx = (jnp.asarray(x_src), jnp.asarray(x_dst)) if bipartite else \
        jnp.asarray(x_src)
    jei = JEdgeIndex(coo, (n_src, n_dst)).fill_cache()
    jm = JSAGEConv(out_channels=8, project=project)
    params = jm.init(jax.random.PRNGKey(1), jx, jei)
    ref = jm.apply(params, jx, jei)
    tm = _load(SAGEConv((10, 6) if bipartite else 10, 8, project=project,
                        device='cpu'), params)
    tx = (_t(x_src), _t(x_dst)) if bipartite else _t(x_src)
    tei = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache()
    with torch.inference_mode():
        out = tm(tx, tei)
        # the gather path (raw COO) agrees with the fused SpMM path
        out_raw = tm(tx, _t(coo), size=(n_src, n_dst))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out_raw.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('train_eps', [False, True])
def test_gin_conv_matches_jax(train_eps):
    n = 45
    coo, _, x = _graph(n, 260, 9, seed=5, n_pad=3)
    jm = JGINConv(mlp=JMLP(channel_list=[16, 16]), eps_init=0.25,
                  train_eps=train_eps)
    jei = JEdgeIndex(coo, (n, n)).fill_cache()
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jei)
    ref = jm.apply(params, jnp.asarray(x), jei)
    tm = _load(GINConv(MLP(9, [16, 16], device='cpu'), eps_init=0.25,
                       train_eps=train_eps), params)
    with torch.inference_mode():
        out = tm(_t(x), EdgeIndex(coo, (n, n), device='cpu').fill_cache())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('norm', [None, 'layer_norm'])
@pytest.mark.parametrize('plain_last', [True, False])
def test_mlp_matches_jax(norm, plain_last):
    x = np.random.default_rng(6).standard_normal((20, 7)).astype(np.float32)
    jm = JMLP(channel_list=[12, 12, 5], norm=norm, plain_last=plain_last)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    ref = jm.apply(params, jnp.asarray(x))
    tm = _load(MLP(7, [12, 12, 5], norm=norm, plain_last=plain_last,
                   device='cpu'), params)
    with torch.inference_mode():
        np.testing.assert_allclose(tm(_t(x)).numpy(), np.asarray(ref),
                                   **TOL)
