"""The PyTorch port's 3-layer GCN, GraphSAGE and GIN against the JAX
package's, at small widths, on the same numpy inputs and with the flax
weights converted. One GCN forward is large enough (E >= 2^14) that the JAX
side runs its Pallas SpMM kernel (in interpret mode on the CPU).

Tolerance: f32 through 3 layers, rtol/atol 1e-4 (sums and matmuls in
another order at every layer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.nn import models as jmodels
from pytorch_geometric_tpu.ops import spmm_regime as jspmm_regime
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import models

TOL = dict(rtol=1e-4, atol=1e-4)


def _graph(n, e, f, seed):
    rng = np.random.default_rng(seed)
    coo = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]).astype(
        np.int32)
    w = rng.random(e).astype(np.float32)
    x = rng.standard_normal((n, f)).astype(np.float32)
    return coo, w, x


def _run_both(name, coo, w, x, hidden, out, **kw):
    n, f = x.shape
    jm = getattr(jmodels, name)(hidden_channels=hidden, num_layers=3,
                                out_channels=out, **kw)
    jei = JEdgeIndex(coo, (n, n)).fill_cache()
    ekw = {'edge_weight': jnp.asarray(w)} if name == 'GCN' else {}
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jei, **ekw)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jei, **ekw))
    tm = getattr(models, name)(f, hidden, 3, out, **kw, device='cpu')
    tm.load_state_dict(flax_to_state_dict(params))
    tm.eval()
    tei = EdgeIndex(coo, (n, n), device='cpu').fill_cache()
    tkw = {'edge_weight': torch.from_numpy(w)} if name == 'GCN' else {}
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), tei, **tkw).numpy()
    return got, ref, jei


@pytest.mark.parametrize('name', ['GCN', 'GraphSAGE', 'GIN'])
@pytest.mark.parametrize('kw', [{}, {'norm': 'layer_norm', 'jk': 'cat'},
                                {'jk': 'max'}, {'jk': 'last'},
                                {'out_channels_none': True}],
                         ids=['plain', 'layer_norm-cat', 'max', 'last',
                              'no-out'])
def test_model_matches_jax(name, kw):
    coo, w, x = _graph(60, 360, 8, seed=len(name) + len(kw))
    kw = dict(kw)
    out = None if kw.pop('out_channels_none', False) else 4
    got, ref, _ = _run_both(name, coo, w, x, 16, out, **kw)
    assert got.shape == ref.shape == (60, 4 if out else 16)
    np.testing.assert_allclose(got, ref, **TOL)


def test_gcn_serving_config_through_pallas(monkeypatch):
    """The headline serving configuration (GCN with host-normalised weights,
    ``normalize=False``), cut to 2000 nodes and width 32: the JAX forward
    runs its Pallas SpMM kernel in interpret mode."""
    monkeypatch.setenv('PGT_FORCE_PALLAS', '1')
    n, e = 2000, 20_000
    coo, _, x = _graph(n, e, 32, seed=7)
    loops = np.arange(n, dtype=np.int32)
    coo = np.concatenate([coo, np.stack([loops, loops])], axis=1)
    deg = np.bincount(coo[1], minlength=n).astype(np.float32)
    dis = 1.0 / np.sqrt(np.maximum(deg, 1))
    w = (dis[coo[0]] * dis[coo[1]]).astype(np.float32)
    got, ref, jei = _run_both(
        'GCN', coo, w, x, 32, 16,
        conv_kwargs={'normalize': False, 'add_self_loops': False})
    assert jspmm_regime(jei, 32, has_edge_weight=True) == 'pallas'
    np.testing.assert_allclose(got, ref, **TOL)
    assert (got.argmax(-1) == ref.argmax(-1)).all()


def test_unported_options_raise():
    """``norm='batch_norm'`` is ported (tests/test_torch_graph_models.py);
    a norm the port does not know raises rather than running without one,
    and layer-wise inference keeps its rule of no batch norm."""
    with pytest.raises(ValueError, match='unknown norm'):
        models.GCN(8, 16, 2, norm='graph_norm', device='cpu')
    with pytest.raises(ValueError, match='unknown norm'):
        models.MLP(8, [16, 4], norm='instance_norm', device='cpu')
    gnn = models.GCN(8, 16, 2, norm='batch_norm', device='cpu')
    with pytest.raises(ValueError, match='basic_gnn_inference needs norm'):
        models.basic_gnn_inference(gnn, None)


def test_generator_makes_weights_reproducible():
    def make(seed):
        return models.GIN(8, 16, 3, 4, device='cpu',
                          generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0).state_dict(), make(0).state_dict(), make(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
