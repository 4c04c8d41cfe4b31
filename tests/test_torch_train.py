"""Training through the PyTorch port against the JAX package, on the same
numpy inputs: the segment-sum SpMM's gradients, and 3-layer GCN, GraphSAGE
and GIN first-step gradients and 5-step Adam loss trajectories, from the
same (converted flax) weights. The JAX side runs its Pallas kernels as its
own tests run them on the CPU: the segment-sum kernel under
``PGT_FORCE_PALLAS=1`` (``tests/test_pallas.py``), the BSR kernel in
interpret mode (``tests/test_bsr_spmm.py``); the port runs its kernels'
plain versions, through the same autograd Functions that serve the card.

Two paths, as ``chip_smoke.py`` drives them at full size:

  * A: GCN over ``cache_gcn_norm(block_sparse=True)``, the weights baked
    into 128x128 blocks, a residual tail on the segment-sum path;
  * B: ``bench.py``'s protocol as its CPU branch runs it, cut to a few
    hundred nodes: GCN, GraphSAGE and GIN over the segment-sum path,
    ``fill_cache()`` with GCN's weights passed as ``edge_weight`` on both
    sides.

Tolerances: gradients and losses 1e-4 (relative to the reference's largest
magnitude; float32 sums and matmuls in another order through 3 layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.nn import cache_gcn_norm as jcache_gcn_norm
from pytorch_geometric_tpu.nn import models as jmodels
from pytorch_geometric_tpu.ops import spmm_regime as jspmm_regime
from pytorch_geometric_tpu.ops.pallas_spmm import spmm_pallas
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import models
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import cache_gcn_norm
from pytorch_geometric_tpu_torch.ops import segment_spmm, spmm, spmm_regime

TOL = 1e-4
N_CLASSES, HIDDEN, STEPS = 4, 16, 5


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv('PGT_FORCE_PALLAS', '1')


def _close(got, ref, tol=TOL, what=''):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize('f', [1, 16])
@pytest.mark.parametrize('weighted', [True, False])
@pytest.mark.parametrize('n_src,n_dst', [(150, 150), (90, 200)])
def test_segment_spmm_grads_match_jax(f, weighted, n_src, n_dst):
    """grad_x through the kernel over the CSR and grad_w as the per-edge
    dot, against ``jax.grad`` of the Pallas SpMM (whose backward runs the
    same kernel over its transposed layout)."""
    rng = np.random.default_rng(f + n_dst + weighted)
    rows = rng.choice(n_dst, 2 * n_dst // 3, replace=False)  # empty rows
    coo = np.stack([rng.integers(0, n_src, 2500),
                    rows[rng.integers(0, len(rows), 2500)]])
    coo = np.concatenate([coo, [[n_src] * 7, [n_dst] * 7]], 1).astype(
        np.int32)                                            # padding
    w = rng.random(coo.shape[1]).astype(np.float32)
    x = rng.standard_normal((n_src, f)).astype(np.float32)
    c = rng.standard_normal((n_dst, f)).astype(np.float32)
    j = JEdgeIndex(coo, (n_src, n_dst)).fill_cache()

    def loss(xx, ww):
        return (spmm_pallas(j, xx, ww if weighted else None) * c).sum()

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    t = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache()
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = spmm(t, xt, wt if weighted else None)
    (out * torch.from_numpy(c)).sum().backward()
    _close(xt.grad, gx, what='grad_x')
    if weighted:
        _close(wt.grad, gw, what='grad_w')
    else:
        assert wt.grad is None


def test_segment_spmm_needs_the_transpose_for_grad_x():
    ei = EdgeIndex(np.array([[0, 1, 2], [1, 2, 0]], np.int32), (3, 3),
                   device='cpu').fill_cache()
    x = torch.ones(3, 2, requires_grad=True)
    with pytest.raises(ValueError, match='transpose'):
        segment_spmm(ei.csc.indptr, ei.csc.indices, None, x)
    # grad_w alone needs no transpose; without grad mode none is needed
    w = torch.ones(3, requires_grad=True)
    segment_spmm(ei.csc.indptr, ei.csc.indices, w, x.detach()).sum(
        ).backward()
    assert torch.equal(w.grad, torch.full((3,), 2.0))
    with torch.no_grad():
        segment_spmm(ei.csc.indptr, ei.csc.indices, None, x)


# -- training trajectories ----------------------------------------------------
def _clustered_graph(n, e, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, n // 128 + 1, e)
    src = np.clip(c * 128 + rng.integers(0, 128, e), 0, n - 1)
    dst = np.clip(c * 128 + rng.integers(0, 128, e), 0, n - 1)
    tail = rng.integers(0, n, (2, 200))
    return np.concatenate([np.stack([src, dst]), tail], 1).astype(np.int32)


def _gcn_norm_np(coo, n):
    """``bench.py``'s host-side D^-1/2 (A+I) D^-1/2."""
    loops = np.arange(n, dtype=coo.dtype)
    row = np.concatenate([coo[0], loops])
    col = np.concatenate([coo[1], loops])
    deg = np.bincount(col, minlength=n).astype(np.float64)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    return np.stack([row, col]), (dinv[row] * dinv[col]).astype(np.float32)


def _setup(path, name):
    """(jax EdgeIndex, jax extra kwargs, port EdgeIndex, x, y)."""
    rng = np.random.default_rng(len(name) + len(path))
    if path == 'A':
        n = 600
        coo = _clustered_graph(n, 6000, seed=1)
        jei = jcache_gcn_norm(JEdgeIndex(coo, (n, n)), block_sparse=True)
        tei = cache_gcn_norm(EdgeIndex(coo, (n, n), device='cpu'),
                             block_sparse=True)
        jkw = {}
        assert jspmm_regime(jei) == 'bsr' and spmm_regime(tei) == 'bsr'
        assert tei.bsr_res is not None
    else:
        # E >= 2^14, so the JAX side's SpMM takes its Pallas kernel
        n = 400
        coo = rng.integers(0, n, (2, 16_400)).astype(np.int32)
        if name == 'GCN':
            coo, w = _gcn_norm_np(coo, n)
        else:
            w = np.ones(coo.shape[1], np.float32)
        jei = JEdgeIndex(coo, (n, n)).fill_cache()
        jkw = {'edge_weight': jnp.asarray(w)} if name == 'GCN' else {}
        tei = EdgeIndex(coo, (n, n), device='cpu').fill_cache()
        assert jspmm_regime(jei, has_edge_weight=name == 'GCN') == 'pallas'
        assert spmm_regime(tei, has_edge_weight=name == 'GCN') == 'plain'
    x = rng.standard_normal((n, 16)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, n)
    return jei, jkw, tei, x, y


def _model_kwargs(name):
    if name == 'GCN':
        return {'conv_kwargs': {'normalize': False, 'add_self_loops': False}}
    return {}


def _jax_run(name, jei, jkw, x, y):
    jm = getattr(jmodels, name)(hidden_channels=HIDDEN, num_layers=3,
                                out_channels=N_CLASSES, **_model_kwargs(name))
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    params = jm.init(jax.random.PRNGKey(0), xj, jei, **jkw)
    tx = optax.adam(1e-2)

    def loss_fn(p):
        logits = jm.apply(p, xj, jei, **jkw)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, yj).mean()

    @jax.jit
    def step(p, o):
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, o = tx.update(g, o)
        return optax.apply_updates(p, upd), o, loss, g

    p, o = params, tx.init(params)
    losses, grads0 = [], None
    for i in range(STEPS):
        p, o, loss, g = step(p, o)
        losses.append(float(loss))
        if i == 0:
            grads0 = g
    return params, grads0, losses


def _port_run(name, params, tei, jkw, x, y):
    tm = getattr(models, name)(16, HIDDEN, 3, N_CLASSES, device='cpu',
                               **_model_kwargs(name))
    tm.load_state_dict(flax_to_state_dict(params))
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    kw = {k: torch.from_numpy(np.array(v)) for k, v in jkw.items()}
    losses, grads0 = [], None
    for i in range(STEPS):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(tm(xt, tei, **kw), yt)
        loss.backward()
        if i == 0:
            grads0 = {k: p.grad.clone() for k, p in tm.named_parameters()}
        opt.step()
        losses.append(loss.item())
    return grads0, losses


@pytest.mark.parametrize('path,name', [('A', 'GCN'), ('B', 'GCN'),
                                       ('B', 'GraphSAGE'), ('B', 'GIN')])
def test_training_matches_jax(path, name):
    jei, jkw, tei, x, y = _setup(path, name)
    params, jgrads, jlosses = _jax_run(name, jei, jkw, x, y)
    tgrads, tlosses = _port_run(name, params, tei, jkw, x, y)
    ref = flax_to_state_dict(jgrads)
    assert sorted(ref) == sorted(tgrads)
    for k in ref:
        _close(tgrads[k], ref[k], what=f'first-step grad of {k}')
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)
    assert tlosses[-1] < tlosses[0]
