"""The precision ladder's dense caches against the JAX package, on the same
numpy inputs: ``fill_cache(dense_weight=w, cache_dtype=...)`` for float32,
bfloat16 and int8 (the dense adjacency, the int8 scales, ``flip``), the
``'dense-cached'`` SpMM arm over each (sum, mean, transpose) with the float32
and bf16 gradients against ``jax.grad``, the regime each cache runs, and
Adam steps of GCN over the dense bf16 cache against ``optax.adam(1e-2)``.

Tolerances and why:

  * the caches are equal bit for bit: both build in float32 with the
    duplicate edges added in edge order, then cast, or factorise with the
    same float32 operations (sqrt, divisions, round half to even);
  * float32 and bf16 products: 1e-5 of the reference's largest magnitude
    (both sum exact float32 products, in another order);
  * bf16 products cast back to bf16: 2^-8 relative plus 1e-6 of the
    largest magnitude, for a sum that lands on a rounding boundary;
  * bf16 ``grad_x`` (rounded to bf16 by both): one bf16 ulp of each
    reference value (2^-7 relative at the bottom of a binade) plus 1e-6 of
    the largest magnitude. The port enters ``g`` as two bf16 halves
    (``hi + lo``, about 16 of its 24 bits) on every device, so ``A^T g``
    before its rounding differs from JAX's float32 product near 2^-17
    relative, and a value next to a rounding boundary lands one ulp over;
  * int8: the int32 products are exact and the rescale is the same float32
    arithmetic: 1e-6 of the largest magnitude;
  * the model: losses 1e-4 relative, first-step gradients 1e-3 of the
    largest magnitude (a bf16 rounding of a layer input can flip where the
    two frameworks' float32 sums differ in the last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.nn import models as jmodels
from pytorch_geometric_tpu.ops import spmm as jspmm
from pytorch_geometric_tpu.ops import spmm_regime as jspmm_regime
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import models
from pytorch_geometric_tpu_torch.ops import spmm, spmm_regime

DTYPES = {'f32': (torch.float32, jnp.float32),
          'bf16': (torch.bfloat16, jnp.bfloat16),
          'int8': (torch.int8, jnp.int8)}


def _graph(n_src, n_dst, e, seed, n_pad=5):
    """A random COO with duplicate edges, empty rows and columns (the last
    five of each side get no edges) and padded edges."""
    rng = np.random.default_rng(seed)
    coo = np.stack([rng.integers(0, n_src - 5, e),
                    rng.integers(0, n_dst - 5, e)])
    coo = np.concatenate([coo, coo[:, :20],
                          [[n_src] * n_pad, [n_dst] * n_pad]], 1)
    w = rng.random(coo.shape[1]).astype(np.float32)
    return coo.astype(np.int32), w, rng


def _both(coo, size, w, name):
    t_dt, j_dt = DTYPES[name]
    j = JEdgeIndex(coo, size).fill_cache(
        dense_weight=w, cache_dtype=None if name == 'f32' else j_dt)
    t = EdgeIndex(coo, size, device='cpu').fill_cache(
        dense_weight=w, cache_dtype=None if name == 'f32' else t_dt)
    return j, t


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(got, ref, tol, what=''):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize('name', sorted(DTYPES))
@pytest.mark.parametrize('n_src,n_dst', [(60, 60), (45, 70)])
def test_dense_cache_matches_jax(name, n_src, n_dst):
    coo, w, _ = _graph(n_src, n_dst, 600, seed=n_dst)
    j, t = _both(coo, (n_src, n_dst), w, name)
    assert t.dense_adj.dtype == DTYPES[name][0]
    assert t.weight is None and t.bsr is None
    np.testing.assert_array_equal(_np(t.dense_adj),
                                  np.asarray(j.dense_adj, np.float32))
    if name == 'int8':
        for got, ref in zip(t.dense_scale, j.dense_scale):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        # empty rows and columns get zero scales
        assert not t.dense_scale[0][-5:].any()
        assert not t.dense_scale[1][-5:].any()
    else:
        assert t.dense_scale is None and j.dense_scale is None
    tf, jf = t.flip(), j.flip()
    np.testing.assert_array_equal(_np(tf.dense_adj),
                                  np.asarray(jf.dense_adj, np.float32))
    if name == 'int8':
        assert tf.dense_scale[0] is t.dense_scale[1]
        assert tf.dense_adj.is_contiguous()
        # the transpose is kept: a second flip copies nothing
        assert t.flip().dense_adj is tf.dense_adj
        assert tf.flip().dense_adj is t.dense_adj


@pytest.mark.parametrize('name', sorted(DTYPES))
def test_regime_matches_jax(name, monkeypatch):
    """Dense under the cap, blocks past it (forced), weights carried past
    it with the blocks declined; ``spmm_regime`` answers as the JAX
    package does."""
    coo, w, _ = _graph(80, 80, 700, seed=1)
    j, t = _both(coo, (80, 80), w, name)
    assert spmm_regime(t) == jspmm_regime(j) == 'dense-cached'
    assert spmm_regime(t, reduce='max') == 'plain'
    assert spmm_regime(t, has_edge_weight=True) == 'plain'
    monkeypatch.setenv('PGT_DENSE_SPMM_ENTRIES', str(80 * 80 - 1))
    t_dt, j_dt = DTYPES[name]
    for bs in (True, False):
        jb = JEdgeIndex(coo, (80, 80)).fill_cache(
            dense_weight=w, block_sparse=bs, cache_dtype=j_dt)
        tb = EdgeIndex(coo, (80, 80), device='cpu').fill_cache(
            dense_weight=w, block_sparse=bs, cache_dtype=t_dt)
        assert tb.dense_adj is None and jb.dense_adj is None
        assert (tb.bsr is None) == (jb.bsr is None) == (not bs)
        assert (tb.weight is None) == (jb.weight is None) == bs
        if bs:
            assert spmm_regime(tb) == jspmm_regime(jb) == 'bsr'
            # only bf16 changes the blocks' dtype
            assert tb.bsr.vals.dtype == (
                torch.bfloat16 if name == 'bf16' else torch.float32)


@pytest.mark.parametrize('name', sorted(DTYPES))
@pytest.mark.parametrize('reduce,transpose', [('sum', False),
                                              ('mean', False),
                                              ('sum', True)])
def test_dense_spmm_matches_jax(name, reduce, transpose):
    n_src, n_dst, f = 45, 70, 12
    coo, w, rng = _graph(n_src, n_dst, 600, seed=3)
    j, t = _both(coo, (n_src, n_dst), w, name)
    x = rng.standard_normal((n_dst if transpose else n_src, f)).astype(
        np.float32)
    ref = np.asarray(jspmm(j, jnp.asarray(x), reduce=reduce,
                           transpose=transpose))
    out = spmm(t, torch.from_numpy(x), reduce=reduce, transpose=transpose)
    assert out.dtype == torch.float32
    _close(out, ref, 1e-6 if name == 'int8' else 1e-5)


@pytest.mark.parametrize('reduce', ['sum', 'mean'])
def test_dense_bf16_spmm_of_bf16_x_matches_jax(reduce):
    """bf16 x over the bf16 cache: a float32 product cast back to bf16 (one
    rounding in both; a sum on a rounding boundary may land one ulp
    apart)."""
    coo, w, rng = _graph(50, 50, 600, seed=4)
    j, t = _both(coo, (50, 50), w, 'bf16')
    x = rng.standard_normal((50, 16)).astype(np.float32)
    ref = np.asarray(jspmm(j, jnp.asarray(x, jnp.bfloat16), reduce=reduce),
                     np.float32)
    out = spmm(t, torch.from_numpy(x).bfloat16(), reduce=reduce)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), ref, rtol=2 ** -8,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize('name', ['f32', 'bf16'])
@pytest.mark.parametrize('reduce,transpose', [('sum', False),
                                              ('mean', False),
                                              ('sum', True)])
def test_dense_spmm_grad_matches_jax(name, reduce, transpose):
    n_src, n_dst, f = 45, 70, 8
    coo, w, rng = _graph(n_src, n_dst, 600, seed=5)
    j, t = _both(coo, (n_src, n_dst), w, name)
    n_in, n_out = (n_dst, n_src) if transpose else (n_src, n_dst)
    x = rng.standard_normal((n_in, f)).astype(np.float32)
    c = rng.standard_normal((n_out, f)).astype(np.float32)
    gref = np.asarray(jax.grad(lambda xx: (jspmm(
        j, xx, reduce=reduce, transpose=transpose) * c).sum())(
            jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (spmm(t, xt, reduce=reduce, transpose=transpose)
     * torch.from_numpy(c)).sum().backward()
    if name == 'f32':
        _close(xt.grad, gref, 1e-5)
    else:
        # one bf16 ulp of each value: 2^(exponent - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(gref),
                                                  np.finfo(np.float32).tiny)))
                      - 7)
        err = np.abs(xt.grad.numpy() - gref)
        assert (err <= ulp + 1e-6 * np.abs(gref).max()).all(), \
            float((err / ulp).max())


def test_int8_spmm_has_no_gradient():
    """The int8 cache serves inference only: no gradient flows to x, as the
    JAX package's stop_gradient gives zeros."""
    coo, w, rng = _graph(40, 40, 300, seed=6)
    j, t = _both(coo, (40, 40), w, 'int8')
    x = rng.standard_normal((40, 4)).astype(np.float32)
    g = np.asarray(jax.grad(lambda xx: jspmm(j, xx).sum())(jnp.asarray(x)))
    assert not g.any()
    out = spmm(t, torch.from_numpy(x).requires_grad_())
    assert not out.requires_grad


def test_gcn_adam_over_dense_bf16_cache_matches_optax():
    """``bench.py``'s accelerator regime, cut to 300 nodes: GCN over
    ``fill_cache(dense_weight=w, cache_dtype=bf16)`` of the normalised
    adjacency, 4 Adam steps, from the same (converted flax) weights."""
    n, hidden, classes, steps = 300, 16, 4, 4
    rng = np.random.default_rng(7)
    coo = rng.integers(0, n, (2, 3000)).astype(np.int32)
    loops = np.arange(n, dtype=np.int32)
    coo = np.stack([np.concatenate([coo[0], loops]),
                    np.concatenate([coo[1], loops])])
    deg = np.bincount(coo[1], minlength=n).astype(np.float64)
    dinv = 1.0 / np.sqrt(deg)
    w = (dinv[coo[0]] * dinv[coo[1]]).astype(np.float32)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    y = rng.integers(0, classes, n)
    conv = {'conv_kwargs': {'normalize': False, 'add_self_loops': False}}
    jei = JEdgeIndex(coo, (n, n)).fill_cache(dense_weight=w,
                                             cache_dtype=jnp.bfloat16)
    tei = EdgeIndex(coo, (n, n), device='cpu').fill_cache(
        dense_weight=w, cache_dtype=torch.bfloat16)
    assert jspmm_regime(jei) == spmm_regime(tei) == 'dense-cached'

    jm = jmodels.GCN(hidden_channels=hidden, num_layers=3,
                     out_channels=classes, **conv)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    params = jm.init(jax.random.PRNGKey(0), xj, jei)
    tx = optax.adam(1e-2)

    def loss_fn(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            jm.apply(p, xj, jei), yj).mean()

    p, o = params, tx.init(params)
    jlosses, jgrads = [], None
    for i in range(steps):
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, o = tx.update(g, o)
        p = optax.apply_updates(p, upd)
        jlosses.append(float(loss))
        if i == 0:
            jgrads = flax_to_state_dict(g)

    tm = models.GCN(16, hidden, 3, classes, device='cpu', **conv)
    tm.load_state_dict(flax_to_state_dict(params))
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tlosses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(tm(xt, tei), yt)
        loss.backward()
        if i == 0:
            for k, ref in jgrads.items():
                _close(dict(tm.named_parameters())[k].grad, ref, 1e-3,
                       what=f'first-step grad of {k}')
        opt.step()
        tlosses.append(loss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
