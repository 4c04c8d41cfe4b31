"""The bf16 arms of the port's kernels against the JAX package, through
their plain versions on the CPU and the JAX Pallas kernels as the JAX
package's own tests run them (the BSR kernel in interpret mode, the
segment-sum kernel under ``PGT_FORCE_PALLAS=1``):

  * kernel 2, bf16 blocks: ``fill_cache(block_sparse=True,
    cache_dtype=bf16)`` bit for bit (float32 first, then bf16: the same
    double rounding), one pass against ``_bsr_matmul_impl``'s bf16 arm, and
    ``spmm``'s forward and ``grad_x`` against ``jax.grad``;
  * kernel 1, bf16 messages, through ``spmm``: unweighted sum and mean,
    bf16 weights, float32 weights (which promote the messages, and the
    result, to float32), and ``grad_x``;
  * kernel 1's per-head form (``gat_mix``), all-bf16 inputs, against
    ``_gat_mix``;
  * GraphSAGE and GIN on bf16 features against the flax models (layer 1
    aggregates bf16; flax's ``Dense`` promotes to the float32 parameters).

Tolerances and why: a bf16 result is a float32 sum rounded once, and the
two packages sum in another order, so a sum on a rounding boundary may land
one bf16 ulp apart: 2^-8 relative plus 1e-6 of the largest magnitude.
Float32 results of exact products: 1e-5 of the largest magnitude. The
models: 1e-2 of the largest output, since a flipped bf16 rounding in layer 1
moves the float32 layers after it by up to 2^-8 of a feature.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.nn import models as jmodels
from pytorch_geometric_tpu.ops import bsr_spmm as jbsr
from pytorch_geometric_tpu.ops import spmm as jspmm
from pytorch_geometric_tpu.ops import spmm_regime as jspmm_regime
from pytorch_geometric_tpu.ops.gat_fused import _gat_mix as j_gat_mix
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import models
from pytorch_geometric_tpu_torch.ops import bsr_spmm as tbsr
from pytorch_geometric_tpu_torch.ops import gat_mix, spmm, spmm_regime

BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv('PGT_FORCE_PALLAS', '1')


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, ref, tol, what=''):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _bf16_close(got, ref, what=''):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=BF16_ULP,
                               atol=1e-6 * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


# -- kernel 2, bf16 blocks ----------------------------------------------------
def _clustered(n_src, n_dst, e, seed):
    """Edges inside 128-node blocks (the first dst block row empty), a
    scattered tail left to the residual, and padded edges."""
    rng = np.random.default_rng(seed)
    c = rng.integers(1, n_dst // 128 + 1, e)
    coo = np.stack([np.clip(c * 128 + rng.integers(0, 128, e), 0, n_src - 1),
                    np.clip(c * 128 + rng.integers(0, 128, e), 128,
                            n_dst - 1)])
    tail = np.stack([rng.integers(0, n_src, 200),
                     rng.integers(128, n_dst, 200)])
    pad = [[n_src] * 6, [n_dst] * 6]
    coo = np.concatenate([coo, tail, pad], 1).astype(np.int32)
    return coo, rng.random(coo.shape[1]).astype(np.float32), rng


def _bsr_both(n_src, n_dst, seed):
    coo, w, rng = _clustered(n_src, n_dst, 9000, seed)
    j = JEdgeIndex(coo, (n_src, n_dst)).fill_cache(
        dense_weight=w, block_sparse=True, cache_dtype=jnp.bfloat16)
    t = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache(
        dense_weight=w, block_sparse=True, cache_dtype=torch.bfloat16)
    return j, t, rng


@pytest.mark.parametrize('n_src,n_dst', [(600, 600), (500, 700)])
def test_bsr_bf16_blocks_match_jax(n_src, n_dst):
    """Both layouts' bf16 blocks equal the JAX package's (without its
    spliced zero blocks), and the residual keeps float32 weights."""
    j, t, _ = _bsr_both(n_src, n_dst, seed=n_dst)
    assert spmm_regime(t) == jspmm_regime(j) == 'bsr'
    for tl, jl in ((t.bsr, j.bsr), (t.bsr_t, j.bsr_t)):
        assert tl.vals.dtype == torch.bfloat16
        assert jl.vals.dtype == jnp.bfloat16
        j_rows = np.asarray(jl.rows)
        keep = np.isin(j_rows, tbsr.block_rows(tl).numpy())
        np.testing.assert_array_equal(_f32(tl.vals),
                                      _f32(jl.vals)[keep])
        np.testing.assert_array_equal(tl.cols.numpy(),
                                      np.asarray(jl.cols)[keep])
    assert t.bsr_res.weight.dtype == torch.float32


@pytest.mark.parametrize('f', [1, 10, 16, 33])
@pytest.mark.parametrize('x_dtype', ['f32', 'bf16'])
def test_bsr_bf16_matmul_matches_jax(f, x_dtype):
    """One pass over the bf16 blocks: x rounded to bf16, exact float32
    products and sums, the result in x's dtype."""
    j, t, rng = _bsr_both(500, 700, seed=3)
    x = rng.standard_normal((500, f)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == 'bf16' else jnp.float32)
    tx = torch.from_numpy(x)
    if x_dtype == 'bf16':
        tx = tx.bfloat16()
    ref = jbsr._bsr_matmul_impl(j.bsr, jx, 700, True)
    got = tbsr.bsr_matmul(t.bsr, tx, 700)
    assert got.dtype == tx.dtype and ref.dtype == jx.dtype
    if x_dtype == 'bf16':
        _bf16_close(got, ref)
    else:
        _close(got, ref, 1e-5)


@pytest.mark.parametrize('reduce', ['sum', 'mean'])
@pytest.mark.parametrize('transpose', [False, True])
def test_bsr_bf16_spmm_matches_jax(reduce, transpose):
    """``spmm`` over the bf16 block cache (blocks plus the float32
    residual) and its ``grad_x``, whose pass rounds ``g`` to bf16 as
    ``_bsr_bwd`` does."""
    j, t, rng = _bsr_both(600, 600, seed=4)
    x = rng.standard_normal((600, 12)).astype(np.float32)
    c = rng.standard_normal((600, 12)).astype(np.float32)

    def loss(xx):
        return (jspmm(j, xx, reduce=reduce, transpose=transpose) * c).sum()

    ref = jspmm(j, jnp.asarray(x), reduce=reduce, transpose=transpose)
    gref = jax.grad(loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm(t, xt, reduce=reduce, transpose=transpose)
    (out * torch.from_numpy(c)).sum().backward()
    _close(out, ref, 1e-5, 'forward')
    _close(xt.grad, gref, 1e-5, 'grad_x')


# -- kernel 1, bf16 messages --------------------------------------------------
def _kernel1_case(seed):
    # E >= 2^14, so the JAX side's SpMM takes its Pallas kernel
    rng = np.random.default_rng(seed)
    n_src, n_dst, e = 300, 400, 16_500
    rows = rng.choice(n_dst, 3 * n_dst // 4, replace=False)   # empty rows
    coo = np.stack([rng.integers(0, n_src, e),
                    rows[rng.integers(0, len(rows), e)]])
    coo = np.concatenate([coo, [[n_src] * 5, [n_dst] * 5]], 1).astype(
        np.int32)
    w = rng.random(coo.shape[1]).astype(np.float32)
    x = rng.standard_normal((n_src, 24)).astype(np.float32)
    return coo, (n_src, n_dst), w, x, rng


@pytest.mark.parametrize('case', ['sum', 'mean', 'bf16-weights',
                                  'f32-weights'])
def test_kernel1_bf16_through_spmm_matches_jax(case):
    coo, size, w, x, _ = _kernel1_case(seed=len(case))
    reduce = 'mean' if case == 'mean' else 'sum'
    w_dt = {'bf16-weights': (jnp.bfloat16, torch.bfloat16),
            'f32-weights': (jnp.float32, torch.float32)}.get(case)
    j = JEdgeIndex(coo, size).fill_cache()
    t = EdgeIndex(coo, size, device='cpu').fill_cache()
    jw = None if w_dt is None else jnp.asarray(w, w_dt[0])
    tw = None if w_dt is None else torch.from_numpy(w).to(w_dt[1])
    assert jspmm_regime(j, has_edge_weight=jw is not None) == 'pallas'
    ref = jspmm(j, jnp.asarray(x, jnp.bfloat16), jw, reduce=reduce)
    got = spmm(t, torch.from_numpy(x).bfloat16(), tw, reduce=reduce)
    out_dt = torch.float32 if case == 'f32-weights' else torch.bfloat16
    assert got.dtype == out_dt
    assert ref.dtype == (jnp.float32 if case == 'f32-weights'
                         else jnp.bfloat16)
    if case == 'f32-weights':
        _close(got, ref, 1e-5)
    else:
        _bf16_close(got, ref)


@pytest.mark.parametrize('weighted', [False, True])
def test_kernel1_bf16_grad_matches_jax(weighted):
    """``grad_x`` of a bf16 x: the bf16 cotangent through the kernel's
    bf16 arm over the CSR, as ``_spmm_blocked_bwd`` runs it."""
    coo, size, w, x, rng = _kernel1_case(seed=7)
    c = rng.standard_normal((size[1], 24)).astype(np.float32)
    j = JEdgeIndex(coo, size).fill_cache()
    t = EdgeIndex(coo, size, device='cpu').fill_cache()
    jw = jnp.asarray(w, jnp.bfloat16) if weighted else None
    tw = torch.from_numpy(w).bfloat16() if weighted else None
    gref = jax.grad(lambda xx: (jspmm(j, xx, jw) * c).sum())(
        jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    (spmm(t, xt, tw) * torch.from_numpy(c)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    _bf16_close(xt.grad, gref)


def test_gat_mix_bf16_matches_jax():
    """The per-head form with p_s, p_u and v all bf16: each message
    bf16(p_u * v), float32 sums, s and u rounded once to bf16. The same
    per-edge p enter each package's own slot order."""
    rng = np.random.default_rng(8)
    n_src, n_dst, h, f = 250, 300, 4, 8
    rows = rng.choice(n_dst, 200, replace=False)
    coo = np.stack([rng.integers(0, n_src, 3000),
                    rows[rng.integers(0, 200, 3000)]]).astype(np.int32)
    e = coo.shape[1]
    p_s = rng.random((e, h)).astype(np.float32)
    p_u = rng.random((e, h)).astype(np.float32)
    v = rng.standard_normal((n_src, h, f)).astype(np.float32)
    j = JEdgeIndex(coo, (n_src, n_dst)).fill_cache(blocked=True)
    blk, blk_t = j.blocked, j.blocked_t

    def slots(p):
        pe = jnp.concatenate([jnp.asarray(p, jnp.bfloat16),
                              jnp.zeros((1, h), jnp.bfloat16)])
        return pe[jnp.minimum(blk.perm, e)]

    meta = (blk.src, blk.dst, blk.chunk_base, blk_t.src, blk_t.dst,
            blk_t.chunk_base, blk_t.t_pos)
    su = j_gat_mix(slots(p_s), slots(p_u), jnp.asarray(v, jnp.bfloat16),
                   meta, n_dst, n_src)
    assert su.dtype == jnp.bfloat16
    t = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache(
        blocked=True).blocked
    perm = t.perm

    def tslots(p):
        return torch.from_numpy(p).bfloat16()[perm].contiguous()

    s, u = gat_mix(t.indptr, t.src, tslots(p_s), tslots(p_u),
                   torch.from_numpy(v).bfloat16().view(n_src, h * f), f)
    assert s.dtype == u.dtype == torch.bfloat16
    _bf16_close(s, np.asarray(su, np.float32)[:, :h], 's')
    _bf16_close(u, np.asarray(su, np.float32)[:, h:], 'u')
    with pytest.raises(TypeError, match='all float32 or all bfloat16'):
        gat_mix(t.indptr, t.src, tslots(p_s).float(), tslots(p_u),
                torch.from_numpy(v).bfloat16().view(n_src, h * f), f)


# -- models on bf16 features ----------------------------------------------------
@pytest.mark.parametrize('name', ['GraphSAGE', 'GIN'])
def test_models_on_bf16_features_match_flax(name):
    """``products_bench.py``'s bf16 serving input: layer 1 aggregates bf16
    features through kernel 1's bf16 arm (the JAX ``'pallas'`` regime), and
    the float32 parameters promote everything after it to float32."""
    coo, size, _, _, rng = _kernel1_case(seed=9)
    n = 400
    coo = coo[:, (coo[0] < n) & (coo[1] < n)]
    x = rng.standard_normal((n, 16)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    j = JEdgeIndex(coo, (n, n)).fill_cache()
    t = EdgeIndex(coo, (n, n), device='cpu').fill_cache()
    jm = getattr(jmodels, name)(hidden_channels=16, num_layers=3,
                                out_channels=4)
    params = jm.init(jax.random.PRNGKey(0), xj, j)
    ref = jm.apply(params, xj, j)
    tm = getattr(models, name)(16, 16, 3, 4, device='cpu')
    tm.load_state_dict(flax_to_state_dict(params))
    with torch.inference_mode():
        out = tm(torch.from_numpy(x).bfloat16(), t)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(out, ref, 1e-2)
