"""The PyTorch port's segment-sum SpMM (the plain version the wrapper runs
for CPU tensors) and the ops around it, against the JAX package on the same
numpy inputs. The JAX side runs its Pallas kernel in interpret mode
(``PGT_FORCE_PALLAS=1``, as ``tests/test_pallas.py`` does).

Tolerance: f32 sums taken in another order, rtol/atol 1e-5 per op."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.ops import (index2ptr as jindex2ptr,
                                       ptr2index as jptr2index,
                                       scatter as jscatter, spmm as jspmm)
from pytorch_geometric_tpu.ops.pallas_spmm import (segment_sum_sorted,
                                                   spmm_pallas)
from pytorch_geometric_tpu_torch import EdgeIndex, backend
from pytorch_geometric_tpu_torch.ops import (index2ptr, ptr2index, scatter,
                                             segment_spmm,
                                             segment_spmm_plain, spmm,
                                             spmm_regime)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv('PGT_FORCE_PALLAS', '1')


def _graph(n_src, n_dst, e, f, seed, n_pad=0):
    rng = np.random.default_rng(seed)
    # dst drawn from two thirds of the rows: the rest stay empty
    rows = rng.choice(n_dst, max(1, 2 * n_dst // 3), replace=False)
    coo = np.stack([rng.integers(0, n_src, e), rows[rng.integers(
        0, len(rows), e)]])
    pad = np.stack([np.full(n_pad, n_src), np.full(n_pad, n_dst)])
    coo = np.concatenate([coo, pad], axis=1).astype(np.int32)
    w = rng.random(coo.shape[1]).astype(np.float32)
    x = rng.standard_normal((n_src, f)).astype(np.float32)
    return coo, w, x


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize('f', [1, 10, 24])
@pytest.mark.parametrize('weighted', [True, False])
@pytest.mark.parametrize('n_src,n_dst', [(150, 150), (90, 200)])
def test_segment_spmm_matches_pallas_segment_sum(f, weighted, n_src, n_dst):
    coo, w, x = _graph(n_src, n_dst, 2500, f, seed=f + n_dst, n_pad=9)
    csc = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache().csc
    e = int(csc.indptr[-1])
    src = csc.indices.numpy()[:e]
    dst = np.repeat(np.arange(n_dst), np.diff(csc.indptr.numpy()))
    w_s = w[csc.perm.numpy()]
    msg = x[src] * (w_s[:e, None] if weighted else 1.0)
    ref = segment_sum_sorted(jnp.asarray(msg), jnp.asarray(dst), n_dst)
    out = segment_spmm(csc.indptr, csc.indices,
                       _t(w_s) if weighted else None, _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(
        out.numpy(), segment_spmm_plain(csc.indptr, csc.indices,
                                        _t(w_s) if weighted else None,
                                        _t(x)).numpy())


@pytest.mark.parametrize('f', [1, 10, 24])
@pytest.mark.parametrize('weighted', [True, False])
@pytest.mark.parametrize('n_src,n_dst', [(150, 150), (90, 200)])
def test_spmm_matches_spmm_pallas(f, weighted, n_src, n_dst):
    coo, w, x = _graph(n_src, n_dst, 3000, f, seed=2 * f + n_src, n_pad=5)
    j = JEdgeIndex(coo, (n_src, n_dst)).fill_cache()
    assert j.blocked is not None
    ref = spmm_pallas(j, jnp.asarray(x), jnp.asarray(w) if weighted
                      else None)
    t = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache()
    out = spmm(t, _t(x), _t(w) if weighted else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('reduce', ['mean', 'max', 'min'])
@pytest.mark.parametrize('n_src,n_dst', [(120, 120), (80, 140)])
def test_spmm_reduce_matches_jax(reduce, n_src, n_dst):
    coo, w, x = _graph(n_src, n_dst, 1500, 7, seed=11, n_pad=4)
    j = JEdgeIndex(coo, (n_src, n_dst)).fill_cache()
    t = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache()
    ref = jspmm(j, jnp.asarray(x), jnp.asarray(w), reduce=reduce)
    out = spmm(t, _t(x), _t(w), reduce=reduce)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if n_src == n_dst:
        # raw COO builds its CSC on the fly; its inferred size counts the
        # padding row, which stays empty
        out_raw = spmm(_t(coo), _t(x), _t(w), reduce=reduce)
        np.testing.assert_allclose(out_raw.numpy()[:n_dst],
                                   np.asarray(ref), **TOL)


def test_plain_knob_and_regime(monkeypatch):
    coo, w, x = _graph(60, 60, 400, 5, seed=1)
    t = EdgeIndex(coo, (60, 60), device='cpu').fill_cache()
    assert spmm_regime(t) == 'plain'
    assert spmm_regime(t, reduce='max') == 'plain'
    ref = spmm(t, _t(x), _t(w))
    monkeypatch.setattr(backend, 'use_kernel_spmm', False)
    np.testing.assert_array_equal(spmm(t, _t(x), _t(w)).numpy(),
                                  ref.numpy())


def test_wrapper_checks_inputs():
    coo, w, x = _graph(40, 40, 200, 8, seed=2)
    csc = EdgeIndex(coo, (40, 40), device='cpu').fill_cache().csc
    ip, src, xt = csc.indptr, csc.indices, _t(x)
    launches = segment_spmm.launches
    with pytest.raises(TypeError, match='float32'):
        segment_spmm(ip, src, None, xt.double())
    with pytest.raises(ValueError, match='contiguous 2-D'):
        segment_spmm(ip, src, None, xt.t())
    with pytest.raises(ValueError, match='indptr'):
        segment_spmm(ip.long(), src, None, xt)
    with pytest.raises(ValueError, match='w has'):
        segment_spmm(ip, src, _t(w[:10]), xt)
    segment_spmm(ip, src, None, xt)
    # the plain version on a CPU tensor is no kernel launch
    assert segment_spmm.launches == launches


@pytest.mark.parametrize('reduce', ['sum', 'mean', 'min', 'max'])
def test_scatter_matches_jax(reduce):
    rng = np.random.default_rng(4)
    src = rng.standard_normal((300, 6)).astype(np.float32)
    index = rng.integers(-2, 45, 300).astype(np.int32)  # out of range too
    mask = rng.random(300) > 0.2
    for m in (None, mask):
        ref = jscatter(jnp.asarray(src), jnp.asarray(index), 40, reduce,
                       mask=None if m is None else jnp.asarray(m))
        out = scatter(_t(src), _t(index), 40, reduce,
                      mask=None if m is None else _t(m))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _extreme_rows(dtype, rng, n):
    """``[n, 5]`` values of ``dtype`` with the min/max identities (float
    ``+-inf``, integer ``iinfo`` extremes) mixed among ordinary values."""
    if np.issubdtype(dtype, np.floating):
        lo, hi = -np.inf, np.inf
        vals = rng.standard_normal((n, 5)).astype(dtype)
    else:
        lo, hi = np.iinfo(dtype).min, np.iinfo(dtype).max
        vals = rng.integers(-50, 50, (n, 5)).astype(dtype)
    pick = rng.random((n, 5))
    vals[pick < 0.3] = lo
    vals[pick > 0.7] = hi
    return vals


@pytest.mark.parametrize('reduce', ['min', 'max'])
@pytest.mark.parametrize('dtype', [np.float32, np.int32])
def test_scatter_identities_match_jax(reduce, dtype):
    """A min/max output equal to the reduction's identity is 0, as in the
    JAX package, empty segment or not; the other extreme stays."""
    rng = np.random.default_rng(9)
    src = _extreme_rows(dtype, rng, 200)
    index = rng.integers(0, 45, 200).astype(np.int32)  # 40 segments
    index[:12] = 3                                       # a long segment
    src[:12, 0] = src[0, 0]                              # all one extreme
    for m in (None, rng.random(200) > 0.2):
        ref = np.asarray(jscatter(
            jnp.asarray(src), jnp.asarray(index), 40, reduce,
            mask=None if m is None else jnp.asarray(m)))
        out = scatter(_t(src), _t(index), 40, reduce,
                      mask=None if m is None else _t(m)).numpy()
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)
    small = np.array([[-np.inf, 1], [-np.inf, 2], [3, np.inf]], np.float32)
    out = scatter(_t(small), torch.tensor([0, 0, 1]), 3, reduce).numpy()
    want = ([[0, 2], [3, np.inf], [0, 0]] if reduce == 'max' else
            [[-np.inf, 1], [3, 0], [0, 0]])
    np.testing.assert_array_equal(out, np.array(want, np.float32))


@pytest.mark.parametrize('reduce', ['min', 'max'])
@pytest.mark.parametrize('n_src,n_dst', [(120, 120), (80, 140)])
def test_spmm_reduce_with_infinities_matches_jax(reduce, n_src, n_dst):
    coo, _, _ = _graph(n_src, n_dst, 1500, 5, seed=12, n_pad=4)
    x = _extreme_rows(np.float32, np.random.default_rng(13), n_src)
    # every message of column 0 is -inf and of column 1 +inf: each segment's
    # max (min) there is the identity
    x[:, 0], x[:, 1] = -np.inf, np.inf
    j = JEdgeIndex(coo, (n_src, n_dst)).fill_cache()
    t = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache()
    ref = np.asarray(jspmm(j, jnp.asarray(x), reduce=reduce))
    out = spmm(t, _t(x), reduce=reduce).numpy()
    assert np.isinf(ref).any()          # the other extreme survives
    np.testing.assert_array_equal(out, ref)


def test_ptr_index_roundtrip_matches_jax():
    rng = np.random.default_rng(6)
    index = np.sort(rng.integers(0, 30, 200)).astype(np.int32)
    ptr = index2ptr(_t(index), 35)
    np.testing.assert_array_equal(ptr.numpy(),
                                  np.asarray(jindex2ptr(jnp.asarray(index),
                                                        35)))
    np.testing.assert_array_equal(
        ptr2index(ptr, 200).numpy(),
        np.asarray(jptr2index(jnp.asarray(ptr.numpy()), 200)))
    np.testing.assert_array_equal(ptr2index(ptr).numpy(), index)
