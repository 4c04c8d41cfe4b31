"""The PyTorch port's EdgeIndex against the JAX package's, on the same numpy
COO: cached CSR/CSC (indptr, indices, perm), padded edges, flip, carried
weights. Integer layouts must be equal; the SpMM through carried weights
agrees to f32 rounding (rtol/atol 1e-5: the JAX side sums a baked dense
adjacency in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.ops import spmm as jspmm
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.ops import spmm, spmm_regime


def _coo(n_src, n_dst, e, n_pad, seed):
    rng = np.random.default_rng(seed)
    coo = np.stack([rng.integers(0, n_src, e), rng.integers(0, n_dst, e)])
    pad = np.stack([np.full(n_pad, n_src), np.full(n_pad, n_dst)])
    return np.concatenate([coo, pad], axis=1).astype(np.int32)


def _same_layout(t, j):
    for name in ('indptr', 'indices', 'perm'):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)


@pytest.mark.parametrize('n_src,n_dst,n_pad', [(40, 40, 0), (40, 40, 7),
                                               (30, 55, 5)])
def test_fill_cache_layouts_match_jax(n_src, n_dst, n_pad):
    coo = _coo(n_src, n_dst, 300, n_pad, seed=n_src + n_pad)
    j = JEdgeIndex(coo, (n_src, n_dst)).fill_cache()
    t = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache()
    _same_layout(t.csr, j.csr)
    _same_layout(t.csc, j.csc)
    # padded edges sort past the last real row
    assert int(t.csc.indptr[-1]) == 300
    assert t.num_edges == 300 + n_pad


def test_device_sort_matches_host_sort():
    """Built from a tensor (no host copy), the CSR/CSC come from torch's
    sort on the device; they equal the host build and the JAX one."""
    coo = _coo(35, 50, 400, 6, seed=3)
    j = JEdgeIndex(coo, (35, 50)).fill_cache()
    t = EdgeIndex(torch.from_numpy(coo), (35, 50)).fill_cache()
    assert t.device.type == 'cpu'
    _same_layout(t.csr, j.csr)
    _same_layout(t.csc, j.csc)
    _same_layout(t.get_csc(), j.get_csc())


def test_flip_swaps_orientations():
    coo = _coo(30, 45, 200, 4, seed=5)
    w = torch.rand(204, generator=torch.Generator().manual_seed(0))
    t = EdgeIndex(coo, (30, 45), device='cpu').fill_cache(dense_weight=w)
    f = t.flip()
    jf = JEdgeIndex(coo, (30, 45)).fill_cache().flip()
    assert f.sparse_size == (45, 30) == tuple(jf.sparse_size)
    np.testing.assert_array_equal(f.coo.numpy(), np.asarray(jf.coo))
    _same_layout(f.csc, jf.csc)
    _same_layout(f.csr, jf.csr)
    assert f.weight is t.weight
    # a flip's CSC is what the transpose build would sort
    _same_layout(f.csc, EdgeIndex(np.ascontiguousarray(coo[::-1]), (45, 30),
                                  device='cpu').fill_cache().csc)


@pytest.mark.parametrize('transpose', [False, True])
def test_carried_weight_matches_jax_baked_cache(transpose, monkeypatch):
    """Past the dense cap with the blocks declined, fill_cache(dense_weight=
    w, block_sparse=False) carries w for the sparse path; the JAX package,
    under its default cap, bakes it into a dense adjacency on a graph this
    small. Both must give the same A x."""
    n_src, n_dst = 30, 45
    coo = _coo(n_src, n_dst, 250, 3, seed=9)
    rng = np.random.default_rng(1)
    w = rng.random(coo.shape[1]).astype(np.float32)
    x = rng.standard_normal((n_dst if transpose else n_src, 12)).astype(
        np.float32)
    j = JEdgeIndex(coo, (n_src, n_dst)).fill_cache(dense_weight=w)
    assert j.dense_adj is not None
    monkeypatch.setenv('PGT_DENSE_SPMM_ENTRIES', '0')
    t = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache(
        dense_weight=w, block_sparse=False)
    assert t.dense_adj is None and t.bsr is None
    np.testing.assert_array_equal(t.weight.numpy(), w)
    ref = np.asarray(jspmm(j, jnp.asarray(x), transpose=transpose))
    out = t.matmul(torch.from_numpy(x), transpose=transpose).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    out2 = spmm(t, torch.from_numpy(x), transpose=transpose).numpy()
    np.testing.assert_array_equal(out, out2)


@pytest.mark.parametrize('carried_by', ['constructor', 'fill_cache'])
@pytest.mark.parametrize('cache', ['dense', 'bsr', 'none'])
def test_new_weights_replace_carried_weights(carried_by, cache, monkeypatch):
    """An EdgeIndex that carries weights w1, given new weights w2 by
    ``fill_cache(dense_weight=w2)``, serves w2: baked into a dense cache
    under the cap, into the block cache past it, or carried in w1's place
    when no cache is baked. ``A x`` equals the plain product with w2."""
    n = 40
    coo = _coo(n, n, 300, 4, seed=21)
    rng = np.random.default_rng(5)
    w1, w2 = rng.random((2, coo.shape[1])).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    base = EdgeIndex(coo, (n, n), device='cpu')
    if carried_by == 'constructor':
        t = EdgeIndex(coo, (n, n), device='cpu', weight=torch.from_numpy(w1))
    else:
        monkeypatch.setenv('PGT_DENSE_SPMM_ENTRIES', '0')
        t = base.fill_cache(dense_weight=w1, block_sparse=False)
        monkeypatch.delenv('PGT_DENSE_SPMM_ENTRIES')
    np.testing.assert_array_equal(t.weight.numpy(), w1)
    if cache != 'dense':
        monkeypatch.setenv('PGT_DENSE_SPMM_ENTRIES', '0')
    t2 = t.fill_cache(dense_weight=w2, block_sparse={
        'dense': None, 'bsr': True, 'none': False}[cache])
    want = {'dense': 'dense-cached', 'bsr': 'bsr', 'none': 'plain'}[cache]
    assert spmm_regime(t2) == want
    if cache == 'none':
        np.testing.assert_array_equal(t2.weight.numpy(), w2)
    else:
        assert t2.weight is None
    ref = spmm(base, x, edge_weight=torch.from_numpy(w2))
    torch.testing.assert_close(t2.matmul(x), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('call', ['positional', 'keyword'])
def test_fill_cache_takes_blocked_first(call):
    """``fill_cache(True)`` and ``fill_cache(blocked=True)`` mean what they
    mean in the JAX package: the first parameter is ``blocked``. Both build
    the same CSR / CSC as the JAX package, and the slot orders."""
    coo = _coo(40, 55, 300, 6, seed=11)
    args, kw = ((True,), {}) if call == 'positional' else ((),
                                                            {'blocked': True})
    j = JEdgeIndex(coo, (40, 55)).fill_cache(*args, **kw)
    t = EdgeIndex(coo, (40, 55), device='cpu').fill_cache(*args, **kw)
    _same_layout(t.csr, j.csr)
    _same_layout(t.csc, j.csc)
    assert t.weight is None and t.bsr is None
    assert t.blocked is not None and t.blocked_t is not None
    assert EdgeIndex(coo, (40, 55), device='cpu').fill_cache(
        False).blocked is None


@pytest.mark.parametrize('n_src,n_dst,n_pad', [(40, 40, 0), (30, 55, 5)])
def test_slot_orders_match_jax_blocked(n_src, n_dst, n_pad):
    """Each edge's slot in the port's slot orders holds the same edge as in
    the JAX package's blocked layouts, the edges in no JAX slot sit in no
    row's slot (past ``indptr[-1]``), and ``t_pos`` links the two orders;
    ``flip`` swaps them."""
    coo = _coo(n_src, n_dst, 300, n_pad, seed=n_dst + n_pad)
    e = coo.shape[1]
    j = JEdgeIndex(coo, (n_src, n_dst)).fill_cache(blocked=True)
    t = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache()
    for ts, js, own, other, n in ((t.blocked, j.blocked, 1, 0, n_dst),
                                  (t.blocked_t, j.blocked_t, 0, 1, n_src)):
        jperm, jinv = np.asarray(js.perm), np.asarray(js.inv_pos)
        jin = jinv < len(jperm)
        inv = ts.inv_pos.numpy()
        nnz = int(ts.indptr[-1])
        np.testing.assert_array_equal(inv < nnz, jin)
        np.testing.assert_array_equal(ts.perm.numpy()[inv], np.arange(e))
        np.testing.assert_array_equal(jperm[jinv[jin]], np.arange(e)[jin])
        # each slot's row and other endpoint are its edge's
        real = np.arange(e) < nnz
        edges = ts.perm.numpy()[real]
        np.testing.assert_array_equal(ts.dst.numpy()[real], coo[own][edges])
        np.testing.assert_array_equal(ts.src.numpy()[real],
                                      coo[other][edges])
        assert (ts.dst.numpy()[~real] == n).all()
    # t_pos: each slot's edge sits at t_pos in the other order
    assert torch.equal(t.csr.perm[t.blocked.t_pos], t.csc.perm)
    assert torch.equal(t.csc.perm[t.blocked_t.t_pos], t.csr.perm)
    f = t.flip()
    assert f.blocked is t.blocked_t and f.blocked_t is t.blocked


@pytest.mark.parametrize('kwargs', [{'block_sparse': True,
                                     'cache_dtype': torch.bfloat16},
                                    {'cache_dtype': torch.bfloat16},
                                    {'windowed': True}, {'auto': True}])
def test_unported_caches_raise(kwargs):
    """The windowed and auto caches are not ported and raise. The two
    ``cache_dtype`` cases are ported: with weights they bake what the JAX
    package bakes (bf16 blocks, a dense bf16 adjacency), bitwise."""
    coo = _coo(10, 10, 30, 0, seed=0)
    t = EdgeIndex(coo, (10, 10), device='cpu')
    if 'cache_dtype' not in kwargs:
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            t.fill_cache(**kwargs)
        return
    w = np.random.default_rng(0).random(30).astype(np.float32)
    got = t.fill_cache(dense_weight=w, **kwargs)
    ref = JEdgeIndex(coo, (10, 10)).fill_cache(
        dense_weight=w, **dict(kwargs, cache_dtype=jnp.bfloat16))
    if kwargs.get('block_sparse'):
        assert got.dense_adj is None and ref.dense_adj is None
        got_v, ref_v = got.bsr.vals, ref.bsr.vals
    else:
        assert got.bsr is None and ref.bsr is None
        got_v, ref_v = got.dense_adj, ref.dense_adj
    assert got_v.dtype == torch.bfloat16 and got.weight is None
    np.testing.assert_array_equal(got_v.float().numpy(),
                                  np.asarray(ref_v, np.float32))


def test_sparse_size_inferred_and_shape_checked():
    coo = _coo(12, 12, 40, 0, seed=2)
    t = EdgeIndex(coo, device='cpu')
    assert t.sparse_size == (int(coo.max()) + 1,) * 2
    with pytest.raises(ValueError, match=r'\[2, E\]'):
        EdgeIndex(np.zeros((3, 4), np.int32), device='cpu')
