"""The port's windowed, chunked and uncached dense SpMM regimes against the
JAX package's same regimes, on the CPU, from the same numpy inputs: the
windowed layouts that ``build_windowed_csc`` and ``fill_cache`` build (bit
for bit), and each regime's forward, ``grad_x`` and ``grad_w``, with
``sum`` and ``mean``, forward and transposed, square and rectangular, with
padded edges. Both packages are steered by the same knobs
(``PGT_WIN_EDGES``, ``PGT_FORCE_DENSE_SPMM``; the chunk trigger and buffer
through the environment for the port and the JAX module's constants, which
it reads once at import).

Limits: float32 outputs within ``1e-5 * max(1, max|ref|)``, gradients within
``1e-4 * max|g|``: the JAX package sums with sorted scatters, the port over
the CSC (the segment-sum kernel's plain version), in other orders."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.edge_index import \
    build_windowed_csc as jbuild_windowed_csc
from pytorch_geometric_tpu.ops import spmm as jspmm, spmm_regime as jregime
from pytorch_geometric_tpu_torch import EdgeIndex, build_windowed_csc
from pytorch_geometric_tpu_torch.ops import spmm, spmm_regime

# the modules (each package's ``ops.spmm`` names the function)
JSPMM = importlib.import_module('pytorch_geometric_tpu.ops.spmm')


def _graph(n_src, n_dst, e, f, seed, n_pad=7, n_out=5):
    """A random COO with ``n_pad`` padded edges (both endpoints one past
    the end) and ``n_out`` edges whose destination alone is out of range;
    weights and x."""
    rng = np.random.default_rng(seed)
    coo = np.stack([rng.integers(0, n_src, e), rng.integers(0, n_dst, e)])
    pad = np.stack([np.full(n_pad, n_src), np.full(n_pad, n_dst)])
    out = np.stack([rng.integers(0, n_src, n_out),
                    np.full(n_out, n_dst + 3)])
    coo = np.concatenate([coo, pad, out], 1).astype(np.int32)
    coo = coo[:, rng.permutation(coo.shape[1])]
    w = rng.random(coo.shape[1]).astype(np.float32)
    x = rng.standard_normal((n_src, f)).astype(np.float32)
    return coo, w, x


def _assert_layout(got, ref):
    for field in ('src', 'dst', 'perm', 'inv_pos'):
        g, r = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        assert g.shape == r.shape, field
        np.testing.assert_array_equal(g, r, err_msg=field)


@pytest.mark.parametrize('chunk', [None, 1, 7, 512, 10_000])
@pytest.mark.parametrize('n_src,n_dst', [(120, 120), (80, 150)])
def test_build_windowed_csc_matches_jax(monkeypatch, chunk, n_src, n_dst):
    """``build_windowed_csc`` (a stable sort on the device) gives the JAX
    package's host layout value for value, pads and clamped destinations
    included; ``chunk=None`` reads ``PGT_WIN_EDGES`` in both."""
    monkeypatch.setenv('PGT_WIN_EDGES', '300')
    coo, _, _ = _graph(n_src, n_dst, 2000, 1, seed=n_dst)
    got = build_windowed_csc(torch.from_numpy(coo), n_dst, n_src, chunk)
    ref = jbuild_windowed_csc(coo, n_dst, n_src, chunk)
    _assert_layout(got, ref)
    # the CSC's row pointer delimits each destination's run of flat slots
    # (the CSC is a view of the layout's first E slots)
    ip = EdgeIndex(coo, (n_src, n_dst), device='cpu').get_csc()
    ip = ip.indptr.numpy()
    flat = got.dst.numpy().reshape(-1)
    assert ip[0] == 0 and np.all(np.diff(ip) >= 0)
    np.testing.assert_array_equal(
        np.repeat(np.arange(n_dst), np.diff(ip)), flat[:ip[-1]])
    assert np.all(flat[ip[-1]:] == n_dst)


def test_build_windowed_csc_empty():
    coo = np.zeros((2, 0), np.int32)
    got = build_windowed_csc(torch.from_numpy(coo), 4, 3)
    _assert_layout(got, jbuild_windowed_csc(coo, 4, 3))
    assert got.dst.tolist() == [[4]] and got.inv_pos.numel() == 0


@pytest.mark.parametrize('n_src,n_dst', [(150, 150), (90, 140)])
def test_fill_cache_windowed_layouts_match_jax(monkeypatch, n_src, n_dst):
    """``fill_cache(windowed=True)`` builds both orientations' layouts as
    the JAX package does, bit for bit; the port's CSC and CSR are views of
    them (the same values as its own sort), and ``flip`` swaps them."""
    monkeypatch.setenv('PGT_WIN_EDGES', '256')
    coo, _, _ = _graph(n_src, n_dst, 1500, 1, seed=3)
    got = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache(
        windowed=True)
    ref = JEdgeIndex(coo, (n_src, n_dst)).fill_cache(windowed=True)
    _assert_layout(got.win, ref.win)
    _assert_layout(got.win_t, ref.win_t)
    plain = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache()
    e = coo.shape[1]
    for o, p, w in ((got.csc, plain.csc, got.win),
                    (got.csr, plain.csr, got.win_t)):
        assert torch.equal(o.indptr, p.indptr)
        assert torch.equal(o.indices, p.indices)
        assert torch.equal(o.perm, p.perm)
        assert o.indices.data_ptr() == w.src.data_ptr()
        assert o.perm.data_ptr() == w.perm.data_ptr()
        np.testing.assert_array_equal(
            np.repeat(np.arange(o.indptr.shape[0] - 1),
                      np.diff(o.indptr.numpy())),
            w.dst.numpy().reshape(-1)[:int(o.indptr[-1])])
        assert o.indices.shape[0] == e
    f = got.flip()
    assert f.win is got.win_t and f.win_t is got.win
    # windowed=False builds none, even under auto
    assert EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache(
        windowed=False, auto=True).win is None


def _arm(monkeypatch, arm, coo, n_src, n_dst):
    """Both packages' EdgeIndex, steered into ``arm`` by the same knobs."""
    jei = JEdgeIndex(coo, (n_src, n_dst))
    tei = EdgeIndex(coo, (n_src, n_dst), device='cpu')
    if arm == 'windowed':
        monkeypatch.setenv('PGT_WIN_EDGES', '512')
        return jei.fill_cache(windowed=True), tei.fill_cache(windowed=True)
    if arm == 'chunked':
        monkeypatch.setenv('PGT_SPMM_CHUNK_TRIGGER', '0')
        monkeypatch.setenv('PGT_SPMM_CHUNK_BUF', str(1 << 20))
        monkeypatch.setattr(JSPMM, '_CHUNK_TRIGGER_BYTES', 0.0)
        monkeypatch.setattr(JSPMM, '_CHUNK_BUF_BYTES', float(1 << 20))
        return jei, tei
    monkeypatch.setenv('PGT_FORCE_DENSE_SPMM', '1')
    return jei, tei


@pytest.mark.parametrize('arm', ['windowed', 'chunked', 'dense'])
@pytest.mark.parametrize('reduce', ['sum', 'mean'])
@pytest.mark.parametrize('transpose', [False, True])
@pytest.mark.parametrize('n_src,n_dst', [(160, 160), (100, 170)])
def test_regime_matches_jax(monkeypatch, arm, reduce, transpose, n_src,
                            n_dst):
    """Each regime's forward, ``grad_x`` and ``grad_w`` against the JAX
    package's same regime: weights that need a gradient, padded edges and
    out-of-range destinations. The chunked regime runs 2**20 / (F * 4)
    edges a chunk (at least 2**16, so one chunk here) in both; the
    windowed one 512-edge windows."""
    f = 12
    coo, w, x = _graph(n_src, n_dst, 3000, f, seed=n_src + n_dst)
    if transpose:
        # A^T x: x has a row per destination
        x = np.random.default_rng(4).standard_normal(
            (n_dst, f)).astype(np.float32)
    jei, tei = _arm(monkeypatch, arm, coo, n_src, n_dst)
    assert jregime(jei.flip() if transpose else jei, f, reduce, True) == arm
    assert spmm_regime(tei.flip() if transpose else tei, f, reduce,
                       True) == arm
    g = np.random.default_rng(1).standard_normal(
        (n_src if transpose else n_dst, f)).astype(np.float32)

    def jf(xx, ww):
        return jspmm(jei, xx, ww, reduce=reduce, transpose=transpose)

    ref, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    rgx, rgw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    ref = np.asarray(ref)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    out = spmm(tei, tx, tw, reduce=reduce, transpose=transpose)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    for got, want in ((tx.grad, rgx), (tw.grad, rgw)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize('arm', ['windowed', 'chunked'])
def test_regime_unweighted_and_several_chunks(monkeypatch, arm):
    """Unweighted, over several windows or chunks (the chunked regime at
    its least chunk, 2**16 edges, over 150,000 edges), against the JAX
    package's same regime: output and ``grad_x``."""
    n, f = 3000, 4
    coo, _, x = _graph(n, n, 150_000, f, seed=5)
    jei, tei = _arm(monkeypatch, arm, coo, n, n)
    monkeypatch.setenv('PGT_SPMM_CHUNK_BUF', '1')
    monkeypatch.setattr(JSPMM, '_CHUNK_BUF_BYTES', 1.0)
    if arm == 'windowed':
        assert tei.win.src.shape[0] > 100
    g = np.random.default_rng(2).standard_normal((n, f)).astype(np.float32)
    ref, vjp = jax.vjp(lambda xx: jspmm(jei, xx, reduce='mean'),
                       jnp.asarray(x))
    (rgx,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    out = spmm(tei, tx, reduce='mean')
    out.backward(torch.from_numpy(g))
    ref, rgx = np.asarray(ref), np.asarray(rgx)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    np.testing.assert_allclose(tx.grad.numpy(), rgx, rtol=0,
                               atol=1e-4 * np.abs(rgx).max())


def test_chunked_counts_its_chunks(monkeypatch):
    """The chunked regime's passes: one segment-sum pass per chunk forward
    and again for ``grad_x``, one dot a chunk for ``grad_w`` (counted here
    on the plain versions the CPU runs)."""
    from pytorch_geometric_tpu_torch.ops import chunked_spmm as cm
    n, f = 400, 4
    coo, w, x = _graph(n, n, 200_000, f, seed=6)
    _, tei = _arm(monkeypatch, 'chunked', coo, n, n)
    monkeypatch.setenv('PGT_SPMM_CHUNK_BUF', '1')
    calls = {'sum': 0, 'dot': 0}
    seg, dot = cm.segment_spmm, cm.edge_dot

    def count_seg(*a, **k):
        calls['sum'] += 1
        return seg(*a, **k)

    def count_dot(*a, **k):
        calls['dot'] += 1
        return dot(*a, **k)

    monkeypatch.setattr(cm, 'segment_spmm', count_seg)
    monkeypatch.setattr(cm, 'edge_dot', count_dot)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    spmm(tei, tx, tw).sum().backward()
    chunks = -(-coo.shape[1] // (1 << 16))
    assert calls == {'sum': 2 * chunks, 'dot': chunks}
