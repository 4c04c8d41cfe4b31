"""The port's SDDMM and fused segment softmax (``ops/sddmm.py``) and the
wide-gather union attention (``ops/edge_attention.py``) against the JAX
package's ``ops.sddmm`` / ``ops.edge_attention``, on the same numpy inputs.

The JAX side runs its Pallas kernels as ``tests/test_sddmm.py`` runs them on
the CPU, in interpret mode under ``PGT_FORCE_PALLAS=1``; the port runs its
kernels' plain versions (``edge_dot_plain``, ``gat_mix_plain``) through the
same wrappers and autograd Functions that serve the card.

The cases follow ``tests/test_sddmm.py`` (the dense match, 2-D inputs,
``edge_softmax`` against the plain route, the mask, the ``softmax(
edge_index=)`` dispatch, the aggregate and its gradient, the union softmax
and its gradient, isolated rows), then ``sddmm``'s gradient with and
without slot orders, ``edge_dot_plain``'s rules and ``H * F = 40``, and the
wide union attention's output and gradients.

Tolerances: 1e-4 of the reference's largest magnitude for outputs and
gradients (float32 sums in another order), as ``tests/test_torch_gat.py``;
bf16 scores 2e-2 of it (bf16 rounds the products and the result, about 8
bits each, and the two packages may place the roundings apart by one ulp)."""

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.edge_index import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.ops import softmax as jsoftmax
from pytorch_geometric_tpu.ops import edge_attention as jattn
from pytorch_geometric_tpu_torch import EdgeIndex, backend
from pytorch_geometric_tpu_torch.ops import edge_attention as tattn
from pytorch_geometric_tpu_torch.ops import softmax as tsoftmax
from pytorch_geometric_tpu_torch.ops.gat_fused import fused_ok, gat_mix

# the modules (both packages' ``ops`` export functions named ``sddmm`` and
# ``softmax``)
jsddmm = importlib.import_module('pytorch_geometric_tpu.ops.sddmm')
tsddmm = importlib.import_module('pytorch_geometric_tpu_torch.ops.sddmm')
tdot = importlib.import_module('pytorch_geometric_tpu_torch.ops.edge_dot')
tsoftmax_mod = importlib.import_module(
    'pytorch_geometric_tpu_torch.ops.softmax')

TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv('PGT_FORCE_PALLAS', '1')


def _close(got, ref, tol=TOL, what=''):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _coo(n=60, e=400, pad=32, seed=0, n_src=None):
    """``tests/test_sddmm.py::_graph``'s COO: random edges plus ``pad``
    edges with both endpoints at ``n``."""
    r = np.random.default_rng(seed)
    n_src = n if n_src is None else n_src
    row = np.concatenate([r.integers(0, n_src, e), np.full(pad, n_src)])
    col = np.concatenate([r.integers(0, n, e), np.full(pad, n)])
    return np.stack([row, col]).astype(np.int32)


def _pair(coo, n_src, n_dst, cached=True):
    j = JEdgeIndex(jnp.asarray(coo), sparse_size=(n_src, n_dst))
    t = EdgeIndex(coo, (n_src, n_dst), device='cpu')
    if cached:
        j, t = j.fill_cache(blocked=True), t.fill_cache(blocked=True)
    return j, t


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# -- sddmm --------------------------------------------------------------------
@pytest.mark.parametrize('shape', ['heads', '2d'])
@pytest.mark.parametrize('cached', [True, False])
def test_sddmm_matches_jax(shape, cached):
    """Scores of every edge, 0 for the padded ones, and with a mask."""
    rng = np.random.default_rng(1)
    n = 40
    coo = _coo(n=n, e=150, pad=10, seed=2)
    jei, tei = _pair(coo, n, n, cached)
    dims = (n, 3, 8) if shape == 'heads' else (n, 8)
    a = rng.standard_normal(dims).astype(np.float32)
    b = rng.standard_normal(dims).astype(np.float32)
    mask = rng.random(coo.shape[1]) < 0.7
    for m in (None, mask):
        ref = jsddmm.sddmm(jei, jnp.asarray(a), jnp.asarray(b),
                           None if m is None else jnp.asarray(m))
        out = tsddmm.sddmm(tei, _t(a), _t(b), None if m is None else _t(m))
        _close(out, ref, what=f'sddmm {shape}')
        assert (out[coo[1] >= n] == 0).all()


@pytest.mark.parametrize('cached', [True, False])
def test_sddmm_gradient_matches_jax(cached):
    """Gradients of a and b over the slot orders (the mix kernel's plain
    version, both orientations) and without them (``index_add_``), on a
    bipartite graph with padded edges and a mask."""
    rng = np.random.default_rng(3)
    n_src, n_dst, h, f = 50, 70, 2, 8
    coo = _coo(n=n_dst, e=300, pad=9, seed=4, n_src=n_src)
    jei, tei = _pair(coo, n_src, n_dst, cached)
    a = rng.standard_normal((n_src, h, f)).astype(np.float32)
    b = rng.standard_normal((n_dst, h, f)).astype(np.float32)
    c = rng.standard_normal((coo.shape[1], h)).astype(np.float32)
    mask = rng.random(coo.shape[1]) < 0.8

    def jloss(a, b):
        return (jsddmm.sddmm(jei, a, b, jnp.asarray(mask))
                * jnp.asarray(c)).sum()

    ja, jb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a, True), _t(b, True)
    before = gat_mix.launches
    (tsddmm.sddmm(tei, ta, tb, _t(mask)) * _t(c)).sum().backward()
    assert gat_mix.launches == before          # the CPU runs plain versions
    _close(ta.grad, ja, what='grad a')
    _close(tb.grad, jb, what='grad b')


# -- edge_dot's rules ---------------------------------------------------------
@pytest.mark.parametrize('h,f', [(4, 10), (1, 8), (4, 64)])
def test_edge_dot_plain_rules(h, f):
    """0 for a negative index, an index past either table and a masked
    edge; otherwise the dot of the two rows (``H * F = 40`` is path I's last
    layer, a head 40 bytes wide); rows with a stride of their own."""
    rng = np.random.default_rng(h * f)
    na, nb, e = 30, 20, 200
    a = torch.from_numpy(rng.standard_normal((na, h, f)).astype(np.float32))
    wide = torch.from_numpy(
        rng.standard_normal((nb, 2 * h * f)).astype(np.float32))
    b = wide[:, h * f:].view(nb, h, f)         # a row stride of 2 H F
    ia = rng.integers(-3, na + 3, e)
    ib = rng.integers(-3, nb + 3, e)
    mask = rng.random(e) < 0.8
    out = tdot.edge_dot(a, b, torch.from_numpy(ia).int(),
                          torch.from_numpy(ib), torch.from_numpy(mask))
    assert out.shape == (e, h) and out.dtype == torch.float32
    an, bn = a.numpy(), b.numpy()
    for k in range(e):
        ok = 0 <= ia[k] < na and 0 <= ib[k] < nb and mask[k]
        want = (an[ia[k]] * bn[ib[k]]).sum(-1) if ok else np.zeros(h)
        np.testing.assert_allclose(out[k].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    # one head as 2-D tables gives [E]
    flat = tdot.edge_dot(a[:, 0], b[:, 0].contiguous(),
                           torch.from_numpy(ia), torch.from_numpy(ib))
    assert flat.shape == (e,)
    torch.testing.assert_close(
        flat, tdot.edge_dot(a, b, torch.from_numpy(ia),
                              torch.from_numpy(ib))[:, 0])
    # nothing to score
    empty = tdot.edge_dot(a, b, torch.zeros(0, dtype=torch.int32),
                            torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, h)


def test_dot_slice_heads_rule():
    """The dot kernel's slice width: the most whole heads whose slice of
    the larger table fits half the L2 (the mix's share); one head when none
    does. On an H100 (50 MiB of L2) path D's 100,000 x 4 x 64 float32
    tables take one head a slice, bf16 two, and H*F = 40 all four."""
    l2 = 50 * 2 ** 20
    assert tdot.dot_slice_heads(100_000, 4, 64, 4, l2) == 1
    assert tdot.dot_slice_heads(100_000, 4, 64, 2, l2) == 2
    assert tdot.dot_slice_heads(100_000, 4, 10, 4, l2) == 4
    assert tdot.dot_slice_heads(10_000_000, 4, 64, 4, l2) == 1
    assert tdot.dot_slice_heads(1000, 3, 8, 4, l2) == 3
    assert tdot.dot_slice_heads(200_000, 6, 16, 4, l2) == 2
    a = torch.zeros(5, 4, 8)
    i = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match='does not tile'):
        tdot.edge_dot(a, a, i, i, slice_heads=3)


def test_edge_dot_bf16_matches_jax():
    """The bf16 arm's plain version: bf16 products, a float32 sum, one
    rounding, against the JAX package's ``sddmm`` on bf16 inputs."""
    rng = np.random.default_rng(5)
    n, h, f = 60, 4, 16
    coo = _coo(n=n, e=400, pad=12, seed=6)
    jei, tei = _pair(coo, n, n, cached=False)
    a = rng.standard_normal((n, h, f)).astype(np.float32)
    b = rng.standard_normal((n, h, f)).astype(np.float32)
    ref = jsddmm.sddmm(jei, jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16))
    out = tdot.edge_dot(_t(a).bfloat16(), _t(b).bfloat16(),
                          tei.coo[0], tei.coo[1])
    assert out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(ref, np.float32), tol=BF16_TOL,
           what='bf16 scores')
    with pytest.raises(TypeError, match='float32'):
        tdot.edge_dot(_t(a).half(), _t(b).half(), tei.coo[0], tei.coo[1])
    with pytest.raises(TypeError, match='float32'):
        tdot.edge_dot(_t(a), _t(b).bfloat16(), tei.coo[0], tei.coo[1])


# -- the fused softmax --------------------------------------------------------
@pytest.mark.parametrize('masked', [False, True])
def test_edge_softmax_matches_jax(masked):
    """Against the JAX package's ``edge_softmax`` and its plain segment
    softmax; padded edges get exactly 0; the logits' gradient too."""
    rng = np.random.default_rng(7)
    n, h = 60, 4
    coo = _coo(n=n, e=400, pad=32, seed=0)
    jei, tei = _pair(coo, n, n)
    assert tsddmm.fused_softmax_available(tei)
    assert not tsddmm.fused_softmax_available(EdgeIndex(coo, (n, n),
                                                        device='cpu'))
    e = coo.shape[1]
    logits = (rng.standard_normal((e, h)) * 3).astype(np.float32)
    mask = rng.random(e) > 0.3 if masked else None
    c = rng.standard_normal((e, h)).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)

    def jf(lg):
        return jsddmm.edge_softmax(jei, lg, edge_mask=jm)

    ref = jf(jnp.asarray(logits))
    valid = (coo[1] < n) & (True if mask is None else mask)
    plain = jsoftmax(jnp.asarray(logits), jnp.asarray(np.minimum(coo[1],
                                                                 n - 1)),
                     n, mask=jnp.asarray(valid))
    jg = jax.grad(lambda lg: (jf(lg) * jnp.asarray(c)).sum())(
        jnp.asarray(logits))
    lt = _t(logits, True)
    out = tsddmm.edge_softmax(tei, lt, None if mask is None else _t(mask))
    _close(out, ref, what='edge_softmax vs JAX')
    _close(out, plain, what='edge_softmax vs the plain softmax')
    assert (out[~valid] == 0).all()
    (out * _t(c)).sum().backward()
    _close(lt.grad, jg, what='edge_softmax gradient')


def test_softmax_dispatches_to_fused(monkeypatch):
    """``ops.softmax(edge_index=...)`` routes through ``edge_softmax``
    under the JAX package's condition, and matches the plain route; 1-D
    logits take the plain route. With the kernel knob off a CPU tensor
    takes the plain route and a CUDA one raises (the shared rule,
    ``fused_ok``; its card test is in ``tests/test_torch_cuda.py``)."""
    rng = np.random.default_rng(8)
    n, h = 50, 3
    coo = _coo(n=n, e=300, pad=12, seed=9)
    jei, tei = _pair(coo, n, n)
    e = coo.shape[1]
    logits = rng.standard_normal((e, h)).astype(np.float32)
    index = np.minimum(coo[1], n - 1)
    valid = coo[1] < n
    ref = jsoftmax(jnp.asarray(logits), jnp.asarray(index), n,
                   mask=jnp.asarray(valid), edge_index=jei)
    calls = []
    real = tsoftmax_mod.edge_softmax

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tsoftmax_mod, 'edge_softmax', spy)
    out = tsoftmax(_t(logits), _t(index), n, mask=_t(valid), edge_index=tei)
    assert len(calls) == 1
    _close(out, ref, what='softmax(edge_index=)')
    plain = tsoftmax(_t(logits), _t(index), n, mask=_t(valid))
    _close(out, plain, what='fused vs plain route')
    monkeypatch.setattr(backend, 'use_kernel_spmm', False)
    off = tsoftmax(_t(logits), _t(index), n, mask=_t(valid), edge_index=tei)
    assert len(calls) == 1
    assert torch.equal(off, plain)
    with pytest.raises(RuntimeError, match='use_kernel_spmm'):
        fused_ok(tei, SimpleNamespace(device=torch.device('cuda')))
    monkeypatch.setattr(backend, 'use_kernel_spmm', True)
    tsoftmax(_t(logits[:, 0]), _t(index), n, mask=_t(valid), edge_index=tei)
    assert len(calls) == 1


@pytest.mark.parametrize('case', ['plain', 'mask', 'numerator_scale'])
def test_edge_softmax_aggregate_matches_jax(case):
    """Output and the gradients of the logits and the per-edge values."""
    rng = np.random.default_rng(10)
    n, h, f = 60, 4, 16
    coo = _coo(n=n, e=400, pad=32, seed=len(case))
    jei, tei = _pair(coo, n, n)
    e = coo.shape[1]
    logits = (rng.standard_normal((e, h)) * 2).astype(np.float32)
    values = rng.standard_normal((e, h, f)).astype(np.float32)
    c = rng.standard_normal((n, h, f)).astype(np.float32)
    kw = {}
    if case == 'mask':
        kw['edge_mask'] = rng.random(e) < 0.7
    if case == 'numerator_scale':
        kw['numerator_scale'] = ((rng.random((e, h)) < 0.5)
                                 .astype(np.float32) * 2.0)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}

    def jloss(lg, vv):
        out = jsddmm.edge_softmax_aggregate(jei, lg, vv, **jkw)
        return (out * jnp.asarray(c)).sum(), out

    (_, jout), (jgl, jgv) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(logits),
                                            jnp.asarray(values))
    lt, vt = _t(logits, True), _t(values, True)
    out = tsddmm.edge_softmax_aggregate(tei, lt, vt, **{
        k: _t(v) for k, v in kw.items()})
    _close(out, jout, what='aggregate')
    (out * _t(c)).sum().backward()
    _close(lt.grad, jgl, what='grad logits')
    _close(vt.grad, jgv, what='grad values')


def test_multi_relation_union_softmax_matches_jax():
    """The union softmax over two relations (one masked), its output and
    the gradients of every logit and value array."""
    rng = np.random.default_rng(11)
    n, h, f = 50, 2, 8
    rels, jrels, trels = [], [], []
    for k, (e, pad) in enumerate(((200, 8), (150, 8))):
        coo = _coo(n=n, e=e, pad=pad, seed=20 + k)
        jei, tei = _pair(coo, n, n)
        m = None if k == 0 else rng.random(coo.shape[1]) < 0.75
        lg = rng.standard_normal((coo.shape[1], h)).astype(np.float32)
        vv = rng.standard_normal((coo.shape[1], h, f)).astype(np.float32)
        rels.append((lg, vv))
        jrels.append((jei, None if m is None else jnp.asarray(m)))
        trels.append((tei, None if m is None else _t(m)))
    c = rng.standard_normal((n, h, f)).astype(np.float32)

    def jloss(l1, v1, l2, v2):
        out = jsddmm.multi_relation_softmax_aggregate(
            [(jrels[0][0], l1, v1, jrels[0][1]),
             (jrels[1][0], l2, v2, jrels[1][1])], n)
        return (out * jnp.asarray(c)).sum(), out

    args = [jnp.asarray(x) for pair in rels for x in pair]
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(*args)
    targs = [_t(x, True) for pair in rels for x in pair]
    out = tsddmm.multi_relation_softmax_aggregate(
        [(trels[0][0], targs[0], targs[1], trels[0][1]),
         (trels[1][0], targs[2], targs[3], trels[1][1])], n)
    _close(out, jout, what='union softmax')
    (out * _t(c)).sum().backward()
    for got, ref, name in zip(targs, jgrads, ('l1', 'v1', 'l2', 'v2')):
        assert np.isfinite(got.grad.numpy()).all()
        _close(got.grad, ref, what=f'grad {name}')


def test_isolated_node_rows_are_zero():
    """Destinations with no incoming edges give zeros, not NaN."""
    rng = np.random.default_rng(12)
    n, h, f = 64, 2, 4
    coo = np.stack([np.arange(32), np.zeros(32)]).astype(np.int32)
    jei, tei = _pair(coo, n, n)
    logits = rng.standard_normal((32, h)).astype(np.float32)
    values = rng.standard_normal((32, h, f)).astype(np.float32)
    out = tsddmm.edge_softmax_aggregate(tei, _t(logits), _t(values))
    ref = jsddmm.edge_softmax_aggregate(jei, jnp.asarray(logits),
                                        jnp.asarray(values))
    assert np.isfinite(out.numpy()).all()
    assert (out[1:] == 0).all()
    _close(out, ref, what='isolated rows')


# -- the wide union attention -------------------------------------------------
def _attention_case(rng, n_dst, rels, h, d, pad):
    """Per relation: k, v tables, an in-range source list and destinations
    (``pad`` of them at ``n_dst``, dropped)."""
    out = []
    for n_r, e in rels:
        k = rng.standard_normal((n_r, h, d)).astype(np.float32)
        v = rng.standard_normal((n_r, h, d)).astype(np.float32)
        s = rng.integers(0, n_r, e + pad).astype(np.int32)
        dd = np.concatenate([rng.integers(0, n_dst, e),
                             np.full(pad, n_dst)]).astype(np.int32)
        out.append((k, v, s, dd))
    return out


@pytest.mark.parametrize('relations,sort', [(1, False), (2, False),
                                            (2, True)])
def test_hetero_edge_attention_multi_wide_matches_jax(relations, sort,
                                                      monkeypatch):
    """The wide op: output and the gradients of k, v and q (and of the
    priors), one relation and two; ``sort`` lowers
    ``PGT_ATTN_SORT_MIN_EDGES`` so the union is sorted by destination."""
    if sort:
        monkeypatch.setenv('PGT_ATTN_SORT_MIN_EDGES', '16')
    rng = np.random.default_rng(13 + relations)
    n_dst, h, d = 70, 4, 8
    parts = _attention_case(rng, n_dst, [(60, 500), (45, 300)][:relations],
                            h, d, pad=7)
    q = rng.standard_normal((n_dst, h, d)).astype(np.float32)
    p = [((rng.random(h) + 0.5) / np.sqrt(d)).astype(np.float32)
         for _ in parts]
    c = rng.standard_normal((n_dst, h, d)).astype(np.float32)

    def jloss(ks, vs, qq, ps):
        out = jattn.hetero_edge_attention_multi(
            ks, vs, qq, ps, [jnp.asarray(x[2]) for x in parts],
            [jnp.asarray(x[3]) for x in parts], n_dst)
        return (out * jnp.asarray(c)).sum(), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        [jnp.asarray(x[0]) for x in parts], [jnp.asarray(x[1]) for x in parts],
        jnp.asarray(q), [jnp.asarray(x) for x in p])
    ks = [_t(x[0], True) for x in parts]
    vs = [_t(x[1], True) for x in parts]
    qt = _t(q, True)
    ps = [_t(x, True) for x in p]
    out = tattn.hetero_edge_attention_multi(
        ks, vs, qt, ps, [_t(x[2]) for x in parts], [_t(x[3]) for x in parts],
        n_dst)
    _close(out, jout, what='wide attention')
    (out * _t(c)).sum().backward()
    for i in range(relations):
        _close(ks[i].grad, jg[0][i], what=f'grad k[{i}]')
        _close(vs[i].grad, jg[1][i], what=f'grad v[{i}]')
        _close(ps[i].grad, jg[3][i], what=f'grad p[{i}]')
    _close(qt.grad, jg[2], what='grad q')


def test_hetero_edge_attention_flat_table_matches_jax():
    """``hetero_edge_attention`` over one flat ``[M, 2 H D]`` k|v table
    (read as two column halves): output and the table's gradient."""
    rng = np.random.default_rng(17)
    n_dst, m, h, d, e = 50, 40, 2, 8, 400
    kv = rng.standard_normal((m, 2 * h * d)).astype(np.float32)
    q = rng.standard_normal((n_dst, h, d)).astype(np.float32)
    p = (rng.random((1, h)) / np.sqrt(d)).astype(np.float32)
    src = rng.integers(0, m, e).astype(np.int32)
    dst = np.concatenate([rng.integers(0, n_dst, e - 5),
                          np.full(5, n_dst)]).astype(np.int32)
    rel = np.zeros(e, np.int32)
    c = rng.standard_normal((n_dst, h, d)).astype(np.float32)

    def jloss(kvt):
        out = jattn.hetero_edge_attention(
            kvt, jnp.asarray(q), jnp.asarray(p), jnp.asarray(rel),
            jnp.asarray(src), jnp.asarray(dst), n_dst)
        return (out * jnp.asarray(c)).sum(), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(kv))
    kvt = _t(kv, True)
    out = tattn.hetero_edge_attention(kvt, _t(q), _t(p), _t(rel).long(),
                                      _t(src).long(), _t(dst).long(), n_dst)
    _close(out, jout, what='flat table')
    (out * _t(c)).sum().backward()
    _close(kvt.grad, jg, what='grad kv')


def test_attention_raises_past_the_cap_and_with_a_layout(monkeypatch):
    """Past ``PGT_ATTN_WIDE_BYTES`` and with a ``layout`` the JAX package
    takes its flash scan, which is not ported: the port raises, naming the
    roadmap item. At the cap itself it takes the wide op."""
    rng = np.random.default_rng(18)
    (k, v, s, dd), = _attention_case(rng, 30, [(20, 100)], 2, 4, pad=0)
    args = ([_t(k)], [_t(v)], _t(rng.standard_normal((30, 2, 4)).astype(
        np.float32)), [torch.ones(2)], [_t(s)], [_t(dd)], 30)
    assert tattn.hetero_edge_attention_multi(*args).shape == (30, 2, 4)
    with pytest.raises(NotImplementedError, match='Queue 1, item 7'):
        tattn.hetero_edge_attention_multi(*args, layout=object())
    monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', str(100 * 2 * 2 * 4 * 4))
    assert tattn.hetero_edge_attention_multi(*args).shape == (30, 2, 4)
    monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', str(100 * 2 * 2 * 4 * 4 - 1))
    with pytest.raises(NotImplementedError, match='Queue 1, item 7'):
        tattn.hetero_edge_attention_multi(*args)
