"""The online-softmax flash scans of the PyTorch port (``ops/flash_softmax.py``
and the flash routes of ``ops/edge_attention.py``) against the JAX
package's, on the same numpy inputs: ``gat_flash_attention``,
``gatv2_flash_attention`` and ``hetero_edge_attention_multi`` forced to the
flash scan (``PGT_ATTN_WIDE_BYTES=0``; one and three relations, with and
without a ``FlashLayout``), outputs and the gradients of every
differentiable input; sorted and unsorted unions (``PGT_ATTN_SORT_MIN_EDGES``
low and high), a chunk smaller than the edge list, empty rows, padded edges,
H in {1, 4}. Then the convs' flash branches (GATConv, GATv2Conv,
TransformerConv) from the same flax weights, the branch choice under
``PGT_ATTN_WIDE_BYTES``, a check that no flash branch builds an ``[E, .]``
float tensor, and ``chip_smoke.py``'s path K (the products bench's 2-layer
GAT) on a tiny products graph for 5 Adam steps against optax.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
Here their launch plan is checked (``piece_row`` included), and numpy
emulations of their order of work are held against the plain versions:
kernel (a)'s (one team per (row, head) walking its piece of a row with the
online update, pieces merged in piece order), the backward passes per
(row, head), and the backward passes as kernels (b) and (c) run them (one
warp per row and head group, sub-teams on alternate batches, the packed
record).

Tolerances: forward within 1e-5 * max(1, max|ref|); gradients within 1e-4
of the reference's largest magnitude (float32 sums in another order); the
5-step losses within 1e-4 relative."""

import importlib
import importlib.util
import math
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from pytorch_geometric_tpu.nn.conv import GATConv as JGATConv
from pytorch_geometric_tpu.nn.conv import GATv2Conv as JGATv2Conv
from pytorch_geometric_tpu.nn.conv import TransformerConv as JTransformerConv
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn.conv import (GATConv, GATv2Conv,
                                                 TransformerConv)
from pytorch_geometric_tpu_torch.nn.conv import gat_conv as tgat_conv
from pytorch_geometric_tpu_torch.ops import flash_softmax as fs

jattn = importlib.import_module('pytorch_geometric_tpu.ops.edge_attention')
tattn = importlib.import_module('pytorch_geometric_tpu_torch.ops.edge_attention')

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
ROOT = Path(__file__).resolve().parent.parent


def _fwd_close(got, ref, what=''):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_TOL * max(
        1.0, float(np.abs(ref).max(initial=0.0))), err_msg=what)


def _grad_close(got, ref, what=''):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=GRAD_TOL * max(
        float(np.abs(ref).max(initial=0.0)), 1e-30), err_msg=what)


def _edges(rng, n_src, n_dst, e, n_pad):
    """Random edges onto two thirds of the destinations (the rest empty),
    one destination taking a fifth of them, and ``n_pad`` padded edges
    (destination ``n_dst``)."""
    rows = rng.choice(n_dst, max(1, 2 * n_dst // 3), replace=False)
    dst = rows[rng.integers(0, len(rows), e)]
    dst[: e // 5] = rows[0]
    src = rng.integers(0, n_src, e)
    src = np.concatenate([src, rng.integers(0, n_src, n_pad)])
    dst = np.concatenate([dst, np.full(n_pad, n_dst)])
    perm = rng.permutation(len(src))
    return src[perm].astype(np.int64), dst[perm].astype(np.int64)


CASES = [(h, sort, chunk) for h in (1, 4) for sort in ('sorted', 'unsorted')
         for chunk in (97, 'whole')]


def _env(monkeypatch, sort, chunk):
    monkeypatch.setenv('PGT_ATTN_SORT_MIN_EDGES',
                       '1' if sort == 'sorted' else '1e9')
    if chunk != 'whole':
        monkeypatch.setenv('PGT_ATTN_CHUNK_EDGES', str(chunk))


def _jgrad(fn, args, cot):
    def loss(*a):
        return (fn(*a) * jnp.asarray(cot)).sum()
    out = fn(*[jnp.asarray(a) for a in args])
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    return out, grads


def _tgrad(fn, args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    (out * torch.from_numpy(cot)).sum().backward()
    return out, [t.grad for t in ts]


# -- the three scans against the JAX package ---------------------------------
@pytest.mark.parametrize('h,sort,chunk', CASES)
def test_gat_flash_matches_jax(monkeypatch, h, sort, chunk):
    _env(monkeypatch, sort, chunk)
    rng = np.random.default_rng(h)
    ns, nd, c = 37, 29, 5
    src, dst = _edges(rng, ns, nd, 400, 13)
    args = [rng.standard_normal(s).astype(np.float32)
            for s in ((ns, h), (nd, h), (ns, h, c))]
    cot = rng.standard_normal((nd, h, c)).astype(np.float32)
    jout, jg = _jgrad(lambda a, b, v: jattn.gat_flash_attention(
        a, b, v, jnp.asarray(src), jnp.asarray(dst), nd), args, cot)
    tout, tg = _tgrad(lambda a, b, v: tattn.gat_flash_attention(
        a, b, v, torch.from_numpy(src), torch.from_numpy(dst), nd), args,
        cot)
    _fwd_close(tout, jout, 'gat out')
    for name, t, j in zip(('a_src', 'a_dst', 'v'), tg, jg):
        _grad_close(t, j, f'gat grad {name}')


@pytest.mark.parametrize('h,sort,chunk', CASES)
def test_gatv2_flash_matches_jax(monkeypatch, h, sort, chunk):
    _env(monkeypatch, sort, chunk)
    rng = np.random.default_rng(10 + h)
    ns, nd, c = 31, 23, 6
    src, dst = _edges(rng, ns, nd, 350, 9)
    args = [rng.standard_normal(s).astype(np.float32)
            for s in ((ns, h, c), (nd, h, c), (h, c))]
    cot = rng.standard_normal((nd, h, c)).astype(np.float32)
    jout, jg = _jgrad(lambda xl, xr, att: jattn.gatv2_flash_attention(
        xl, xr, att, jnp.asarray(src), jnp.asarray(dst), nd), args, cot)
    tout, tg = _tgrad(lambda xl, xr, att: tattn.gatv2_flash_attention(
        xl, xr, att, torch.from_numpy(src), torch.from_numpy(dst), nd),
        args, cot)
    _fwd_close(tout, jout, 'gatv2 out')
    for name, t, j in zip(('x_l', 'x_r', 'att'), tg, jg):
        _grad_close(t, j, f'gatv2 grad {name}')


UNION_CASES = [(r, layout, h, sort)
               for r in (1, 3) for layout in (False, True)
               for h, sort in ((1, 'sorted'), (4, 'unsorted'))]


@pytest.mark.parametrize('n_rel,layout,h,sort', UNION_CASES)
def test_union_flash_matches_jax(monkeypatch, n_rel, layout, h, sort):
    """``hetero_edge_attention_multi`` past the cap (``PGT_ATTN_WIDE_BYTES
    = 0``), or over a ``FlashLayout`` (with its source-sorted copy), against
    the JAX package's on the same relations: outputs and the gradients of
    every k, v, q and prior."""
    _env(monkeypatch, sort, 61)
    monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', '0')
    rng = np.random.default_rng(20 + n_rel + h)
    nd, d = 27, 4
    sizes = [19, 33, 11][:n_rel]
    edges = [_edges(rng, n, nd, 150, 5) for n in sizes]
    k = [rng.standard_normal((n, h, d)).astype(np.float32) for n in sizes]
    v = [rng.standard_normal((n, h, d)).astype(np.float32) for n in sizes]
    q = rng.standard_normal((nd, h, d)).astype(np.float32)
    p = [rng.uniform(0.2, 1.0, h).astype(np.float32) for _ in sizes]
    cot = rng.standard_normal((nd, h, d)).astype(np.float32)
    s_list = [s for s, _ in edges]
    d_list = [dd for _, dd in edges]
    jlay = tlay = None
    if layout:
        jlay = jattn.build_union_flash_layout(s_list, d_list, sizes, nd)
        tlay = tattn.build_union_flash_layout(s_list, d_list, sizes, nd,
                                              device='cpu')
        assert tlay.s_t is not None
        for name in ('s_ch', 'd_ch', 'rel_ch', 's_t', 'd_t', 'rel_t'):
            np.testing.assert_array_equal(getattr(tlay, name).numpy(),
                                          np.asarray(getattr(jlay, name)))

    def jfn(*a):
        ks, vs, qq, ps = a[:n_rel], a[n_rel:2 * n_rel], a[2 * n_rel], \
            a[2 * n_rel + 1:]
        return jattn.hetero_edge_attention_multi(
            list(ks), list(vs), qq, list(ps),
            [jnp.asarray(s) for s in s_list],
            [jnp.asarray(dd) for dd in d_list], nd, layout=jlay)

    def tfn(*a):
        ks, vs, qq, ps = a[:n_rel], a[n_rel:2 * n_rel], a[2 * n_rel], \
            a[2 * n_rel + 1:]
        return tattn.hetero_edge_attention_multi(
            list(ks), list(vs), qq, list(ps),
            [torch.from_numpy(s) for s in s_list],
            [torch.from_numpy(dd) for dd in d_list], nd, layout=tlay)

    args = k + v + [q] + p
    jout, jg = _jgrad(jfn, args, cot)
    tout, tg = _tgrad(tfn, args, cot)
    _fwd_close(tout, jout, 'union out')
    for i, (t, j) in enumerate(zip(tg, jg)):
        _grad_close(t, j, f'union grad of input {i}')


PAD_CASES = [(form, c) for form in fs.FORMS for c in (5, 7)]


@pytest.mark.parametrize('form,c', PAD_CASES)
def test_aligned_heads_route_matches_jax(monkeypatch, form, c):
    """The flash route's aligned heads, forced on the CPU
    (``ALIGN_HEADS_ON``): heads of C = 5 and 7 columns reach the scans
    padded to 8 with zero columns (the values, GATv2's x_r and att, the dot
    form's q and k, and the output gradient), and the output and every
    input's gradient, sliced back to C, match the JAX package's flash scans
    (``_gat_flash``, ``_gatv2_flash``, ``_attention_flash``) on the
    unpadded inputs: forward within 1e-5 of max(1, max|ref|), gradients
    1e-4 of each one's largest."""
    monkeypatch.setattr(tattn, 'ALIGN_HEADS_ON', ('cuda', 'cpu'))
    monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', '0')
    _env(monkeypatch, 'unsorted', 53)
    seen = []
    fwd, bwd = fs.flash_forward, fs.flash_backward

    def spy_fwd(ops, *a, **k):
        seen.append(('fwd', ops.columns, ops.val.shape[1]))
        return fwd(ops, *a, **k)

    def spy_bwd(ops, s, d, rel, nd, chunk, m, l, out, g, *a, **k):
        seen.append(('bwd', ops.columns, g.shape[1]))
        return bwd(ops, s, d, rel, nd, chunk, m, l, out, g, *a, **k)

    monkeypatch.setattr(fs, 'flash_forward', spy_fwd)
    monkeypatch.setattr(fs, 'flash_backward', spy_bwd)
    rng = np.random.default_rng(40 + c + FORMS_SEED[form])
    h, ns, nd = 2, 29, 21
    src, dst = _edges(rng, ns, nd, 300, 7)
    cot = rng.standard_normal((nd, h, c)).astype(np.float32)
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    if form == 'gat':
        args = [rng.standard_normal(sh).astype(np.float32)
                for sh in ((ns, h), (nd, h), (ns, h, c))]
        jout, jg = _jgrad(lambda a, b, v: jattn.gat_flash_attention(
            a, b, v, js, jd, nd), args, cot)
        tout, tg = _tgrad(lambda a, b, v: tattn.gat_flash_attention(
            a, b, v, ts, td, nd), args, cot)
    elif form == 'gatv2':
        args = [rng.standard_normal(sh).astype(np.float32)
                for sh in ((ns, h, c), (nd, h, c), (h, c))]
        jout, jg = _jgrad(lambda xl, xr, att: jattn.gatv2_flash_attention(
            xl, xr, att, js, jd, nd), args, cot)
        tout, tg = _tgrad(lambda xl, xr, att: tattn.gatv2_flash_attention(
            xl, xr, att, ts, td, nd), args, cot)
    else:
        args = [rng.standard_normal(sh).astype(np.float32)
                for sh in ((ns, h, c), (ns, h, c), (nd, h, c))] + [
            rng.uniform(0.2, 1.0, h).astype(np.float32)]
        jout, jg = _jgrad(lambda k, v, q, p: jattn.hetero_edge_attention_multi(
            [k], [v], q, [p], [js], [jd], nd), args, cot)
        tout, tg = _tgrad(lambda k, v, q, p: tattn.hetero_edge_attention_multi(
            [k], [v], q, [p], [ts], [td], nd), args, cot)
    assert seen == [('fwd', 8, h * 8), ('bwd', 8, h * 8)]
    assert tuple(tout.shape) == (nd, h, c)
    _fwd_close(tout, jout, f'{form} out')
    for i, (t, j) in enumerate(zip(tg, jg)):
        _grad_close(t, j, f'{form} grad of input {i}')


def test_stale_layout_raises():
    rng = np.random.default_rng(3)
    s, d = _edges(rng, 10, 8, 30, 0)
    lay = tattn.build_union_flash_layout([s], [d], [10], 8, device='cpu')
    t = torch.ones(10, 2, 3)
    with pytest.raises(ValueError, match='stale'):
        tattn.hetero_edge_attention_multi(
            [t], [t], torch.ones(8, 2, 3), [torch.ones(2)],
            [torch.from_numpy(s[:-1])], [torch.from_numpy(d[:-1])], 8,
            layout=lay)


# -- the launch plan and an emulation of the kernels' order of work ----------
def test_csr_plan_pieces_and_slots():
    """Rows cut into pieces of ``split`` edges (an empty row one piece), the
    scratch slots of multi-piece rows, and the bounds taken from shapes."""
    keys = torch.tensor([0, 0, 0, 0, 0, 0, 0, 2, 3, 3, 3, 5, 5])
    plan = fs.csr_plan(keys, torch.arange(13), None, 4, split=3)
    assert plan.rowptr.tolist() == [0, 7, 7, 8, 11]
    assert plan.piece_ptr.tolist() == [0, 3, 4, 5, 6]
    assert plan.split_base.tolist() == [0, 3, 3, 3]
    assert plan.max_pieces == 4 + 5 and plan.n_slots == 2 * 13 // 3 + 1
    assert plan.nbr.dtype == torch.int32 and plan.rel is None
    # each piece's row: the split row 0 three times, the empty row 1 once;
    # past the last piece, clamped to the last row
    assert plan.piece_row.dtype == torch.int32
    assert plan.piece_row.tolist() == [0, 0, 0, 1, 2, 3, 3, 3, 3]
    # the source-major plan drops invalid edges and groups by source
    s = torch.tensor([2, 0, 2, 1, 0])
    d = torch.tensor([1, 0, 3, 1, 0])
    t = fs.src_plan(s, d, None, 3, 3, split=1)
    assert t.rowptr.tolist() == [0, 2, 3, 4]
    assert t.nbr.tolist() == [0, 0, 1, 1, 3]   # the invalid edge last
    assert t.piece_row.tolist() == [0, 0, 1, 2, 2, 2, 2, 2]
    # every kernel's team shape: path K's layer 1 (16 columns) and its
    # layer 2 padded to 48 on the 16-byte arm, its unpadded 47 on floats
    TS = fs.TeamShape
    assert fs.team_shape(4, 16, 4, 'fwd') == TS(4, 16, 4, 4, 1, 4, 1)
    assert fs.team_shape(1, 48, 4, 'fwd') == TS(4, 16, 1, 16, 1, 4, 1)
    assert fs.team_shape(1, 47, 1, 'fwd') == TS(1, 32, 1, 64, 2, 8, 1)
    assert fs.team_shape(4, 64, 4, 'fwd') == TS(4, 32, 4, 16, 2, 2, 2)
    assert fs.team_shape(4, 64, 4, 'dst') == TS(4, 32, 4, 16, 2, 1, 2)
    assert fs.team_shape(4, 64, 4, 'src') == TS(4, 32, 4, 16, 2, 1, 1)
    with pytest.raises(ValueError):
        fs.team_shape(1, 47, 4, 'fwd')


def _np_tables(ops):
    def a(t):
        return None if t is None else t.detach().numpy().astype(np.float32)
    return a(ops.src_tab), a(ops.dst_tab), a(ops.val), a(ops.extra)


def _np_logit(form, src_tab, dst_tab, extra, s, d, r, hh, c, slope):
    """(logit, base, columns of the joint's base) of one edge and head."""
    cols = slice(hh * c, (hh + 1) * c)
    if form == 'gat':
        base = np.float32(src_tab[s, hh] + dst_tab[d, hh])
        return (base if base >= 0 else np.float32(slope) * base), base, None
    if form == 'gatv2':
        b = src_tab[s, cols] + dst_tab[d, cols]
        joint = np.where(b >= 0, b, np.float32(slope) * b)
        return np.float32((extra[cols] * joint).sum()), None, b
    base = np.float32((dst_tab[d, cols] * src_tab[s, cols]).sum())
    return base * extra[r, hh], base, None


def _warps(plan, groups, split):
    """The kernels' warps over ``plan``: one per (piece, head group), the
    piece's row found through ``piece_row``; ``(item, row, k, pieces of
    the row, head group, e0, e1)``."""
    pp, pr = plan.piece_ptr.numpy(), plan.piece_row.numpy()
    rp = plan.rowptr.numpy()
    for item in range(plan.max_pieces * groups):
        p, hg = divmod(item, groups)
        if p >= pp[-1]:
            continue
        row = int(pr[p])
        k, n_p = p - pp[row], pp[row + 1] - pp[row]
        e0 = rp[row] + k * split
        yield item, row, k, n_p, hg, e0, min(e0 + split, rp[row + 1])


def _lse_merge(x, y):
    """Two online-softmax states ``(m, l, acc)`` of one head merged with
    log-sum-exp weights (a state without edges has m = -inf, weight 0)."""
    mm = max(x[0], y[0])
    wx = np.float32(0) if x[0] == -np.inf else np.float32(np.exp(x[0] - mm))
    wy = np.float32(0) if y[0] == -np.inf else np.float32(np.exp(y[0] - mm))
    return mm, x[1] * wx + y[1] * wy, x[2] * wx + y[2] * wy


def _emulate_forward(ops, s, d, rel, num_dst, split, shape):
    """Kernel (a) as redesigned, in numpy float32: one warp per (piece, head
    group) through ``piece_row``, laid out as ``shape`` (``_slots``, whose
    slots of each head must tile its columns); each sub-team takes
    alternate batches of ``unroll`` edges, per batch the logits (the plain
    version's ``_logit_plain``), their max per head, one rescale of (l,
    acc) where it grew, then one exp per edge; the sub-teams' states merged
    by a fixed butterfly of log-sum-exp rescales; a split row's pieces
    merged in piece order. Every output column, m and l written exactly
    once. Returns ``(out, m, l)``."""
    h, c = ops.heads, ops.columns
    val = _np_tables(ops)[2]
    plan = fs.dst_plan(s, d, rel, num_dst, False, split)
    nbr = plan.nbr.numpy()
    # each edge's logits as the plain version sums them, so that m, a max
    # of the same values, matches it bit for bit
    n_e = int(plan.rowptr[-1])
    rows = torch.repeat_interleave(torch.arange(num_dst),
                                   plan.rowptr.diff())
    logits = fs._logit_plain(ops, plan.nbr[:n_e].long(), rows,
                             None if plan.rel is None
                             else plan.rel[:n_e].long(),
                             num_dst)[0].numpy()
    groups = -(-h // shape.heads)
    teams, u = 32 // shape.lanes, shape.unroll
    out = np.full((num_dst, h * c), np.nan, np.float32)
    m = np.full((num_dst, h), np.nan, np.float32)
    l = np.full((num_dst, h), np.nan, np.float32)
    parts = {}
    for item, row, k, n_p, hg, e0, e1 in _warps(plan, groups, split):
        slots = [sl for sl in _slots(shape, h, c, hg).values() if sl]
        heads = sorted({sl[0] for sl in slots})
        for hd in heads:
            firsts = sorted(sl[1] - hd * c for sl in slots if sl[0] == hd)
            assert firsts == list(range(0, c, shape.vec)), (hd, firsts)
        states = []
        for st in range(teams):
            state = {hd: (np.float32(-np.inf), np.float32(0),
                          np.zeros(c, np.float32)) for hd in heads}
            for b in range(e0 + st * u, e1, teams * u):
                edges = range(b, min(b + u, e1))
                lg = {(e, hd): logits[e, hd] for e in edges for hd in heads}
                for hd in heads:
                    mm, ll, acc = state[hd]
                    bm = max(lg[e, hd] for e in edges)
                    if bm > mm:
                        sc = np.float32(np.exp(mm - bm))
                        mm, ll, acc = bm, ll * sc, acc * sc
                    for e in edges:
                        z = np.float32(np.exp(lg[e, hd] - mm))
                        ll = ll + z
                        acc = acc + z * val[nbr[e], hd * c:(hd + 1) * c]
                    state[hd] = (mm, ll, acc)
            states.append(state)
        span = 1
        while span < teams:             # the sub-teams' fixed butterfly
            states = [{hd: _lse_merge(states[t][hd], states[t ^ span][hd])
                       for hd in heads} for t in range(teams)]
            span *= 2
        parts[row, hg, k] = states[0]
        if k < n_p - 1:
            continue
        for hd in heads:                # piece order
            pieces = [parts[row, hg, q][hd] for q in range(n_p)]
            mm = max(pc[0] for pc in pieces)
            ll, acc = np.float32(0), np.zeros(c, np.float32)
            for pm, pl, pa in pieces:
                w = (np.float32(0) if pm == -np.inf
                     else np.float32(np.exp(pm - mm)))
                ll, acc = ll + pl * w, acc + pa * w
            cols = slice(hd * c, (hd + 1) * c)
            assert np.isnan(out[row, cols]).all() and np.isnan(m[row, hd])
            m[row, hd], l[row, hd] = mm, ll
            out[row, cols] = acc / max(ll, np.float32(1e-16))
    assert not (np.isnan(out).any() or np.isnan(m).any()
                or np.isnan(l).any())
    return out, m, l


def _emulate(ops, s, d, rel, num_dst, split, vec=1):
    """The kernels' order of work in numpy, float32: kernel (a) as
    ``_emulate_forward`` lays it out (its shape for ``vec``); kernel (b) per
    destination piece (gdot, the destination gradients, the global
    reductions); kernel (c) per source piece. Returns the forward's (out,
    m, l) and a function of g giving the gradients."""
    form, h, c, slope = ops.form, ops.heads, ops.columns, ops.slope
    src_tab, dst_tab, val, extra = _np_tables(ops)
    plan = fs.dst_plan(s, d, rel, num_dst, False, split)
    rp, pp = plan.rowptr.numpy(), plan.piece_ptr.numpy()
    nbr = plan.nbr.numpy()
    rl = None if plan.rel is None else plan.rel.numpy()
    out, m, l = _emulate_forward(ops, s, d, rel, num_dst, split,
                                 fs.team_shape(h, c, vec, 'fwd'))

    def pieces(row, rowptr, piece_ptr):
        for k in range(piece_ptr[row + 1] - piece_ptr[row]):
            e0 = rowptr[row] + k * split
            yield range(e0, min(e0 + split, rowptr[row + 1]))

    def backward(g):
        g = g.reshape(num_dst, h * c).astype(np.float32)
        n_src = src_tab.shape[0]
        gdot = (g * out).reshape(num_dst, h, c).sum(-1)
        d_dst = np.zeros((num_dst, dst_tab.shape[1]), np.float32)
        d_src = np.zeros((n_src, src_tab.shape[1]), np.float32)
        d_val = np.zeros((n_src, h * c), np.float32)
        d_extra = None if extra is None else np.zeros_like(extra)

        def edge_terms(sv, dv, r, hh):
            cols = slice(hh * c, (hh + 1) * c)
            logit, base, b = _np_logit(form, src_tab, dst_tab, extra, sv,
                                       dv, r, hh, c, slope)
            ms = m[dv, hh] if np.isfinite(m[dv, hh]) else 0.0
            alpha = np.float32(np.exp(logit - ms) / max(l[dv, hh], 1e-16))
            dl = alpha * ((g[dv, cols] * val[sv, cols]).sum() - gdot[dv, hh])
            return cols, alpha, dl, base, b

        # kernel (b): destination pieces, partials summed in piece order
        for row in range(num_dst):
            for hh in range(h):
                parts = []
                for edges in pieces(row, rp, pp):
                    acc = np.zeros(dst_tab.shape[1], np.float32)
                    for e in edges:
                        r = None if rl is None else rl[e]
                        cols, alpha, dl, base, b = edge_terms(nbr[e], row, r,
                                                              hh)
                        if form == 'gat':
                            acc[hh] += dl if base >= 0 else slope * dl
                        elif form == 'gatv2':
                            dj = dl * extra[cols]
                            acc[cols] += np.where(b >= 0, dj, slope * dj)
                            d_extra[cols] += np.where(
                                b >= 0, b, slope * b) * dl
                        else:
                            d_extra[r, hh] += dl * base
                            acc[cols] += dl * extra[r, hh] * src_tab[nbr[e],
                                                                     cols]
                    parts.append(acc)
                d_dst[row] += sum(parts)
        # kernel (c): source pieces over the source-sorted edges
        t = fs.src_plan(s, d, rel, num_dst, n_src, split=split)
        trp, tpp, tnbr = t.rowptr.numpy(), t.piece_ptr.numpy(), t.nbr.numpy()
        trl = None if t.rel is None else t.rel.numpy()
        for row in range(n_src):
            for hh in range(h):
                for edges in pieces(row, trp, tpp):
                    for e in edges:
                        r = None if trl is None else trl[e]
                        cols, alpha, dl, base, b = edge_terms(row, tnbr[e], r,
                                                              hh)
                        if form == 'gat':
                            d_src[row, hh] += dl if base >= 0 else slope * dl
                            d_val[row, cols] += alpha * g[tnbr[e], cols]
                        elif form == 'gatv2':
                            dj = dl * extra[cols]
                            d_src[row, cols] += np.where(
                                b >= 0, dj, slope * dj) + alpha * g[tnbr[e],
                                                                    cols]
                        else:
                            d_src[row, cols] += (dl * extra[r, hh]
                                                 * dst_tab[tnbr[e], cols])
                            d_val[row, cols] += alpha * g[tnbr[e], cols]
        return d_src, d_dst, (None if form == 'gatv2' else d_val), d_extra

    return out, m, l, backward


@pytest.mark.parametrize('form', fs.FORMS)
def test_kernel_emulation_matches_the_plain_versions(form):
    """The kernels' order of work (rows split into pieces of 3 edges, one of
    them 13 edges long; empty rows; invalid edges; 2 relations for the dot
    form; kernel (a) as redesigned, on float slots) gives the plain
    versions' outputs, residuals and gradients."""
    rng = np.random.default_rng(FORMS_SEED[form])
    ns, nd, h, c = 11, 9, 2, 3
    src, dst = _edges(rng, ns, nd, 40, 4)
    sw = h if form == 'gat' else h * c
    src_tab = torch.from_numpy(rng.standard_normal((ns, sw)).astype(
        np.float32))
    dst_tab = torch.from_numpy(rng.standard_normal((nd, sw)).astype(
        np.float32))
    val = (src_tab if form == 'gatv2' else torch.from_numpy(
        rng.standard_normal((ns, h * c)).astype(np.float32)))
    extra = rel = None
    if form == 'gatv2':
        extra = torch.from_numpy(rng.standard_normal(h * c).astype(
            np.float32))
    if form == 'dot':
        extra = torch.from_numpy(rng.uniform(0.3, 1.0, (2, h)).astype(
            np.float32))
        rel = torch.from_numpy(rng.integers(0, 2, len(src)))
    ops = fs.FlashOperands(form, h, src_tab, dst_tab, val, extra, 0.2)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    out, m, l = fs.flash_forward_plain(ops, s, d, rel, nd, 7)
    eo, em, el, backward = _emulate(ops, s, d, rel, nd, 3)
    _fwd_close(eo, out.numpy(), 'out')
    _fwd_close(el, l.numpy(), 'l')
    np.testing.assert_array_equal(em, m.numpy())   # a max does not round
    assert np.isinf(em).any()                      # empty rows
    g = rng.standard_normal((nd, h * c)).astype(np.float32)
    ref = fs.flash_backward_plain(ops, s, d, rel, nd, 7, m, l, out,
                                  torch.from_numpy(g))
    for name, got, want in zip(('src', 'dst', 'val', 'extra'),
                               backward(g), ref):
        assert (got is None) == (want is None), name
        if got is not None:
            _grad_close(got, want.numpy(), f'{form} d_{name}')


FORMS_SEED = {'gat': 1, 'gatv2': 2, 'dot': 3}


def _slots(shape, h, c, hg):
    """Kernels (b) and (c)'s lane layout (``lane_slots``): for each lane of
    a sub-team and each of its ``nv`` slots, ``(head, first column)`` or
    None, and whether it is its head's first slot."""
    out = {}
    for sub in range(shape.lanes):
        for k in range(shape.nv):
            v = k * shape.lanes + sub
            hl, w = divmod(v, shape.slots)
            head = hg * shape.heads + hl
            ok = hl < shape.heads and head < h and w * shape.vec < c
            out[sub, k] = ((head, head * c + w * shape.vec, w == 0)
                           if ok else None)
    return out


def _emulate_backward(ops, s, d, rel, num_dst, split, shape, m, l, out, g):
    """Kernels (b) and (c) in their order of work, in numpy float32: one
    warp per (piece, head group) through ``piece_row``; each lane's slots
    (``_slots``); the sub-teams taking alternate batches of ``unroll``
    edges, their sums merged at the end; a head's sums over its slots; a
    split row's pieces merged in piece order; kernel (b)'s record (m, l,
    gdot, a_dst) per row and head, the only destination operands kernel (c)
    reads besides the rows; the global reductions per warp and sub-team,
    per block of 8 warps, then over blocks. Every column of every output
    must be written exactly once."""
    form, h, c, slope = ops.form, ops.heads, ops.columns, np.float32(
        ops.slope)
    src_tab, dst_tab, val, extra = _np_tables(ops)
    m, l, out = (t.numpy().astype(np.float32) for t in (m, l, out))
    g = g.reshape(num_dst, h * c).astype(np.float32)
    n_src = src_tab.shape[0]
    groups = -(-h // shape.heads)
    teams = 32 // shape.lanes
    vec = shape.vec

    def leaky(x):
        return np.where(x >= 0, x, slope * x)

    def team_edges(st, e0, e1):
        for b in range(e0 + st * shape.unroll, e1,
                       teams * shape.unroll):
            yield from range(b, min(b + shape.unroll, e1))

    def run(plan, step, keys, glob_width=0):
        """Walks ``plan``; ``step(row, edge, slots, acc, glob)`` adds one
        edge's terms to a sub-team's per-slot sums; ``keys`` holds, per
        output, its width and the key ``(column, n)`` a slot writes (or
        None); returns the outputs assembled from the slots (zeros where no
        edge added) and the per-block global partials."""
        widths = [w for w, _ in keys]
        outs = [np.full((plan.n_rows, w), np.nan, np.float32)
                for w in widths]
        parts, blocks = {}, {}
        for item, row, k, n_p, hg, e0, e1 in _warps(plan, groups, split):
            slots = _slots(shape, h, c, hg)
            sums, gl = [], []
            for st in range(teams):
                acc = [{} for _ in widths]
                glob = {}
                for e in team_edges(st, e0, e1):
                    step(row, e, slots, acc, glob)
                sums.append(acc)
                gl.append(glob)
            merged = [{} for _ in widths]
            for acc in sums:            # the sub-teams' fixed butterfly
                for i, a in enumerate(acc):
                    for key, v in a.items():
                        merged[i][key] = merged[i].get(key, 0) + v
            blocks.setdefault(item // 8, []).append(gl)
            parts[row, hg, k] = merged
            if k < n_p - 1 and n_p > 1:
                continue
            if n_p > 1:                 # piece order
                merged = [{} for _ in widths]
                for q in range(n_p):
                    for i, a in enumerate(parts[row, hg, q]):
                        for key, v in a.items():
                            merged[i][key] = merged[i].get(key, 0) + v
            for sl in slots.values():
                for i, (_, key) in enumerate(keys):
                    if sl is not None and key(sl) is not None:
                        merged[i].setdefault(key(sl), np.float32(0))
            for i, a in enumerate(merged):
                for (col, n), v in a.items():
                    assert np.isnan(outs[i][row, col:col + n]).all()
                    outs[i][row, col:col + n] = v
        glob_total = np.zeros(glob_width, np.float32)
        for b in sorted(blocks):
            part = np.zeros(glob_width, np.float32)
            for gl in blocks[b]:
                for glob in gl:
                    for (col, n), v in glob.items():
                        part[col:col + n] += v
            glob_total += part
        for o in outs:
            # rows no edge reaches were written too, with zeros
            assert not np.isnan(o).any()
        return outs, glob_total

    def add(acc, key, v):
        acc[key] = acc.get(key, 0) + np.asarray(v, np.float32)

    def terms(sv, dv, r, head, rec):
        """alpha, dlogit, base and the joint's base of one edge and head,
        from the record of its destination."""
        cols = slice(head * c, (head + 1) * c)
        mm, ll, gd, ad = rec
        if form == 'gat':
            base = np.float32(src_tab[sv, head] + ad)
            logit, b = leaky(base), None
        elif form == 'gatv2':
            b = src_tab[sv, cols] + dst_tab[dv, cols]
            base, logit = None, np.float32((extra[cols] * leaky(b)).sum())
        else:
            base = np.float32((dst_tab[dv, cols] * src_tab[sv, cols]).sum())
            logit, b = base * extra[r, head], None
        ms = mm if np.isfinite(mm) else np.float32(0)
        alpha = np.float32(np.exp(logit - ms) / max(ll, np.float32(1e-16)))
        dl = alpha * (np.float32((g[dv, cols] * val[sv, cols]).sum()) - gd)
        return alpha, np.float32(dl), base, b

    # kernel (b): the records, then the destination gradients
    plan = fs.dst_plan(s, d, rel, num_dst, False, split)
    nbr = plan.nbr.numpy()
    rl = None if plan.rel is None else plan.rel.numpy()
    gdot = (g * out).reshape(num_dst, h, c).sum(-1)
    rec = np.stack([m, l, gdot, dst_tab if form == 'gat'
                    else np.zeros_like(m)], -1)
    d_extra = None
    if form == 'dot':
        d_extra = np.zeros_like(extra)

    def step_dst(row, e, slots, acc, glob):
        sv, r = nbr[e], None if rl is None else rl[e]
        for (sub, k), sl in slots.items():
            if sl is None:
                continue
            head, col, first = sl
            alpha, dl, base, b = terms(sv, row, r, head, rec[row, head])
            cc = slice(col - head * c, col - head * c + vec)
            if form == 'gat':
                if first:
                    add(acc[0], (head, 1), dl if base >= 0 else slope * dl)
            elif form == 'gatv2':
                dj = dl * extra[col:col + vec]
                add(acc[0], (col, vec), np.where(b[cc] >= 0, dj, slope * dj))
                add(glob, (col, vec), leaky(b[cc]) * dl)
            else:
                if first:
                    d_extra[r, head] += dl * base
                add(acc[0], (col, vec), dl * extra[r, head]
                    * src_tab[sv, col:col + vec])

    def head_key(sl):
        return (sl[0], 1) if sl[2] else None

    def col_key(sl):
        return sl[1], vec

    (d_dst,), glob = run(plan, step_dst, [
        (dst_tab.shape[1], head_key if form == 'gat' else col_key)],
        h * c if form == 'gatv2' else 0)
    if form == 'gatv2':
        d_extra = glob

    # kernel (c): the source pass, reading the records
    t = fs.src_plan(s, d, rel, num_dst, n_src, split=split)
    tnbr = t.nbr.numpy()
    trl = None if t.rel is None else t.rel.numpy()

    def step_src(row, e, slots, acc, glob):
        dv, r = tnbr[e], None if trl is None else trl[e]
        for (sub, k), sl in slots.items():
            if sl is None:
                continue
            head, col, first = sl
            alpha, dl, base, b = terms(row, dv, r, head, rec[dv, head])
            cc = slice(col - head * c, col - head * c + vec)
            gv = g[dv, col:col + vec]
            if form == 'gat':
                if first:
                    add(acc[0], (head, 1), dl if base >= 0 else slope * dl)
                add(acc[1], (col, vec), alpha * gv)
            elif form == 'gatv2':
                dj = dl * extra[col:col + vec]
                add(acc[0], (col, vec), np.where(b[cc] >= 0, dj, slope * dj)
                    + alpha * gv)
            else:
                add(acc[0], (col, vec), dl * extra[r, head]
                    * dst_tab[dv, col:col + vec])
                add(acc[1], (col, vec), alpha * gv)

    keys = [(src_tab.shape[1], head_key if form == 'gat' else col_key)]
    if form != 'gatv2':
        keys.append((h * c, col_key))
    outs, _ = run(t, step_src, keys)
    return (outs[0], d_dst, None if form == 'gatv2' else outs[1], d_extra,
            rec)


# (H, C, vec): the 16-byte arm (vec 4) at C % 4 = 0, floats where C % 4 != 0
# or the rows do not align; all heads a warp, one head a warp (C = 160 on
# floats: 5 slots a lane), path K's layer 2 padded (48) and not (47)
TEAM_SHAPES = [(2, 8, 4), (4, 16, 4), (3, 4, 4), (1, 40, 4), (1, 48, 4),
               (4, 64, 4), (1, 5, 1), (2, 6, 1), (1, 47, 1), (2, 8, 1),
               (1, 160, 1)]
TEAM_IDS = [f'H{h}-C{c}-vec{v}' for h, c, v in TEAM_SHAPES]


def _team_case(form, h, c):
    """A small case for the team-shape emulations: 11 sources, 9
    destinations (some empty), 40 edges of which a fifth reach one row, 4
    padded edges; 3 relations for the dot form."""
    rng = np.random.default_rng(FORMS_SEED[form] + 10 * h + c)
    ns, nd = 11, 9
    src, dst = _edges(rng, ns, nd, 40, 4)
    sw = h if form == 'gat' else h * c
    src_tab = torch.from_numpy(rng.standard_normal((ns, sw)).astype(
        np.float32))
    dst_tab = torch.from_numpy(rng.standard_normal((nd, sw)).astype(
        np.float32))
    val = (src_tab if form == 'gatv2' else torch.from_numpy(
        rng.standard_normal((ns, h * c)).astype(np.float32)))
    extra = rel = None
    if form == 'gatv2':
        extra = torch.from_numpy(rng.standard_normal(h * c).astype(
            np.float32))
    if form == 'dot':
        extra = torch.from_numpy(rng.uniform(0.3, 1.0, (3, h)).astype(
            np.float32))
        rel = torch.from_numpy(rng.integers(0, 3, len(src)))
    ops = fs.FlashOperands(form, h, src_tab, dst_tab, val, extra, 0.2)
    return ops, torch.from_numpy(src), torch.from_numpy(dst), rel, nd, rng


@pytest.mark.parametrize('form', fs.FORMS)
@pytest.mark.parametrize('h,c,vec', TEAM_SHAPES, ids=TEAM_IDS)
def test_forward_emulation_in_the_redesigned_order(form, h, c, vec):
    """Kernel (a) as redesigned, at its chosen team shape: a warp per row
    and head group, the batch max and one rescale a batch, the sub-teams'
    log-sum-exp butterfly, rows split into pieces of 3 edges found through
    ``piece_row``; every output written once, equal to the plain forward
    (out and l within 1e-5 of max(1, the largest), m bit for bit, -inf on
    the empty rows)."""
    ops, s, d, rel, nd, _ = _team_case(form, h, c)
    shape = fs.team_shape(h, c, vec, 'fwd')
    assert shape.lanes * shape.nv >= shape.heads * shape.slots
    out, m, l = fs.flash_forward_plain(ops, s, d, rel, nd, 7)
    eo, em, el = _emulate_forward(ops, s, d, rel, nd, 3, shape)
    _fwd_close(eo, out.numpy(), 'out')
    _fwd_close(el, l.numpy(), 'l')
    np.testing.assert_array_equal(em, m.numpy())   # a max does not round


@pytest.mark.parametrize('form', fs.FORMS)
@pytest.mark.parametrize('h,c,vec', TEAM_SHAPES, ids=TEAM_IDS)
def test_backward_emulation_in_the_redesigned_order(form, h, c, vec):
    """Kernels (b) and (c) as redesigned, at their chosen team shape: all
    heads of a row in one warp (or one head a warp), 16-byte or float
    slots, sub-teams on alternate batches, rows split into pieces of 3 edges
    found through ``piece_row``, and the packed record; every output column
    written once, and the gradients equal to the plain backward's (1e-4 of
    each one's largest), the record to (m, l, <g, out>, a_dst)."""
    ops, s, d, rel, nd, rng = _team_case(form, h, c)
    shape = fs.team_shape(h, c, vec, 'dst')
    # kernels (b) and (c) differ in batches in flight only, which changes
    # no sum
    assert shape._replace(depth=1) == fs.team_shape(h, c, vec, 'src')
    assert shape.lanes * shape.nv >= shape.heads * shape.slots
    out, m, l = fs.flash_forward_plain(ops, s, d, rel, nd, 7)
    g = rng.standard_normal((nd, h * c)).astype(np.float32)
    *got, rec = _emulate_backward(ops, s, d, rel, nd, 3, shape, m, l, out,
                                  g)
    np.testing.assert_array_equal(rec[..., 0], m.numpy())
    np.testing.assert_array_equal(rec[..., 1], l.numpy())
    _fwd_close(rec[..., 2], (g * out.numpy()).reshape(nd, h, c).sum(-1))
    ref = fs.flash_backward_plain(ops, s, d, rel, nd, 7, m, l, out,
                                  torch.from_numpy(g))
    for name, a, want in zip(('src', 'dst', 'val', 'extra'), got, ref):
        assert (a is None) == (want is None), name
        if a is not None:
            _grad_close(a, want.numpy(), f'{form} d_{name}')


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are the plain versions and count no
    launch; a non-float32 table on the card would raise (checked on the
    card, ``tests/test_torch_cuda.py``)."""
    rng = np.random.default_rng(5)
    src, dst = _edges(rng, 8, 6, 30, 2)
    ops = fs.FlashOperands('gat', 2, torch.randn(8, 2), torch.randn(6, 2),
                           torch.randn(8, 6), None)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    before = (fs.flash_forward.launches, fs.flash_backward.launches_dst,
              fs.flash_backward.launches_src)
    out, m, l = fs.flash_forward(ops, s, d, None, 6, 5)
    ref = fs.flash_forward_plain(ops, s, d, None, 6, 5)
    for a, b in zip((out, m, l), ref):
        assert torch.equal(a, b)
    grads = fs.flash_backward(ops, s, d, None, 6, 5, m, l, out,
                              torch.randn(6, 6))
    assert grads[0].shape == (8, 2) and grads[3] is None
    assert (fs.flash_forward.launches, fs.flash_backward.launches_dst,
            fs.flash_backward.launches_src) == before


# -- the convs ------------------------------------------------------------------
def _graph(n, e, seed):
    rng = np.random.default_rng(seed)
    rows = rng.choice(n, 3 * n // 4, replace=False)
    coo = np.stack([rng.integers(0, n, e), rows[rng.integers(0, len(rows),
                                                             e)]])
    return coo.astype(np.int32), rng


def _param_grads(jconv, params, x, coo_j, cot):
    def loss(p):
        return (jconv.apply(p, x, coo_j) * cot).sum()
    return flax_to_state_dict(jax.grad(loss)(params))


CONV_CASES = ['GATConv', 'GATv2Conv', 'TransformerConv']


@pytest.mark.parametrize('name', CONV_CASES)
def test_conv_flash_branch_matches_jax(monkeypatch, name):
    """Each conv past the cap (``PGT_ATTN_WIDE_BYTES = 0``, default self
    loops, 4 heads, a chunk smaller than the edges), from the same flax
    weights: the output and every parameter's gradient."""
    monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', '0')
    monkeypatch.setenv('PGT_ATTN_CHUNK_EDGES', '173')
    n, f, h, c = 50, 7, 4, 3
    coo, rng = _graph(n, 420, 30 + CONV_CASES.index(name))
    x = rng.standard_normal((n, f)).astype(np.float32)
    cot = rng.standard_normal((n, h * c)).astype(np.float32)
    jcls = {'GATConv': JGATConv, 'GATv2Conv': JGATv2Conv,
            'TransformerConv': JTransformerConv}[name]
    tcls = {'GATConv': GATConv, 'GATv2Conv': GATv2Conv,
            'TransformerConv': TransformerConv}[name]
    kw = {'beta': True} if name == 'TransformerConv' else {}
    jconv = jcls(out_channels=c, heads=h, **kw)
    xj, cj = jnp.asarray(x), jnp.asarray(coo)
    params = jconv.init(jax.random.PRNGKey(4), xj, cj)
    jout = jconv.apply(params, xj, cj)
    jg = _param_grads(jconv, params, xj, cj, jnp.asarray(cot))
    conv = tcls(f, c, heads=h, device='cpu', **kw)
    conv.load_state_dict(flax_to_state_dict(params))
    calls = []
    real = tattn._FlashAttention.apply

    def spy(*a):
        calls.append(a[0])
        return real(*a)

    monkeypatch.setattr(tattn._FlashAttention, 'apply', spy)
    out = conv(torch.from_numpy(x), torch.from_numpy(coo))
    assert calls == [{'GATConv': 'gat', 'GATv2Conv': 'gatv2',
                      'TransformerConv': 'dot'}[name]]
    _fwd_close(out, jout, f'{name} out')
    (out * torch.from_numpy(cot)).sum().backward()
    assert sorted(jg) == sorted(k for k, _ in conv.named_parameters())
    largest = max(float(np.abs(np.asarray(g)).max()) for g in jg.values())
    for k, p in conv.named_parameters():
        if k == 'lin_key.bias':
            # the softmax cancels a shift of every score of a destination,
            # so this gradient is 0 but for rounding in both packages: held
            # to 1e-4 of the largest gradient, as tests/test_torch_transformer
            assert float((p.grad - jg[k]).abs().max()) <= GRAD_TOL * largest
            continue
        _grad_close(p.grad, jg[k], f'{name} grad {k}')


def test_wide_cap_is_read_per_call_like_jax(monkeypatch):
    """Fault repair: ``PGT_ATTN_WIDE_BYTES`` is read on every call, as the
    JAX package reads it, so both packages take the flash branch on the same
    side of the cap (``E * H * C * 4`` bytes, self loops included)."""
    n, f, h, c = 40, 5, 2, 3
    coo, rng = _graph(n, 200, 41)
    x = rng.standard_normal((n, f)).astype(np.float32)
    msg_bytes = (coo.shape[1] + n) * h * c * 4
    jconv = JGATConv(out_channels=c, heads=h)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(coo))
    conv = GATConv(f, c, heads=h, device='cpu')
    conv.load_state_dict(flax_to_state_dict(params))
    jcalls, tcalls = [], []
    jreal, treal = jattn.gat_flash_attention, tgat_conv.gat_flash_attention
    monkeypatch.setattr(jattn, 'gat_flash_attention', lambda *a, **k: (
        jcalls.append(1), jreal(*a, **k))[1])
    monkeypatch.setattr(tgat_conv, 'gat_flash_attention', lambda *a, **k: (
        tcalls.append(1), treal(*a, **k))[1])
    for cap, flash in ((msg_bytes, False), (msg_bytes - 1, True)):
        monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', str(cap))
        jout = jconv.apply(params, jnp.asarray(x), jnp.asarray(coo))
        out = conv(torch.from_numpy(x), torch.from_numpy(coo))
        assert len(jcalls) == len(tcalls) == int(flash), cap
        _fwd_close(out, jout, f'cap {cap}')
        jcalls.clear()
        tcalls.clear()


class _EdgeFloatSpy(TorchDispatchMode):
    """Records every floating-point tensor an op makes whose first dimension
    is ``e``."""

    def __init__(self, e):
        super().__init__()
        self.e, self.seen = e, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.dim() >= 1 and t.shape[0] == self.e):
                self.seen.append((str(func), tuple(t.shape)))
        return out


@pytest.mark.parametrize('name', CONV_CASES)
def test_flash_branch_builds_no_per_edge_float_tensor(monkeypatch, name):
    """Fault repair: the branch is chosen from shapes before any per-edge
    array is built, and the flash branch builds none: no op of the forward
    or backward makes a float tensor of ``E`` rows (self loops included; the
    plain scan's chunk is 64 edges)."""
    monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', '0')
    monkeypatch.setenv('PGT_ATTN_CHUNK_EDGES', '64')
    n, f, h, c = 30, 4, 2, 3
    coo, rng = _graph(n, 300, 50)
    e = coo.shape[1] + (0 if name == 'TransformerConv' else n)
    cls = {'GATConv': GATConv, 'GATv2Conv': GATv2Conv,
           'TransformerConv': TransformerConv}[name]
    conv = cls(f, c, heads=h, device='cpu')
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    spy = _EdgeFloatSpy(e)
    with spy:
        conv(x, torch.from_numpy(coo)).sum().backward()
    assert spy.seen == []
    # the check sees them: the plain branch builds [E, H] logits
    monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', '1e18')
    spy = _EdgeFloatSpy(e)
    with spy:
        conv(x, torch.from_numpy(coo))
    assert spy.seen


# -- chip_smoke.py's path K at a tiny scale --------------------------------------
def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_path_k_trains_like_jax(monkeypatch):
    """``chip_smoke.py``'s path K (``products_bench.py --gat``'s model:
    ``GATConv(100, 16, heads=4)`` -> ReLU -> ``GATConv(64, 47, heads=1,
    concat=False)``, default self loops, softmax cross-entropy, Adam 1e-3)
    on a 600-node products graph, both layers forced onto the flash scan,
    against the JAX package's ``run_gat`` model and optax: the forward, the
    first step's gradients and 5 steps' losses."""
    monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', '0')
    monkeypatch.setenv('PGT_ATTN_CHUNK_EDGES', '4096')
    smoke = _load('chip_smoke', 'chip_smoke.py')
    n, e = 600, 9000
    coo = smoke.products_graph(n, e, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, smoke.PR_F)).astype(np.float32)
    y = rng.integers(0, smoke.PR_CLASSES, n)

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x, coo):
            x = fnn.relu(JGATConv(out_channels=smoke.PR_HIDDEN // 4, heads=4,
                                  name='conv_0')(x, coo))
            return JGATConv(out_channels=smoke.PR_CLASSES, heads=1,
                            concat=False, name='conv_1')(x, coo)

    net = Net()
    xj, cj, yj = jnp.asarray(x), jnp.asarray(coo), jnp.asarray(y)
    params = net.init(jax.random.PRNGKey(0), xj, cj)
    tx = optax.adam(smoke.PR_LR)

    def loss_fn(p):
        out = net.apply(p, xj, cj)
        return optax.softmax_cross_entropy_with_integer_labels(
            out, yj).mean(), out

    @jax.jit
    def step(p, o):
        (loss, out), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        upd, o = tx.update(g, o)
        return optax.apply_updates(p, upd), o, loss, g, out

    p, o = params, tx.init(params)
    jlosses = []
    for i in range(5):
        p, o, loss, g, out = step(p, o)
        jlosses.append(float(loss))
        if i == 0:
            jgrads, jout = flax_to_state_dict(g), out
    model = smoke.products_gat(torch, 'cpu', 0)
    model.load_state_dict(flax_to_state_dict(params))
    opt = torch.optim.Adam(model.parameters(), lr=smoke.PR_LR)
    xt, yt, ct = torch.from_numpy(x), torch.from_numpy(y), \
        torch.from_numpy(coo)
    tlosses = []
    for i in range(5):
        opt.zero_grad(set_to_none=True)
        out = model(xt, ct)
        loss = F.cross_entropy(out, yt)
        loss.backward()
        if i == 0:
            _fwd_close(out, jout, 'path K forward')
            for k, prm in model.named_parameters():
                _grad_close(prm.grad, jgrads[k], f'path K grad {k}')
        opt.step()
        tlosses.append(loss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
    assert math.isfinite(tlosses[-1])
