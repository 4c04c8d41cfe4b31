"""The segment-sum kernel's host side (``ops/segment_spmm.py``): its launch
plan at every path's shape and its refusals, a numpy emulation of the
kernel's float32 summation order (lane group ``g`` of a row takes the row's
edges ``beg + g, beg + g + G, ...`` into its own partial, a fixed xor
shuffle tree adds the ``G`` partials, then ``base``; the staged and the
direct mode take the same order) against the plain
version and the JAX package's ``segment_sum_sorted`` (its Pallas kernel in
interpret mode, ``PGT_FORCE_PALLAS=1``, as ``tests/test_pallas.py`` runs
it), and the block-sparse arm that hands its block product to the kernel
as ``base``, against the JAX package's ``spmm``.

Tolerances: PERF.md section 2's kernel limit, ``1e-5 + 1e-5 * sum |w * x|``
per output (float32 sums in another order); a bf16 output one bf16 ulp of
the plain version's; forwards of the block arm 1e-5 and gradients 1e-4 of
the reference's largest magnitude (as ``tests/test_torch_bsr.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.ops import spmm as jspmm
from pytorch_geometric_tpu.ops.pallas_spmm import segment_sum_sorted
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.ops import spmm, spmm_regime
from pytorch_geometric_tpu_torch.ops.segment_spmm import (
    MIN_GROUP_RUN, SegmentPlan, check_plan, segment_plan, segment_spmm,
    segment_spmm_plain)

ALIGNED = 1 << 20      # a pointer aligned as far as any load width needs


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv('PGT_FORCE_PALLAS', '1')


# -- the plan -----------------------------------------------------------------
# (label, f, itemsize, n_dst, n_edges, x_ptr offset, expected plan): the
# paths' shapes (serving: 30,000 nodes, 1,030,000 edges; path B 10,000 nodes,
# 210,000 edges with self loops, both directions; path A's residual 250,000
# nodes, 494,359 edges, both directions; path H layer 1 in bf16)
PATH_PLANS = [
    ('serving F=128', 128, 4, 30_000, 1_030_000, 0, (4, 32, 1, 1, 0)),
    ('serving F=16', 16, 4, 30_000, 1_030_000, 0, (4, 4, 2, 4, 1)),
    ('path H layer 1 bf16 F=128', 128, 2, 30_000, 1_030_000, 0,
     (8, 16, 1, 2, 0)),
    ('path B F=64', 64, 4, 10_000, 210_000, 0, (4, 16, 1, 2, 0)),
    ('path B F=10', 10, 4, 10_000, 210_000, 0, (2, 8, 2, 2, 1)),
    ('path A residual F=64', 64, 4, 250_000, 494_359, 0, (4, 16, 1, 2, 0)),
    ('path A residual F=10', 10, 4, 250_000, 494_359, 0, (2, 8, 1, 4, 1)),
    ('F=10, x 8-byte aligned', 10, 4, 10_000, 210_000, 8, (2, 8, 2, 2, 1)),
    ('F=16, x 4 bytes past 16', 16, 4, 30_000, 1_030_000, 4,
     (1, 16, 1, 2, 0)),
    ('F=16, x 8 bytes past 16', 16, 4, 30_000, 1_030_000, 8,
     (2, 8, 2, 2, 1)),
    ('bf16 F=10', 10, 2, 10_000, 210_000, 0, (1, 16, 1, 2, 0)),
    ('bf16 F=12', 12, 2, 10_000, 210_000, 0, (4, 4, 2, 4, 1)),
    ('F=1 hub rows', 1, 4, 100, 100_000, 0, (1, 1, 32, 1, 1)),
    ('F=256, two column passes', 256, 4, 30_000, 1_030_000, 0,
     (4, 32, 1, 1, 0)),
    ('no edges', 64, 4, 1000, 0, 0, (4, 16, 1, 2, 0)),
]


@pytest.mark.parametrize('case', PATH_PLANS, ids=[c[0] for c in PATH_PLANS])
def test_plan_at_path_shapes(case):
    _, f, itemsize, n_dst, n_edges, off, want = case
    plan = segment_plan(f, itemsize, n_dst, n_edges, ALIGNED + off, ALIGNED)
    assert plan == SegmentPlan(*want)
    assert plan.lanes * plan.groups * plan.rows_per_warp == 32
    # it passes the refusal rules, and each group keeps its edge run
    check_plan(plan, f, itemsize, (ALIGNED + off, ALIGNED))
    if plan.groups > 1:
        assert n_edges / n_dst >= MIN_GROUP_RUN * plan.groups


def test_plan_takes_base_alignment():
    # an 8-byte aligned base takes the whole call to 8-byte loads
    assert segment_plan(64, 4, 100, 400, ALIGNED, ALIGNED,
                        ALIGNED + 8).vec == 2
    assert segment_plan(64, 4, 100, 400, ALIGNED, ALIGNED, 0).vec == 4


REFUSED = [
    ('64 lanes a row', (4, 16, 4, 1), 64, 4),
    ('lanes not a power of two', (4, 12, 1, 2), 64, 4),
    ('rows do not fill the warp', (4, 16, 1, 1), 64, 4),
    ('two warps of rows', (4, 16, 1, 4), 64, 4),
    ('no 8-wide float32 loads', (8, 8, 1, 4), 64, 4),
    ('no 2-wide bf16 loads', (2, 8, 1, 4), 64, 2),
    ('4-wide loads of F=10', (4, 4, 1, 8), 10, 4),
    ('a zero group', (4, 16, 0, 2), 64, 4),
    ('staged neither 0 nor 1', (4, 16, 1, 2, 2), 64, 4),
]


@pytest.mark.parametrize('case', REFUSED, ids=[c[0] for c in REFUSED])
def test_plan_refusals(case):
    _, plan, f, itemsize = case
    with pytest.raises(ValueError, match='segment_spmm'):
        check_plan(plan, f, itemsize, (ALIGNED, 0))


def test_wrapper_refuses_a_plan_that_does_not_tile():
    indptr, src, w, x = _graph(64, 50, 300, 16, seed=0)
    xt = torch.from_numpy(x)
    args = (torch.from_numpy(indptr), torch.from_numpy(src), None, xt)
    with pytest.raises(ValueError, match='does not tile'):
        segment_spmm(*args, plan=(4, 4, 4, 4))
    # 16-byte loads of an x 4 bytes past a 16-byte boundary
    xs = torch.cat([xt.new_zeros(1), xt.flatten()])[1:].view(xt.shape)
    with pytest.raises(ValueError, match='aligned'):
        segment_spmm(*args[:3], xs, plan=(4, 4, 1, 8))
    # a plan that tiles runs (the plain version, on the CPU)
    torch.testing.assert_close(segment_spmm(*args, plan=(1, 16, 2, 1, 0)),
                               segment_spmm_plain(*args), rtol=0, atol=0)


# -- the emulation of the kernel's sums ---------------------------------------
def _bf16(a):
    """float32 values rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def emulate(indptr, src, w, x, groups, base=None, bf16=False):
    """The kernel's sums in numpy: lane group ``g`` of row ``d`` adds the
    row's edges ``beg + g + j * groups`` for ``j = 0, 1, ...`` into its own
    float32 partial, one FMA each (float32: ``w * x + acc`` rounded once;
    bf16: the message ``bf16(w * x)``, or ``x`` unweighted, then a float32
    add); a source outside ``[0, n_src)`` adds 0. Then ``partial[g] +=
    partial[g ^ m]`` for ``m = 1, 2, ... < groups``, then ``base``; a bf16
    result is rounded once."""
    indptr = np.asarray(indptr, np.int64)
    src = np.asarray(src, np.int64)
    n_dst, (n_src, f), n_edges = len(indptr) - 1, x.shape, len(src)
    beg = np.clip(indptr[:-1], 0, n_edges)
    n_row = np.maximum(np.minimum(indptr[1:], n_edges) - beg, 0)
    xf = np.asarray(x, np.float32)
    wf = np.ones(n_edges, np.float32) if w is None else \
        np.asarray(w, np.float32)
    parts = np.zeros((groups, n_dst, f), np.float32)
    for j in range(-(-int(n_row.max(initial=0)) // groups)):
        for g in range(groups):
            pos = g + j * groups
            live = pos < n_row
            k = np.where(live, beg + pos, 0)
            s = src[k] if n_edges else np.zeros(n_dst, np.int64)
            ok = live & (s >= 0) & (s < n_src)
            xs = np.where(ok[:, None], xf[np.clip(s, 0, n_src - 1)], 0)
            ws = np.where(ok, wf[k] if n_edges else 0, 0).astype(np.float32)
            if bf16:
                msg = xs if w is None else _bf16(ws[:, None] * xs)
                parts[g] = parts[g] + msg.astype(np.float32)
            else:
                parts[g] = (ws[:, None].astype(np.float64) * xs
                            + parts[g]).astype(np.float32)
    m = 1
    while m < groups:
        parts = np.stack([parts[g] + parts[g ^ m] for g in range(groups)])
        m *= 2
    out = parts[0]
    if base is not None:
        out = out + np.asarray(base, np.float32)
    return _bf16(out) if bf16 else out


def _graph(n_src, n_dst, e, f, seed, hub=0, n_pad=0, n_bad=0):
    """A destination-sorted CSC built in numpy: a third of the rows empty,
    a ``hub``-edge row, ``n_pad`` padded edges past ``indptr[-1]`` and
    ``n_bad`` sources outside ``[0, n_src)`` (-1 and ``n_src + 3``);
    ``(indptr, src, w, x)``."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(n_dst, max(1, 2 * n_dst // 3), replace=False)
    dst = rows[rng.integers(0, len(rows), e)]
    if hub:
        dst = np.concatenate([dst, np.full(hub, rows[0])])
    src = rng.integers(0, n_src, len(dst))
    order = np.argsort(dst, kind='stable')
    dst, src = dst[order], src[order]
    bad = rng.choice(len(src), n_bad, replace=False)
    src[bad] = np.where(np.arange(n_bad) % 2, -1, n_src + 3)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(dst,
                                                        minlength=n_dst))])
    src = np.concatenate([src, rng.integers(0, n_src, n_pad)])
    w = rng.random(len(src)).astype(np.float32)
    x = rng.standard_normal((n_src, f)).astype(np.float32)
    return indptr.astype(np.int32), src.astype(np.int32), w, x


def _scale(indptr, src, w, x):
    """Each output's sum of |w * x| terms (the limit's scale)."""
    return segment_spmm_plain(
        torch.from_numpy(indptr), torch.from_numpy(src),
        None if w is None else torch.from_numpy(np.abs(w)),
        torch.from_numpy(np.abs(x))).numpy()


def _within(got, ref, scale):
    err = np.abs(got - ref)
    assert (err <= 1e-5 + 1e-5 * scale).all(), float(err.max())


# every lane-group count the plan's lanes allow at each width: the kernel's
# f32 plan branches (vec 1, 2, 4 at F = 1, 10, 16, 64, 128)
BRANCHES = [(f, g) for f in (1, 10, 16, 64, 128)
            for g in (1, 2, 4, 8, 16, 32)
            if segment_plan(f, 4, 1, 0, ALIGNED, ALIGNED).lanes * g <= 32]


@pytest.mark.parametrize('weighted', [True, False])
@pytest.mark.parametrize('f,groups', BRANCHES)
def test_emulated_sums_match_plain(f, groups, weighted):
    """A 5,000-edge hub row, empty rows, padded edges and sources out of
    range, at every lane-group count."""
    indptr, src, w, x = _graph(300, 400, 6000, f, seed=f + groups, hub=5000,
                               n_pad=40, n_bad=30)
    w = w if weighted else None
    ref = segment_spmm_plain(torch.from_numpy(indptr), torch.from_numpy(src),
                             None if w is None else torch.from_numpy(w),
                             torch.from_numpy(x)).numpy()
    got = emulate(indptr, src, w, x, groups)
    _within(got, ref, _scale(indptr, src, w, x))
    # with a base: the plain version adds it to the finished sum
    base = np.random.default_rng(1).standard_normal(ref.shape).astype(
        np.float32)
    ref_b = segment_spmm_plain(
        torch.from_numpy(indptr), torch.from_numpy(src),
        None if w is None else torch.from_numpy(w), torch.from_numpy(x),
        torch.from_numpy(base)).numpy()
    np.testing.assert_array_equal(ref_b, ref + base)
    _within(emulate(indptr, src, w, x, groups, base), ref_b,
            _scale(indptr, src, w, x))


@pytest.mark.parametrize('f', [1, 10, 16, 64, 128])
def test_emulated_sums_match_jax_segment_sum(f):
    """The emulation under the plan the paths' mean degree would pick,
    against the JAX package's Pallas segment sum (interpret mode) of the
    same messages."""
    indptr, src, w, x = _graph(200, 300, 3000, f, seed=7 * f, hub=5000,
                               n_pad=24, n_bad=20)
    plan = segment_plan(f, 4, 300, len(src), ALIGNED, ALIGNED)
    got = emulate(indptr, src, w, x, plan.groups)
    e = int(indptr[-1])
    s = src[:e].astype(np.int64)
    ok = (s >= 0) & (s < x.shape[0])
    msg = np.where(ok[:, None], x[np.clip(s, 0, x.shape[0] - 1)]
                   * w[:e, None], 0).astype(np.float32)
    dst = np.repeat(np.arange(300), np.diff(indptr)).astype(np.int32)
    ref = np.asarray(segment_sum_sorted(jnp.asarray(msg), jnp.asarray(dst),
                                        300))
    _within(got, ref, _scale(indptr, src, w, x))


@pytest.mark.parametrize('weighted', [True, False])
@pytest.mark.parametrize('f,groups', [(10, 1), (10, 2), (16, 4), (24, 2),
                                      (128, 1), (128, 2)])
def test_bf16_emulation_within_one_ulp(f, groups, weighted):
    indptr, src, w, x = _graph(300, 400, 6000, f, seed=f, hub=5000,
                               n_pad=16, n_bad=10)
    xb, wb = _bf16(x), (_bf16(w) if weighted else None)
    base = _bf16(np.random.default_rng(2).standard_normal((400, f)))
    t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
         (('x', xb), ('base', base)) + ((('w', wb),) if weighted else ())}
    for bs in (None, base):
        ref = segment_spmm_plain(torch.from_numpy(indptr),
                                 torch.from_numpy(src), t.get('w'), t['x'],
                                 None if bs is None else t['base']
                                 ).float().numpy()
        got = emulate(indptr, src, wb, xb, groups, bs, bf16=True)
        ulp = np.abs(ref) * 2.0 ** -7      # one bf16 ulp of the reference
        err = np.abs(got - ref)
        assert (err <= ulp + 1e-30).all(), float(err.max())


# -- base through the wrapper and the block-sparse arm ------------------------
def test_base_gradient_is_g():
    indptr, src, w, x = _graph(80, 60, 500, 12, seed=3, n_pad=4)
    csc = [torch.from_numpy(a) for a in (indptr, src)]
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    base = torch.randn(60, 12, generator=torch.Generator().manual_seed(0),
                       requires_grad=True)
    # the transposed layout, for grad_x
    dst = np.repeat(np.arange(60), np.diff(indptr))
    e = int(indptr[-1])
    order = np.argsort(src[:e], kind='stable')
    t_indptr = np.concatenate([[0], np.cumsum(np.bincount(src[:e],
                                                          minlength=80))])
    transpose = (torch.from_numpy(t_indptr.astype(np.int32)),
                 torch.from_numpy(dst[order].astype(np.int32)),
                 torch.from_numpy(w[:e][order]))
    out = segment_spmm(*csc, wt, xt, transpose, base=base)
    g = torch.randn(60, 12, generator=torch.Generator().manual_seed(1))
    out.backward(g)
    assert torch.equal(base.grad, g)
    xr = xt.detach().clone().requires_grad_()
    wr = wt.detach().clone().requires_grad_()
    ref = segment_spmm_plain(*csc, wr, xr) + base.detach()
    ref.backward(g)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(xt.grad, xr.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wt.grad, wr.grad, rtol=1e-5, atol=1e-5)


def _bsr_graph(relabel):
    """The graphs of ``tests/test_torch_bsr.py``: 128-node communities with
    a scattered tail (the residual), or a scrambled power-law graph with
    padded edges, whose hubs-first relabel fill_cache bakes."""
    if relabel:
        n, e = 3000, 6000
        rng = np.random.default_rng(1)
        pw = np.arange(1, n + 1) ** -0.9
        pw /= pw.sum()
        sc = rng.permutation(n)
        coo = np.stack([sc[rng.choice(n, e, p=pw)],
                        sc[rng.choice(n, e, p=pw)]])
        coo = np.concatenate([coo, np.full((2, 40), n)], 1)
    else:
        n, e = 600, 6000
        rng = np.random.default_rng(0)
        c = rng.integers(0, n // 128 + 1, e)
        coo = np.stack([np.clip(c * 128 + rng.integers(0, 128, e), 0, n - 1),
                        np.clip(c * 128 + rng.integers(0, 128, e), 0,
                                n - 1)])
        coo = np.concatenate([coo, rng.integers(0, n, (2, 300))], 1)
    return coo.astype(np.int32), n, np.random.default_rng(11)


@pytest.mark.parametrize('op', ['forward', 'grad'])
@pytest.mark.parametrize('relabel', [False, True])
def test_fused_bsr_arm_matches_jax(relabel, op):
    """The block arm's residual pass takes the block product as its base
    (one autograd node, ``_BsrArm``), forward and gradient, against the
    JAX package's ``out + segment_sum(...)``."""
    coo, n, rng = _bsr_graph(relabel)
    w = rng.random(coo.shape[1]).astype(np.float32)
    j = JEdgeIndex(coo, (n, n)).fill_cache(dense_weight=w, block_sparse=True)
    t = EdgeIndex(coo, (n, n), device='cpu').fill_cache(dense_weight=w,
                                                        block_sparse=True)
    assert spmm_regime(t) == 'bsr' and t.bsr_res is not None
    assert (t.bsr_perm is not None) == relabel
    x = rng.standard_normal((n, 12)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm(t, xt)
    assert type(out.grad_fn).__name__ == '_BsrArmBackward'
    if op == 'forward':
        ref, got, tol = np.asarray(jspmm(j, jnp.asarray(x))), \
            out.detach().numpy(), 1e-5
    else:
        import jax
        c = rng.standard_normal((n, 12)).astype(np.float32)
        ref = np.asarray(jax.grad(lambda xx: (jspmm(j, xx) * c).sum())(
            jnp.asarray(x)))
        (out * torch.from_numpy(c)).sum().backward()
        got, tol = xt.grad.numpy(), 1e-4
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())
