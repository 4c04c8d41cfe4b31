"""Attention through the PyTorch port against the JAX package, on the same
numpy inputs: the fused softmax aggregation (``gat_aggregate``, forward and
gradients, with ``edge_mask`` and ``numerator_scale``), the segment max,
the segment softmax and ``add_self_loops``, GATConv / GATv2Conv on their
fused and plain branches from the same (converted flax) weights, and the
GAT model's forward, first-step gradients and 3-step Adam losses.

The JAX side runs its Pallas kernels as its own tests run them on the CPU,
in interpret mode under ``PGT_FORCE_PALLAS=1`` (``tests/test_pallas.py``);
the port runs its kernels' plain versions, through the same wrappers and
autograd Functions that serve the card.

Tolerances: ``gat_aggregate`` outputs 1e-5 and gradients 1e-4 absolute (the
JAX package's own bounds, ``tests/test_pallas.py:183-228``); convs, model
outputs, gradients and losses 1e-4 relative to the reference's largest
magnitude (float32 sums and matmuls in another order); the segment max
exactly (a maximum does not round)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.nn import models as jmodels
from pytorch_geometric_tpu.nn.conv import GATConv as JGATConv
from pytorch_geometric_tpu.nn.conv import GATv2Conv as JGATv2Conv
from pytorch_geometric_tpu.ops import softmax as jsoftmax
from pytorch_geometric_tpu.ops.gat_fused import \
    gat_aggregate as jgat_aggregate
from pytorch_geometric_tpu.ops.pallas_spmm import \
    segment_max_blocked as jsegment_max_blocked
from pytorch_geometric_tpu.utils.loop import add_self_loops as jadd_self_loops
from pytorch_geometric_tpu_torch import EdgeIndex, backend
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import models
from pytorch_geometric_tpu_torch.nn.conv import (FusedGATConv, GATConv,
                                                 GATv2Conv)
from pytorch_geometric_tpu_torch.ops import (gat_aggregate, gat_mix,
                                             segment_max_blocked,
                                             segment_max_plain, softmax)
from pytorch_geometric_tpu_torch.ops.gather import take_rows
from pytorch_geometric_tpu_torch.utils import add_self_loops

TOL = 1e-4


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv('PGT_FORCE_PALLAS', '1')


def _close(got, ref, tol=TOL, what=''):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _graph(n_src, n_dst, e, seed, n_pad=0):
    """Random COO onto three quarters of the destinations (the rest stay
    empty), plus ``n_pad`` padded edges."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(n_dst, 3 * n_dst // 4, replace=False)
    coo = np.stack([rng.integers(0, n_src, e),
                    rows[rng.integers(0, len(rows), e)]])
    pad = np.stack([np.full(n_pad, n_src), np.full(n_pad, n_dst)])
    return np.concatenate([coo, pad], 1).astype(np.int32), rng


# -- the fused aggregation ----------------------------------------------------
@pytest.mark.parametrize('case', ['plain', 'edge_mask', 'numerator_scale'])
def test_gat_aggregate_matches_jax(case):
    """Outputs within 1e-5 and the gradients of the logits and of v within
    1e-4 of the JAX package's fused path; the edge_mask case runs a
    bipartite graph with padded edges."""
    n_src, n_dst = (300, 300) if case != 'edge_mask' else (250, 300)
    coo, rng = _graph(n_src, n_dst, 2500, seed=len(case),
                      n_pad=9 if case == 'edge_mask' else 0)
    e, h, f = coo.shape[1], 4, 16
    logits = (rng.normal(size=(e, h)) * 3).astype(np.float32)
    v = rng.normal(size=(n_src, h, f)).astype(np.float32)
    c = rng.normal(size=(n_dst, h, f)).astype(np.float32)
    kw_np = {}
    if case == 'edge_mask':
        kw_np['edge_mask'] = rng.random(e) < 0.7
    if case == 'numerator_scale':
        kw_np['numerator_scale'] = ((rng.random((e, h)) < 0.5)
                                    .astype(np.float32) * 2.0)
    jei = JEdgeIndex(jnp.asarray(coo), (n_src, n_dst)).fill_cache(
        blocked=True)

    @jax.jit
    def jax_side(ei, l, vv, cc, kw):
        (out, s), vjp = jax.vjp(
            lambda a, b: jgat_aggregate(ei, a, b, return_alpha_sum=True,
                                        **kw), l, vv)
        return (out, s) + vjp((cc, jnp.zeros_like(s)))

    jout, js, jgl, jgv = jax_side(
        jei, jnp.asarray(logits), jnp.asarray(v), jnp.asarray(c),
        {k: jnp.asarray(a) for k, a in kw_np.items()})

    tei = EdgeIndex(coo, (n_src, n_dst), device='cpu').fill_cache(
        blocked=True)
    lt = torch.from_numpy(logits).requires_grad_()
    vt = torch.from_numpy(v).requires_grad_()
    before = gat_mix.launches
    out, s = gat_aggregate(tei, lt, vt, return_alpha_sum=True,
                           **{k: torch.from_numpy(a)
                              for k, a in kw_np.items()})
    assert gat_mix.launches == before      # the CPU runs the plain version
    (out * torch.from_numpy(c)).sum().backward()
    assert np.abs(out.detach().numpy() - np.asarray(jout)).max() < 1e-5
    _close(s.detach(), js, what='alpha sum')
    assert np.abs(lt.grad.numpy() - np.asarray(jgl)).max() < 1e-4
    assert np.abs(vt.grad.numpy() - np.asarray(jgv)).max() < 1e-4


def test_gat_aggregate_needs_the_slot_orders():
    ei = EdgeIndex(np.array([[0, 1], [1, 0]], np.int32), (2, 2),
                   device='cpu').fill_cache(blocked=False)
    with pytest.raises(ValueError, match='blocked=True'):
        gat_aggregate(ei, torch.zeros(2, 1), torch.zeros(2, 1, 3))


# -- the segment max ----------------------------------------------------------
@pytest.mark.parametrize('h', [3, 4])
def test_segment_max_matches_jax_exactly(h):
    """The JAX kernel over its blocked slots and the port's over its own,
    from the same per-edge values: -inf entries, empty rows, padded edges;
    bitwise equal, -inf where a row is empty or its max is -inf."""
    n = 300
    coo, rng = _graph(n, n, 2500, seed=h, n_pad=5)
    e = coo.shape[1]
    vals = rng.normal(size=(e, h)).astype(np.float32) * 10
    vals[rng.random((e, h)) < 0.2] = -np.inf
    only = coo[1] == coo[1][0]           # one row holds nothing but -inf
    vals[only] = -np.inf
    jei = JEdgeIndex(jnp.asarray(coo), (n, n)).fill_cache(blocked=True)
    blk = jei.blocked
    jv = jnp.concatenate([jnp.asarray(vals),
                          jnp.full((1, h), -jnp.inf)])[
        jnp.minimum(blk.perm, e)]
    ref = np.asarray(jsegment_max_blocked(jv, (blk.dst, blk.chunk_base), n))
    tei = EdgeIndex(coo, (n, n), device='cpu').fill_cache(blocked=True)
    tv = torch.from_numpy(vals)[tei.blocked.perm.clamp(max=e - 1)]
    out = segment_max_blocked(tv.contiguous(), tei.blocked, n)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert np.isneginf(out.numpy()[coo[1][0]]).all()
    empty = np.setdiff1d(np.arange(n), coo[1])
    assert len(empty) and np.isneginf(out.numpy()[empty]).all()


def test_segment_max_output_rules():
    """Values below the sentinel clamp to it; a max at or below -3e38 is
    -inf; rows past the slots' end stay -inf; the layout's row count must
    match."""
    indptr = torch.tensor([0, 2, 2, 4], dtype=torch.int32)
    vals = torch.tensor([[1.0], [-5.0], [-3.1e38], [float('-inf')],
                         [7.0]])                      # the last slot: pad
    out = segment_max_plain(indptr, vals)
    assert out.flatten().tolist() == [1.0, float('-inf'), float('-inf')]

    class Layout:
        pass

    lay = Layout()
    lay.indptr = indptr
    assert torch.equal(segment_max_blocked(vals, lay, 3), out)
    with pytest.raises(ValueError, match='num_segments'):
        segment_max_blocked(vals, lay, 4)


# -- the narrow-row gather ----------------------------------------------------
@pytest.mark.parametrize('width', [1, 4, 16, 17])
def test_take_rows_equals_indexing(width):
    """Values and gradients equal ``x[idx]``'s, repeated indices included."""
    g = torch.Generator().manual_seed(width)
    x = torch.randn(50, width, generator=g, requires_grad=True)
    idx = torch.randint(0, 50, (400,), generator=g)
    c = torch.randn(400, width, generator=g)
    out = take_rows(x, idx)
    assert torch.equal(out, x[idx])
    (out * c).sum().backward()
    grad = x.grad.clone()
    x.grad = None
    (x[idx] * c).sum().backward()
    torch.testing.assert_close(grad, x.grad, rtol=1e-6, atol=1e-6)


# -- softmax and self loops ---------------------------------------------------
@pytest.mark.parametrize('padded', [False, True])
@pytest.mark.parametrize('masked', [False, True])
def test_softmax_matches_jax(masked, padded):
    """With ``padded``, some indices equal ``num_segments`` (the padding
    convention): JAX drops them from the segment max and sum and clamps the
    gathers (``n + 1`` segments under a mask)."""
    rng = np.random.default_rng(7)
    e, n = 2500, 300
    src = (rng.normal(size=(e, 4)) * 5).astype(np.float32)
    idx = rng.integers(0, n, e)
    if padded:
        idx[rng.random(e) < 0.1] = n
    mask = rng.random(e) < 0.6 if masked else None
    ref = jsoftmax(jnp.asarray(src), jnp.asarray(idx), n,
                   mask=None if mask is None else jnp.asarray(mask))
    out = softmax(torch.from_numpy(src), torch.from_numpy(idx), n,
                  mask=None if mask is None else torch.from_numpy(mask))
    assert np.isfinite(out.numpy()).all()
    _close(out, ref, what='softmax')
    if padded and not masked:
        small = softmax(torch.tensor([0.5, 1.0, 2.0, 0.3]),
                        torch.tensor([0, 0, 1, 2]), 2)
        _close(small, jsoftmax(jnp.asarray([0.5, 1.0, 2.0, 0.3]),
                               jnp.asarray([0, 0, 1, 2]), 2),
               what='softmax, one padded edge')


def test_add_self_loops_matches_jax():
    coo = np.array([[0, 1, 2, 2], [1, 2, 0, 2]], np.int32)
    w = np.array([0.5, 1.5, 2.5, 3.5], np.float32)
    jc, jw = jadd_self_loops(jnp.asarray(coo), jnp.asarray(w),
                             fill_value=2.0, num_nodes=4)
    tc, tw = add_self_loops(torch.from_numpy(coo), torch.from_numpy(w),
                            fill_value=2.0, num_nodes=4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    tc2, none = add_self_loops(EdgeIndex(coo, (3, 3), device='cpu'))
    assert none is None and tc2.shape == (2, 7)


# -- the convolutions ---------------------------------------------------------
CONV_CASES = [
    # (label, v2, conv kwargs, bipartite, edge_attr fill or None, fused)
    ('fused', False, {'heads': 3, 'add_self_loops': False}, False, None,
     True),
    ('self loops', False, {'heads': 3}, False, None, False),
    ('bipartite', False, {'heads': 2}, True, None, True),
    ('edge_attr mean', False, {'heads': 2}, False, 'mean', False),
    ('edge_attr 0.5', False, {'heads': 2, 'fill_value': 0.5}, False, 0.5,
     False),
    ('concat=False', False, {'heads': 3, 'concat': False,
                             'add_self_loops': False}, False, None, True),
    ('attention weights', False, {'heads': 2}, False, None, False),
    ('fused', True, {'heads': 3, 'add_self_loops': False}, False, None,
     True),
    ('self loops', True, {'heads': 3}, False, None, False),
    ('bipartite', True, {'heads': 2}, True, None, True),
    ('edge_attr mean', True, {'heads': 2}, False, 'mean', False),
    ('concat=False', True, {'heads': 2, 'concat': False,
                            'add_self_loops': False}, False, None, True),
    ('attention weights', True, {'heads': 2}, False, None, False),
]


@pytest.mark.parametrize('label,v2,kw,bipartite,fill,fused', CONV_CASES,
                         ids=[f"{'v2' if c[1] else 'v1'}-{c[0]}"
                              for c in CONV_CASES])
def test_conv_matches_jax(label, v2, kw, bipartite, fill, fused):
    n_src, n = (90, 120) if bipartite else (120, 120)
    coo, rng = _graph(n_src, n, 800, seed=len(label) + 10 * v2)
    # a few self loops in the input, which the self-loop branch replaces
    coo[:, :5] = coo[0, :5]
    x = rng.normal(size=(n_src, 10)).astype(np.float32)
    xd = rng.normal(size=(n, 7)).astype(np.float32)
    ea = rng.normal(size=(coo.shape[1], 5)).astype(np.float32)
    attn = label == 'attention weights'
    jei = JEdgeIndex(jnp.asarray(coo), (n_src, n)).fill_cache(blocked=True)
    jx = (jnp.asarray(x), jnp.asarray(xd)) if bipartite else jnp.asarray(x)
    jargs = {'edge_attr': jnp.asarray(ea)} if fill is not None else {}
    jconv = (JGATv2Conv if v2 else JGATConv)(out_channels=6, **kw)
    params = jax.jit(jconv.init)(jax.random.PRNGKey(0), jx, jei, **jargs)
    jout = jax.jit(partial(jconv.apply, return_attention_weights=attn))(
        params, jx, jei, **jargs)

    tei = EdgeIndex(coo, (n_src, n), device='cpu').fill_cache(blocked=True)
    cls = GATv2Conv if v2 else GATConv
    conv = cls((10, 7) if bipartite else 10, 6, **kw,
               edge_dim=5 if fill is not None else None, device='cpu')
    conv.load_state_dict(flax_to_state_dict(params))
    tx = ((torch.from_numpy(x), torch.from_numpy(xd)) if bipartite
          else torch.from_numpy(x))
    targs = {'edge_attr': torch.from_numpy(ea)} if fill is not None else {}
    before = gat_mix.launches
    with torch.no_grad():
        tout = conv(tx, tei, return_attention_weights=attn, **targs)
    assert gat_mix.launches == before
    if attn:
        (tout, (tcoo, talpha)), (jout, (jcoo, jalpha)) = tout, jout
        np.testing.assert_array_equal(tcoo.numpy(), np.asarray(jcoo))
        _close(talpha, jalpha, what='attention weights')
    _close(tout, jout, what=label)
    if fused:
        # the same conv on its plain branch agrees as well
        try:
            backend.use_kernel_spmm = False
            with torch.no_grad():
                plain = conv(tx, tei, **targs)
        finally:
            backend.use_kernel_spmm = True
        _close(plain, jout, what=f'{label}, plain branch')


@pytest.mark.parametrize('v2', [False, True])
def test_attention_dropout_fused_equals_plain(v2):
    """Numerator-only dropout on the fused branch equals dropout of the
    softmax weights on the plain branch for the same generator draws."""
    coo, rng = _graph(100, 100, 600, seed=3)
    ei = EdgeIndex(coo, (100, 100), device='cpu').fill_cache()
    conv = (GATv2Conv if v2 else GATConv)(8, 4, heads=2, dropout=0.4,
                                          add_self_loops=False,
                                          device='cpu')
    x = torch.from_numpy(rng.normal(size=(100, 8)).astype(np.float32))
    outs = []
    for kernel in (True, False):
        try:
            backend.use_kernel_spmm = kernel
            outs.append(conv(x, ei, deterministic=False,
                             generator=torch.Generator().manual_seed(5)))
        finally:
            backend.use_kernel_spmm = True
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(outs[0], conv(x, ei), atol=1e-3)


def test_flash_branch_raises_and_aliases(monkeypatch):
    """Past ``PGT_ATTN_WIDE_BYTES`` an unfused conv takes the flash scan
    (it raised before the scan was ported): the same output and gradients as
    its plain branch; the alias builds the slot orders."""
    coo, rng = _graph(60, 60, 300, seed=4)
    conv = GATConv(4, 4, heads=2, device='cpu')
    x = torch.from_numpy(rng.normal(size=(60, 4)).astype(np.float32))
    outs = []
    for cap in ('1', '1e18'):
        monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', cap)
        conv.zero_grad()
        out = conv(x, EdgeIndex(coo, (60, 60), device='cpu'))
        out.square().sum().backward()
        outs.append((out.detach(), [p.grad.clone()
                                    for p in conv.parameters()]))
    (flash, g_flash), (plain, g_plain) = outs
    _close(flash, plain)
    for a, b in zip(g_flash, g_plain):
        _close(a, b)
    ei = FusedGATConv.to_graph_format(torch.from_numpy(coo), (60, 60))
    assert ei.blocked is not None and ei.blocked_t is not None


# -- the destination projection, chosen by identity as the JAX package does ---
def _identity_case(seed):
    coo, rng = _graph(50, 50, 300, seed=seed)
    x = rng.normal(size=(50, 10)).astype(np.float32)
    xd = rng.normal(size=(50, 10)).astype(np.float32)
    return coo, x, xd


@pytest.mark.parametrize('call', ['one tensor', 'pair of one object'])
def test_pair_built_gatconv_shares_lin_src_like_jax(call):
    """A conv built with ``in_channels=(10, 10)`` and called with one tensor
    (or a pair whose members are the same object) shares ``lin_src``, as the
    JAX package's ``x_dst is x_src`` does: the JAX params hold no
    ``lin_dst``, they load with only ``lin_dst.weight`` left unset, and the
    output and gradients match; ``lin_dst`` stays out of the graph."""
    coo, x, _ = _identity_case(21)
    jx = jnp.asarray(x)
    jconv = JGATConv(out_channels=4, heads=2)
    params = jax.jit(jconv.init)(jax.random.PRNGKey(2), jx, jnp.asarray(coo))
    assert 'lin_dst' not in params['params']
    cot = np.random.default_rng(3).normal(size=(50, 8)).astype(np.float32)
    jgrad = jax.grad(lambda p: (jconv.apply(p, jx, jnp.asarray(coo))
                                * jnp.asarray(cot)).sum())(params)
    jout = jconv.apply(params, jx, jnp.asarray(coo))

    conv = GATConv((10, 10), 4, heads=2, device='cpu')
    missing, unexpected = conv.load_state_dict(flax_to_state_dict(params),
                                               strict=False)
    assert missing == ['lin_dst.weight'] and unexpected == []
    xt = torch.from_numpy(x)
    out = conv((xt, xt) if call == 'pair of one object' else xt,
               torch.from_numpy(coo))
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), jout, what=call)
    grads = flax_to_state_dict(jgrad)
    for k, prm in conv.named_parameters():
        if k == 'lin_dst.weight':
            assert prm.grad is None
        else:
            _close(prm.grad, grads[k], what=f'grad of {k}')


def test_int_built_gatconv_refuses_a_distinct_pair():
    """A distinct ``x_dst`` takes ``lin_dst`` in the JAX package; a conv
    built with an int ``in_channels`` has none and raises, naming
    ``in_channels=(src, dst)``, instead of returning another function's
    output. Built with the pair, the port loads the JAX params (``lin_dst``
    included) and matches them."""
    coo, x, xd = _identity_case(22)
    jconv = JGATConv(out_channels=4, heads=2)
    jx = (jnp.asarray(x), jnp.asarray(xd))
    params = jax.jit(jconv.init)(jax.random.PRNGKey(4), jx, jnp.asarray(coo))
    assert 'lin_dst' in params['params']
    jout = jax.jit(jconv.apply)(params, jx, jnp.asarray(coo))
    tx = (torch.from_numpy(x), torch.from_numpy(xd))
    with pytest.raises(ValueError, match=r'in_channels=\(src, dst\)'):
        GATConv(10, 4, heads=2, device='cpu')(tx, torch.from_numpy(coo))
    conv = GATConv((10, 10), 4, heads=2, device='cpu')
    conv.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        out = conv(tx, torch.from_numpy(coo))
    _close(out, jout, what='distinct pair')


def test_pair_built_gatconv_flash_branch_matches_jax(monkeypatch):
    """The same identity rule on the flash branch (``PGT_ATTN_WIDE_BYTES``
    lowered so that both packages take their flash scans; the port's runs
    its plain versions on the CPU): a pair-built conv called with one
    tensor, output and gradients against the JAX package's."""
    monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', '1')
    coo, x, _ = _identity_case(23)
    jx = jnp.asarray(x)
    jconv = JGATConv(out_channels=4, heads=2)
    params = jax.jit(jconv.init)(jax.random.PRNGKey(5), jx, jnp.asarray(coo))
    cot = np.random.default_rng(6).normal(size=(50, 8)).astype(np.float32)
    jgrad = jax.grad(lambda p: (jconv.apply(p, jx, jnp.asarray(coo))
                                * jnp.asarray(cot)).sum())(params)
    jout = jconv.apply(params, jx, jnp.asarray(coo))
    conv = GATConv((10, 10), 4, heads=2, device='cpu')
    conv.load_state_dict(flax_to_state_dict(params), strict=False)
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    calls = []
    plain = fs.flash_forward_plain
    monkeypatch.setattr(fs, 'flash_forward_plain',
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = conv(torch.from_numpy(x), torch.from_numpy(coo))
    assert calls, 'the conv did not take its flash branch'
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), jout, what='flash branch')
    grads = flax_to_state_dict(jgrad)
    for k, prm in conv.named_parameters():
        if k != 'lin_dst.weight':
            _close(prm.grad, grads[k], what=f'flash branch grad of {k}')


# -- the model ----------------------------------------------------------------
def test_gat_model_trains_like_jax():
    """GAT(16 -> 16 -> 16 -> 4, 2 heads) on the fused branch: the forward,
    first-step gradients and 3 Adam steps' losses against optax.adam(1e-2),
    from the same weights."""
    n = 300
    coo, rng = _graph(n, n, 2500, seed=11)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = rng.integers(0, 4, n)
    ckw = {'add_self_loops': False}
    jm = jmodels.GAT(hidden_channels=16, num_layers=3, out_channels=4,
                     heads=2, conv_kwargs=ckw)
    jei = JEdgeIndex(jnp.asarray(coo), (n, n)).fill_cache(blocked=True)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), xj, jei)
    tx = optax.adam(1e-2)

    def loss_fn(p):
        out = jm.apply(p, xj, jei)
        return optax.softmax_cross_entropy_with_integer_labels(
            out, yj).mean(), out

    @jax.jit
    def step(p, o):
        (loss, out), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        upd, o = tx.update(g, o)
        return optax.apply_updates(p, upd), o, loss, g, out

    p, o = params, tx.init(params)
    jlosses = []
    for i in range(3):
        p, o, loss, g, out = step(p, o)
        jlosses.append(float(loss))
        if i == 0:
            jgrads, jout = flax_to_state_dict(g), out

    tm = models.GAT(16, 16, 3, 4, heads=2, conv_kwargs=ckw, device='cpu')
    tm.load_state_dict(flax_to_state_dict(params))
    tei = EdgeIndex(coo, (n, n), device='cpu').fill_cache(blocked=True)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tlosses = []
    for i in range(3):
        opt.zero_grad(set_to_none=True)
        out = tm(xt, tei)
        loss = F.cross_entropy(out, yt)
        loss.backward()
        if i == 0:
            _close(out.detach(), jout, what='forward')
            assert sorted(jgrads) == sorted(
                k for k, _ in tm.named_parameters())
            for k, prm in tm.named_parameters():
                _close(prm.grad, jgrads[k], what=f'first-step grad of {k}')
        opt.step()
        tlosses.append(loss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)
    assert tlosses[-1] < tlosses[0]


def test_gatv2_model_forward_matches_jax():
    n = 120
    coo, rng = _graph(n, n, 800, seed=12)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    jm = jmodels.GAT(hidden_channels=12, num_layers=2, out_channels=3,
                     heads=3, v2=True)
    jei = JEdgeIndex(jnp.asarray(coo), (n, n)).fill_cache(blocked=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x), jei)
    tm = models.GAT(8, 12, 2, 3, heads=3, v2=True, device='cpu')
    tm.load_state_dict(flax_to_state_dict(params))
    tei = EdgeIndex(coo, (n, n), device='cpu').fill_cache(blocked=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), tei)
    _close(out, jax.jit(jm.apply)(params, jnp.asarray(x), jei),
           what='GATv2 model')
