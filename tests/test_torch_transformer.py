"""TransformerConv and SuperGATConv through the PyTorch port against the JAX
package, from the same (converted flax) weights and numpy inputs: every
branch of TransformerConv (fused over the slot orders, the wide union
attention without them, the explicit softmax with ``edge_attr`` or attention
weights), with ``beta``, ``concat=False``, bipartite input, ``edge_mask``
and no root weight; SuperGATConv's MX and SD forms with and without self
loops and ``concat=False``; and a 3-layer TransformerConv stack trained 5
Adam steps against optax.

The JAX side takes its fused branches only under ``_use_pallas()``, so every
test sets ``PGT_FORCE_PALLAS=1`` and the JAX Pallas kernels run in interpret
mode; the port runs its kernels' plain versions through the same wrappers
and autograd Functions that serve the card. Graphs carry padded edges (both
endpoints at the node count).

Tolerances: outputs, gradients and losses 1e-4 relative to the reference's
largest magnitude (float32 sums and matmuls in another order), as
``tests/test_torch_gat.py``; the key bias's gradient, which the softmax
cancels exactly (it shifts every score of a destination alike) and is
rounding noise in both packages, 1e-4 of the conv's largest gradient."""

from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.nn.conv import SuperGATConv as JSuperGATConv
from pytorch_geometric_tpu.nn.conv import TransformerConv as JTransformerConv
from pytorch_geometric_tpu_torch import EdgeIndex, backend
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn.conv import SuperGATConv, TransformerConv
from pytorch_geometric_tpu_torch.nn.conv import transformer_conv as tc_module
from pytorch_geometric_tpu_torch.nn.conv import supergat_conv as sg_module

TOL = 1e-4


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv('PGT_FORCE_PALLAS', '1')


def _close(got, ref, tol=TOL, what=''):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _graph(n_src, n_dst, e, seed, n_pad=5):
    """Random COO onto three quarters of the destinations, plus ``n_pad``
    padded edges and a few self loops."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(n_dst, 3 * n_dst // 4, replace=False)
    coo = np.stack([rng.integers(0, n_src, e),
                    rows[rng.integers(0, len(rows), e)]])
    coo[:, :4] = min(n_src, n_dst) // 2
    pad = np.stack([np.full(n_pad, n_src), np.full(n_pad, n_dst)])
    return np.concatenate([coo, pad], 1).astype(np.int32), rng


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)


def _check_grads(module, grads, what='grad'):
    """Every parameter's gradient against the JAX package's."""
    assert sorted(grads) == sorted(k for k, _ in module.named_parameters())
    largest = max(float(g.abs().max()) for g in grads.values())
    for k, p in module.named_parameters():
        if k.endswith('lin_key.bias'):
            # the softmax cancels a shift of every score of a destination,
            # so this gradient is 0 but for rounding in both packages: held
            # to 1e-4 of the largest gradient
            assert float((p.grad - grads[k]).abs().max()) <= TOL * largest, k
            continue
        _close(p.grad, grads[k], what=f'{what} of {k}')


def _run_pair(jconv, conv, jx, tx, jei, tei, jkw, tkw, attn=False):
    """Both convs from the flax weights: outputs and the gradients of every
    parameter and of x under the loss ``sum(out * c)``."""
    params = jax.jit(jconv.init)(jax.random.PRNGKey(0), jx, jei, **jkw)
    conv.load_state_dict(flax_to_state_dict(params))

    def jfwd(p, x):
        return jconv.apply(p, x, jei, return_attention_weights=attn, **jkw) \
            if attn else jconv.apply(p, x, jei, **jkw)

    jres = jfwd(params, jx)
    jout = jres[0] if attn else jres
    c = np.random.default_rng(99).standard_normal(jout.shape).astype(
        np.float32)
    jgp, jgx = jax.grad(lambda p, x: ((jfwd(p, x)[0] if attn else jfwd(
        p, x)) * c).sum(), argnums=(0, 1))(params, jx)
    xs = tx if isinstance(tx, tuple) else (tx,)
    for t in xs:
        t.requires_grad_()
    tres = conv(tx, tei, return_attention_weights=attn, **tkw) if attn \
        else conv(tx, tei, **tkw)
    tout = tres[0] if attn else tres
    (tout * torch.from_numpy(c)).sum().backward()
    _close(tout, jout, what='output')
    _check_grads(conv, flax_to_state_dict(jgp))
    jgx = jgx if isinstance(jgx, tuple) else (jgx,)
    for t, g in zip(xs, jgx):
        _close(t.grad, g, what='grad x')
    return tres, jres


# -- TransformerConv ----------------------------------------------------------
TC_CASES = [
    # (label, conv kwargs, bipartite, cached, edge_attr, weights, mask,
    #  branch)
    ('fused', {'heads': 3}, False, True, False, False, False, 'fused'),
    ('fused beta', {'heads': 2, 'beta': True}, False, True, False, False,
     False, 'fused'),
    ('fused concat=False', {'heads': 3, 'concat': False}, False, True,
     False, False, False, 'fused'),
    ('fused bipartite mask', {'heads': 2}, True, True, False, False, True,
     'fused'),
    ('fused no root', {'heads': 2, 'root_weight': False}, False, True,
     False, False, False, 'fused'),
    ('wide', {'heads': 3}, False, False, False, False, False, 'wide'),
    ('wide beta mask', {'heads': 2, 'beta': True}, False, False, False,
     False, True, 'wide'),
    ('wide bipartite concat=False', {'heads': 2, 'concat': False}, True,
     False, False, False, False, 'wide'),
    ('explicit edge_attr', {'heads': 2, 'edge_dim': 5}, False, True, True,
     False, False, 'explicit'),
    ('explicit edge_attr mask beta', {'heads': 2, 'edge_dim': 5,
                                      'beta': True}, True, False, True,
     False, True, 'explicit'),
    ('attention weights', {'heads': 2}, False, True, False, True, False,
     'explicit'),
]


@pytest.mark.parametrize('label,kw,bipartite,cached,ea,attn,masked,branch',
                         TC_CASES, ids=[c[0] for c in TC_CASES])
def test_transformer_conv_matches_jax(label, kw, bipartite, cached, ea,
                                      attn, masked, branch, monkeypatch):
    n_src, n = (80, 100) if bipartite else (100, 100)
    coo, rng = _graph(n_src, n, 700, seed=len(label))
    e = coo.shape[1]
    x = rng.normal(size=(n_src, 10)).astype(np.float32)
    xd = rng.normal(size=(n, 7)).astype(np.float32)
    eattr = rng.normal(size=(e, 5)).astype(np.float32)
    mask = rng.random(e) < 0.8
    jei = JEdgeIndex(jnp.asarray(coo), (n_src, n))
    tei = EdgeIndex(coo, (n_src, n), device='cpu')
    if cached:
        jei, tei = jei.fill_cache(blocked=True), tei.fill_cache(blocked=True)
    jx = (jnp.asarray(x), jnp.asarray(xd)) if bipartite else jnp.asarray(x)
    tx = ((torch.from_numpy(x), torch.from_numpy(xd)) if bipartite
          else torch.from_numpy(x))
    jkw, tkw = {}, {}
    if ea:
        jkw['edge_attr'], tkw['edge_attr'] = jnp.asarray(eattr), \
            torch.from_numpy(eattr)
    if masked:
        jkw['edge_mask'], tkw['edge_mask'] = jnp.asarray(mask), \
            torch.from_numpy(mask)
    calls = []
    for name in ('gat_aggregate', 'hetero_edge_attention_multi',
                 'gathered_dot'):
        _spy(monkeypatch, tc_module, name, calls)
    jconv = JTransformerConv(out_channels=6, **kw)
    conv = TransformerConv((10, 7) if bipartite else 10, 6, **kw,
                           device='cpu')
    tres, jres = _run_pair(jconv, conv, jx, tx, jei, tei, jkw, tkw, attn)
    want = {'fused': 'gat_aggregate', 'wide': 'hetero_edge_attention_multi',
            'explicit': 'gathered_dot'}[branch]
    assert calls and set(calls) == {want}, calls
    if attn:
        (_, (tcoo, talpha)), (_, (jcoo, jalpha)) = tres, jres
        np.testing.assert_array_equal(tcoo.numpy(), np.asarray(jcoo))
        _close(talpha, jalpha, what='attention weights')


def test_transformer_conv_kernel_knob_and_wide_cap(monkeypatch):
    """With ``backend.use_kernel_spmm`` off, the CPU takes the wide branch
    over the cached slot orders and agrees with the fused one; past
    ``PGT_ATTN_WIDE_BYTES`` the uncached conv would take the JAX package's
    flash scan, which raises; ``dropout`` is taken and never applied."""
    coo, rng = _graph(100, 100, 700, seed=3)
    x = torch.from_numpy(rng.normal(size=(100, 10)).astype(np.float32))
    ei = EdgeIndex(coo, (100, 100), device='cpu').fill_cache(blocked=True)
    conv = TransformerConv(10, 6, heads=2, beta=True, dropout=0.5,
                           device='cpu',
                           generator=torch.Generator().manual_seed(0))
    fused = conv(x, ei)
    calls = []
    _spy(monkeypatch, tc_module, 'hetero_edge_attention_multi', calls)
    monkeypatch.setattr(backend, 'use_kernel_spmm', False)
    wide = conv(x, ei)
    assert calls == ['hetero_edge_attention_multi']
    _close(wide, fused.detach().numpy(), what='wide vs fused')
    monkeypatch.setattr(backend, 'use_kernel_spmm', True)
    monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', '1000')
    with pytest.raises(NotImplementedError, match='Queue 1, item 7'):
        conv(x, EdgeIndex(coo, (100, 100), device='cpu'))
    assert torch.equal(conv(x, ei), fused)       # the fused branch is capless


# -- SuperGATConv -------------------------------------------------------------
SG_CASES = [(att, loops, cached, concat)
            for att in ('MX', 'SD')
            for loops, cached in ((True, True), (False, True), (False, False))
            for concat in (True, False)
            if concat or (loops and cached)]


@pytest.mark.parametrize('att,loops,cached,concat', SG_CASES,
                         ids=[f'{a}-loops{l}-cache{c}-concat{k}'
                              for a, l, c, k in SG_CASES])
def test_supergat_conv_matches_jax(att, loops, cached, concat, monkeypatch):
    coo, rng = _graph(90, 90, 600, seed=7 + len(att) + 2 * loops)
    x = rng.normal(size=(90, 12)).astype(np.float32)
    jei = JEdgeIndex(jnp.asarray(coo), (90, 90))
    tei = EdgeIndex(coo, (90, 90), device='cpu')
    if cached:
        jei, tei = jei.fill_cache(blocked=True), tei.fill_cache(blocked=True)
    kw = dict(heads=3, concat=concat, add_self_loops=loops,
              attention_type=att)
    calls = []
    for name in ('gat_aggregate', 'sddmm', 'gathered_dot'):
        _spy(monkeypatch, sg_module, name, calls)
    _run_pair(JSuperGATConv(out_channels=5, **kw),
              SuperGATConv(12, 5, **kw, device='cpu'), jnp.asarray(x),
              torch.from_numpy(x), jei, tei, {}, {})
    fused = cached and not loops
    assert set(calls) == ({'sddmm', 'gat_aggregate'} if fused
                          else {'gathered_dot'}), calls


# -- a 3-layer stack, trained -------------------------------------------------
STACK = ((8, 2, True), (8, 2, True), (4, 2, False))   # (C, H, concat)


class _JStack(fnn.Module):
    @fnn.compact
    def __call__(self, x, ei):
        for i, (c, h, concat) in enumerate(STACK):
            x = JTransformerConv(c, heads=h, concat=concat, beta=True,
                                 name=f'conv_{i}')(x, ei)
            if i < len(STACK) - 1:
                x = jax.nn.relu(x)
        return x


class _TStack(torch.nn.Module):
    def __init__(self, f_in):
        super().__init__()
        convs, width = [], f_in
        for c, h, concat in STACK:
            convs.append(TransformerConv(width, c, heads=h, concat=concat,
                                         beta=True, device='cpu'))
            width = c * h if concat else c
        self.convs = torch.nn.ModuleList(convs)

    def forward(self, x, ei):
        for i, conv in enumerate(self.convs):
            x = conv(x, ei)
            if i < len(self.convs) - 1:
                x = F.relu(x)
        return x


def test_transformer_stack_trains_like_jax():
    """3 TransformerConv layers (beta, ReLU between, the last
    ``concat=False``) on the fused branch: the forward, first-step
    gradients and 5 Adam steps' losses against optax.adam(1e-2)."""
    n = 200
    coo, rng = _graph(n, n, 1600, seed=11)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    y = rng.integers(0, 4, n)
    jm = _JStack()
    jei = JEdgeIndex(jnp.asarray(coo), (n, n)).fill_cache(blocked=True)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), xj, jei)
    tx = optax.adam(1e-2)

    def loss_fn(p):
        out = jm.apply(p, xj, jei)
        return optax.softmax_cross_entropy_with_integer_labels(
            out, yj).mean(), out

    @partial(jax.jit)
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

    tm = _TStack(12)
    tm.load_state_dict(flax_to_state_dict(params))
    tei = EdgeIndex(coo, (n, n), device='cpu').fill_cache(blocked=True)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tlosses = []
    for i in range(5):
        opt.zero_grad(set_to_none=True)
        out = tm(xt, tei)
        loss = F.cross_entropy(out, yt)
        loss.backward()
        if i == 0:
            _close(out, jout, what='forward')
            _check_grads(tm, jgrads, 'first-step grad')
        opt.step()
        tlosses.append(loss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)
    assert tlosses[-1] < tlosses[0]
