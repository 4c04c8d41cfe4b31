"""The port's typed products, typed linears, relational convs, HeteroConv
and the to_hetero transforms against the JAX package's, on the CPU.

Every port module is built from the JAX module's initialised parameters
(``convert.flax_to_state_dict``, strict names), never from its own
initialisation; the same seeded numpy inputs go through both. Outputs, the
gradients of every parameter and of the inputs under ``sum(out * c)`` (``c``
a fixed random cotangent) are compared in float32 with ``rtol=1e-4`` and
``atol=1e-5``: the same sums and products in another order.

Covered: ``typed_matmul`` on its three arms (dense einsum, sort-and-batch,
ragged) and ``grouped_matmul``; ``Linear``, ``HeteroLinear`` (each arm) and
``HeteroDictLinear``; ``RGCNConv`` in its three weight forms, with and
without a typed layout, with ``edge_mask``, 'mean' and 'sum', bipartite
input, and ``FastRGCNConv``; ``HeteroConv`` with every ``aggr``;
``to_hetero`` over GraphSAGE on raw COOs and on the loader's
``EdgeIndex`` es (the kernel route's CPU twin), and
``to_hetero_with_bases``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.nn import FastRGCNConv as JFastRGCN
from pytorch_geometric_tpu.nn import HeteroConv as JHeteroConv
from pytorch_geometric_tpu.nn import RGCNConv as JRGCN
from pytorch_geometric_tpu.nn import SAGEConv as JSAGE
from pytorch_geometric_tpu.nn import to_hetero as j_to_hetero
from pytorch_geometric_tpu.nn.dense import HeteroDictLinear as JDictLinear
from pytorch_geometric_tpu.nn.dense import HeteroLinear as JHeteroLinear
from pytorch_geometric_tpu.nn.dense import Linear as JLinear
from pytorch_geometric_tpu.nn.to_hetero import \
    to_hetero_with_bases as j_with_bases
from pytorch_geometric_tpu.ops import grouped as jg
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import (FastRGCNConv, HeteroConv,
                                            HeteroDictLinear, HeteroLinear,
                                            Linear, RGCNConv, SAGEConv,
                                            to_hetero, to_hetero_with_bases)
from pytorch_geometric_tpu_torch.ops import grouped as tg

RTOL, ATOL = 1e-4, 1e-5


def _close(got, ref, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, err_msg=what)


def _cot(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check_grads(module, jgrads):
    ref = flax_to_state_dict(jgrads)
    names = sorted(k for k, _ in module.named_parameters())
    assert names == sorted(ref), (names, sorted(ref))
    for k, p in module.named_parameters():
        _close(p.grad, ref[k], f'grad of {k}')


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


# -- typed products ------------------------------------------------------------
@pytest.mark.parametrize('arm', ['dense', 'typed', 'ragged'])
def test_typed_matmul(arm):
    rng = np.random.default_rng(0)
    types = rng.integers(0, 4, 37)
    types[types == 2] = 3                       # one empty type
    x = rng.standard_normal((37, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12, 9)).astype(np.float32)
    jl = tl = None
    if arm == 'typed':
        jl, tl = jg.build_typed_layout(types, 4), tg.build_typed_layout(
            types, 4, device='cpu')
    elif arm == 'ragged':
        jl, tl = jg.build_ragged_layout(types, 4), tg.build_ragged_layout(
            types, 4, device='cpu')
    jt = jnp.asarray(types.astype(np.int32))
    c = _cot((37, 9), 1)

    def jf(x, w):
        return jg.typed_matmul(x, jt, w, jl)

    jout = jf(x, w)
    jgx, jgw = jax.grad(lambda x, w: (jf(x, w) * c).sum(), (0, 1))(x, w)
    tx, tw = _t(x, True), _t(w, True)
    tout = tg.typed_matmul(tx, torch.from_numpy(types.astype(np.int32)), tw,
                           tl)
    (tout * _t(c)).sum().backward()
    _close(tout, jout, 'out')
    _close(tx.grad, jgx, 'grad x')
    _close(tw.grad, jgw, 'grad w')
    # every arm computes x[i] @ w[types[i]]
    _close(tout, np.einsum('nf,nfc->nc', x, w[types]), 'against numpy')


def test_grouped_matmul():
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((n, 5)).astype(np.float32) for n in (3, 0, 7)]
    ws = [rng.standard_normal((5, 4)).astype(np.float32) for _ in xs]
    ref = jg.grouped_matmul(xs, ws)
    got = tg.grouped_matmul([_t(x) for x in xs], [_t(w) for w in ws])
    for g, r in zip(got, ref):
        _close(g, r)


# -- typed linears -------------------------------------------------------------
@pytest.mark.parametrize('arm', ['dense', 'typed', 'ragged', 'no_bias'])
def test_hetero_linear(arm):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((23, 6)).astype(np.float32)
    types = rng.integers(0, 3, 23)
    jt = jnp.asarray(types.astype(np.int32))
    tt = torch.from_numpy(types.astype(np.int32))
    jl = tl = None
    if arm == 'typed':
        jl, tl = jg.build_typed_layout(types, 3), tg.build_typed_layout(
            types, 3, device='cpu')
    elif arm == 'ragged':
        jl, tl = jg.build_ragged_layout(types, 3), tg.build_ragged_layout(
            types, 3, device='cpu')
    bias = arm != 'no_bias'
    jm = JHeteroLinear(out_channels=5, num_types=3, use_bias=bias)
    params = jm.init(jax.random.PRNGKey(0), x, jt)
    tm = HeteroLinear(6, 5, 3, use_bias=bias, device='cpu')
    tm.load_state_dict(flax_to_state_dict(params))
    c = _cot((23, 5), 3)
    jout = jm.apply(params, x, jt, jl)
    jgp, jgx = jax.grad(lambda p, x: (jm.apply(p, x, jt, jl) * c).sum(),
                        (0, 1))(params, x)
    tx = _t(x, True)
    tout = tm(tx, tt, tl)
    (tout * _t(c)).sum().backward()
    _close(tout, jout, 'out')
    _close(tx.grad, jgx, 'grad x')
    _check_grads(tm, jgp)


@pytest.mark.parametrize('init', ['glorot', 'kaiming'])
def test_linear_and_hetero_dict_linear(init):
    rng = np.random.default_rng(3)
    xd = {'a': rng.standard_normal((9, 6)).astype(np.float32),
          'b': rng.standard_normal((4, 3)).astype(np.float32)}
    jm = JDictLinear(out_channels=5)
    params = jm.init(jax.random.PRNGKey(0), xd)
    tm = HeteroDictLinear({'a': 6, 'b': 3}, 5, device='cpu')
    tm.load_state_dict(flax_to_state_dict(params))
    cs = {t: _cot((len(v), 5), i) for i, (t, v) in enumerate(xd.items())}
    jout = jm.apply(params, xd)
    jgp = jax.grad(lambda p: sum((v * cs[t]).sum() for t, v in
                                 jm.apply(p, xd).items()))(params)
    tout = tm({t: _t(v) for t, v in xd.items()})
    sum((v * _t(cs[t])).sum() for t, v in tout.items()).backward()
    for t in xd:
        _close(tout[t], jout[t], t)
    _check_grads(tm, jgp)

    jlin = JLinear(out_channels=7, weight_initializer=init)
    params = jlin.init(jax.random.PRNGKey(1), xd['a'])
    tlin = Linear(6, 7, weight_initializer=init, device='cpu')
    tlin.load_state_dict(flax_to_state_dict(params))
    _close(tlin(_t(xd['a'])), jlin.apply(params, xd['a']), 'Linear')


# -- relational convs ----------------------------------------------------------
def _rel_graph(seed, n_src=14, n_dst=11, e=60, r=3, pad=4):
    """A bipartite relational graph with ``pad`` padded edges (both
    endpoints at the counts) and a mask that drops them."""
    rng = np.random.default_rng(seed)
    coo = np.stack([rng.integers(0, n_src, e), rng.integers(0, n_dst, e)])
    coo = np.concatenate([coo, [[n_src] * pad, [n_dst] * pad]], 1)
    et = rng.integers(0, r, e + pad)
    mask = np.arange(e + pad) < e
    xs = rng.standard_normal((n_src, 8)).astype(np.float32)
    xd = rng.standard_normal((n_dst, 8)).astype(np.float32)
    return coo.astype(np.int32), et.astype(np.int32), mask, xs, xd


RGCN_CASES = {
    'weight': {},
    'bases': {'num_bases': 2},
    'blocks': {'num_blocks': 4},
    'weight_layout': {'layout': 'ragged'},
    'bases_layout': {'num_bases': 2, 'layout': 'typed'},
    'sum_no_root': {'aggr': 'sum', 'root_weight': False, 'use_bias': False},
    'fast': {'fast': True},
    'fast_square': {'fast': True, 'square': True},
}


@pytest.mark.parametrize('case', sorted(RGCN_CASES))
def test_rgcn_conv(case):
    kw = dict(RGCN_CASES[case])
    fast = kw.pop('fast', False)
    square = kw.pop('square', False)
    layout = kw.pop('layout', None)
    coo, et, mask, xs, xd = _rel_graph(4)
    if square:
        n = 14
        coo = np.where(coo == 11, n, coo)       # pads at the square count
        xd = None
    jcls, tcls = (JFastRGCN, FastRGCNConv) if fast else (JRGCN, RGCNConv)
    jl = tl = None
    if layout == 'ragged':
        jl = jg.build_ragged_layout(et, 3)
        tl = tg.build_ragged_layout(et, 3, device='cpu')
    elif layout == 'typed':
        jl = jg.build_typed_layout(et, 3)
        tl = tg.build_typed_layout(et, 3, device='cpu')
    jm = jcls(out_channels=8, num_relations=3, **kw)
    jx = xs if square else (xs, xd)
    params = jm.init(jax.random.PRNGKey(0), jx, coo, et, edge_mask=mask,
                     typed_layout=jl)
    tm = tcls(8 if square else (8, 8), 8, num_relations=3, device='cpu',
              **kw)
    tm.load_state_dict(flax_to_state_dict(params))
    c = _cot((xs.shape[0] if square else xd.shape[0], 8), 5)

    def jf(p, x):
        return jm.apply(p, x, coo, et, edge_mask=mask, typed_layout=jl)

    jout = jf(params, jx)
    jgp, jgx = jax.grad(lambda p, x: (jf(p, x) * c).sum(), (0, 1))(params,
                                                                  jx)
    txs = _t(xs, True)
    tx = txs if square else (txs, _t(xd, True))
    tout = tm(tx, torch.from_numpy(coo), torch.from_numpy(et),
              edge_mask=torch.from_numpy(mask), typed_layout=tl)
    (tout * _t(c)).sum().backward()
    _close(tout, jout, 'out')
    _check_grads(tm, jgp)
    if square:
        _close(txs.grad, jgx, 'grad x')
    else:
        _close(txs.grad, jgx[0], 'grad x_src')
        if tx[1].grad is None:      # no root weight: x_dst is unused
            np.testing.assert_array_equal(np.asarray(jgx[1]), 0)
        else:
            _close(tx[1].grad, jgx[1], 'grad x_dst')


def test_rgcn_clamps_without_a_mask():
    """Without ``edge_mask`` a padded edge's endpoints are clamped to the
    last rows and its relation to the last relation, as in the JAX
    package (``rgcn_conv.py:66-68``)."""
    coo, et, _, xs, xd = _rel_graph(6)
    et = et.copy()
    et[:3] = 7                                  # past the last relation
    jm = JRGCN(out_channels=4, num_relations=3)
    params = jm.init(jax.random.PRNGKey(2), (xs, xd), coo, et)
    tm = RGCNConv((8, 8), 4, num_relations=3, device='cpu')
    tm.load_state_dict(flax_to_state_dict(params))
    _close(tm((_t(xs), _t(xd)), torch.from_numpy(coo), torch.from_numpy(et)),
           jm.apply(params, (xs, xd), coo, et))


# -- HeteroConv and to_hetero -------------------------------------------------
META = (('paper', 'author'),
        (('paper', 'cites', 'paper'), ('author', 'writes', 'paper'),
         ('paper', 'rev_writes', 'author')))


def _hetero_inputs(seed, n_p=13, n_a=9, f=16):
    rng = np.random.default_rng(seed)
    x = {'paper': rng.standard_normal((n_p, f)).astype(np.float32),
         'author': rng.standard_normal((n_a, f)).astype(np.float32)}
    w = np.stack([rng.integers(0, n_a, 40), rng.integers(0, n_p, 40)])
    ei = {META[1][0]: rng.integers(0, n_p, (2, 35)).astype(np.int32),
          META[1][1]: w.astype(np.int32),
          META[1][2]: w[::-1].astype(np.int32)}
    return x, ei


def _run_dict(jm, params, tm, x, ei, t_ei=None, seed=7, **kw):
    """Outputs, parameter gradients and input gradients of a dict module
    pair under ``sum_t sum(out[t] * c[t])``."""
    tm.load_state_dict(flax_to_state_dict(params))
    jout = jm.apply(params, x, ei, **kw)
    cs = {t: _cot(v.shape, seed + i) for i, (t, v) in
          enumerate(sorted(jout.items()))}

    def loss(p, x):
        return sum((v * cs[t]).sum() for t, v in jm.apply(p, x, ei,
                                                          **kw).items())

    jgp, jgx = jax.grad(loss, (0, 1))(params, x)
    tx = {t: _t(v, True) for t, v in x.items()}
    t_ei = t_ei or {k: torch.from_numpy(np.asarray(v)) for k, v in
                    ei.items()}
    tout = tm(tx, t_ei)
    assert sorted(tout) == sorted(jout)
    sum((v * _t(cs[t])).sum() for t, v in tout.items()).backward()
    for t in jout:
        _close(tout[t], jout[t], f'out {t}')
    _check_grads(tm, jgp)
    for t in x:
        if tx[t].grad is None:
            np.testing.assert_array_equal(np.asarray(jgx[t]), 0)
        else:
            _close(tx[t].grad, jgx[t], f'grad x {t}')


@pytest.mark.parametrize('aggr', ['sum', 'add', 'mean', 'max', 'min', 'cat'])
def test_hetero_conv(aggr):
    x, ei = _hetero_inputs(1)
    jm = JHeteroConv(convs={et: JSAGE(out_channels=12) for et in META[1]},
                     aggr=aggr)
    params = jm.init(jax.random.PRNGKey(0), x, ei)
    tm = HeteroConv({et: SAGEConv(16, 12, device='cpu') for et in META[1]},
                    aggr=aggr)
    _run_dict(jm, params, tm, x, ei)


def test_hetero_conv_skips_missing_relations_and_types():
    x, ei = _hetero_inputs(2)
    jm = JHeteroConv(convs={et: JSAGE(out_channels=12) for et in META[1]})
    params = jm.init(jax.random.PRNGKey(0), x, ei)
    tm = HeteroConv({et: SAGEConv(16, 12, device='cpu') for et in META[1]})
    tm.load_state_dict(flax_to_state_dict(params))
    part = {META[1][0]: ei[META[1][0]]}
    tout = tm({t: _t(v) for t, v in x.items()},
              {k: torch.from_numpy(v) for k, v in part.items()})
    jout = jm.apply(params, x, part)
    assert sorted(tout) == sorted(jout) == ['paper']
    _close(tout['paper'], jout['paper'])
    with pytest.raises(ValueError, match='aggr'):
        HeteroConv({}, aggr='prod')


@pytest.mark.parametrize('route', ['coo', 'edge_index'])
def test_to_hetero(route):
    """A GraphSAGE stack (SAGE -> ReLU -> SAGE) per edge type; on the
    ``edge_index`` route each relation is an ``EdgeIndex`` with its CSC,
    so every mean takes the segment-sum kernel's route (its plain version
    here), forward and backward."""
    x, ei = _hetero_inputs(3)
    jm = j_to_hetero([JSAGE(out_channels=16), jax.nn.relu,
                      JSAGE(out_channels=16)], META)
    params = jm.init(jax.random.PRNGKey(0), x, ei)
    tm = to_hetero([SAGEConv(16, 16, device='cpu'), torch.relu,
                    SAGEConv(16, 16, device='cpu')], META)
    t_ei = None
    if route == 'edge_index':
        n = {t: v.shape[0] for t, v in x.items()}
        t_ei = {et: EdgeIndex(v, (n[et[0]], n[et[2]]),
                              device='cpu').fill_cache(blocked=False)
                for et, v in ei.items()}
    _run_dict(jm, params, tm, x, ei, t_ei)


def test_to_hetero_with_bases():
    x, ei = _hetero_inputs(4)
    jm = j_with_bases(JSAGE(out_channels=8), META, num_bases=3)
    params = jm.init(jax.random.PRNGKey(0), x, ei)
    tm = to_hetero_with_bases(SAGEConv(16, 8, device='cpu'), META, 3)
    _run_dict(jm, params, tm, x, ei)
