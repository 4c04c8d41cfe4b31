"""The port's ``nn/conv/misc_conv.py`` against the JAX package's, on the
CPU, at small widths: SignedConv (first and deeper layers), DirGNNConv
around GCNConv and ResGatedGraphConv (their copies without self loops and
root weight; alpha on the reversed pass), AntiSymmetricConv with its
default GCNConv phi (also on a cached ``EdgeIndex``), HypergraphConv
(weights, masked incidences), WLConv (colours, the map kept across calls,
histograms), MeshCNNConv (both ring layouts), SimpleConv (each
aggregation and root combination), GCN2Conv (shared and separate weights,
the derived beta) and PointGNNConv; each on a raw COO, a raw COO with
padded edges at the sentinel and an edge mask, and an ``EdgeIndex``, with
edge weights where the conv takes them; DirGNNConv's ``conv_in`` /
``conv_out`` through ``convert.py``; and three Adam steps of a 3-layer
GCN2Conv stack against flax and optax.

Tolerances: outputs within 1e-5 * max(1, max|ref|), gradients within 1e-4
of each gradient's largest entry (``_torch_parity``); the stack's losses
within 1e-5 relative each step and its parameters after the steps within
1e-5 * max(1, max|p|) of optax's."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (close, compare, edge_variant, graph,
                           init_variables, t)
from pytorch_geometric_tpu.nn import conv as jconv
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import conv
from pytorch_geometric_tpu_torch.nn.inits import linear

N, E, F, PAD, C = 26, 90, 12, 4, 8
X, COO, MASK, W = graph(1, N, E, F, PAD)
CPU = dict(device='cpu')
VARIANTS = ['coo', 'coo mask', 'EdgeIndex']


def _edges(variant, weighted=False, **kw):
    return edge_variant(variant, COO, MASK, W, N, E, weighted, **kw)


def _kw(kw):
    return ({k: jnp.asarray(v) for k, v in kw.items()},
            {k: t(v) for k, v in kw.items()})


def _run(jm, tm, variant, weighted=False, x=X, pre=(), post=(),
         cached=False):
    je, te, kw = _edges(variant, weighted, cached=cached)
    jkw, tkw = _kw(kw)
    compare(jm, tm, x, tuple(jnp.asarray(a) for a in pre) + (je,)
            + tuple(jnp.asarray(a) for a in post),
            tuple(t(a) for a in pre) + (te,) + tuple(t(a) for a in post),
            jkw=jkw, tkw=tkw)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('first', [True, False])
def test_signed_conv_matches_jax(first, variant):
    """Positive edges are the graph's, negative ones another draw."""
    _, neg, neg_mask, _ = graph(2, N, E // 2, F, PAD)
    je, te, kw = _edges(variant, mask_name='pos_mask')
    jn, tn = jnp.asarray(neg), t(neg)
    if variant == 'coo mask':
        kw['neg_mask'] = neg_mask
    else:
        jn, tn = jnp.asarray(neg[:, :E // 2]), t(neg[:, :E // 2])
    jkw, tkw = _kw(kw)
    x = X if first else np.concatenate([X, X[::-1]], 1)
    compare(jconv.SignedConv(out_channels=C, first_aggr=first),
            conv.SignedConv(F, C, first_aggr=first, **CPU), x, (je, jn),
            (te, tn), jkw=jkw, tkw=tkw)


DIR_CONVS = [
    ('GCNConv', lambda: jconv.GCNConv(out_channels=C),
     lambda: conv.GCNConv(F, C, **CPU)),
    ('ResGatedGraphConv', lambda: jconv.ResGatedGraphConv(out_channels=C),
     lambda: conv.ResGatedGraphConv(F, C, **CPU))]


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('root', [True, False])
@pytest.mark.parametrize('name,jbuild,tbuild', DIR_CONVS,
                         ids=[c[0] for c in DIR_CONVS])
def test_dir_gnn_conv_matches_jax(name, jbuild, tbuild, root, variant):
    """Around GCNConv the masked COO is held with ResGatedGraphConv's
    case only: both packages' GCNConv grow a mask by N loop edges also
    without self loops, so neither runs it (ROADMAP Queue 3)."""
    if name == 'GCNConv' and variant == 'coo mask':
        variant = 'coo'
    tm = conv.DirGNNConv(tbuild(), alpha=0.3, root_weight=root, **CPU)
    for sub in (tm.conv_in, tm.conv_out):
        assert not getattr(sub, 'add_self_loops', False)
        assert getattr(sub, 'lin_skip', None) is None
    _run(jconv.DirGNNConv(conv=jbuild(), alpha=0.3, root_weight=root), tm,
         variant)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('iters', [1, 2])
def test_antisymmetric_conv_matches_jax(iters, variant):
    """The default phi, a bias-free GCNConv; the EdgeIndex has its caches
    filled."""
    _run(jconv.AntiSymmetricConv(num_iters=iters, gamma=0.2),
         conv.AntiSymmetricConv(F, num_iters=iters, gamma=0.2, **CPU),
         variant, cached=True)


def test_antisymmetric_conv_custom_phi_matches_jax():
    _run(jconv.AntiSymmetricConv(phi=jconv.SAGEConv(out_channels=F),
                                 act='relu'),
         conv.AntiSymmetricConv(F, phi=conv.SAGEConv(F, F, **CPU),
                                act='relu', **CPU), 'coo mask')


@pytest.mark.parametrize('case', ['plain', 'weights', 'mask'])
def test_hypergraph_conv_matches_jax(case):
    """8 hyperedges over the 26 nodes; padded incidences at the sentinel
    are masked."""
    rng = np.random.default_rng(5)
    m, nnz = 8, 60
    inc = np.stack([rng.integers(0, N, nnz), rng.integers(0, m, nnz)])
    kw = {'num_edges': m}
    if case == 'weights':
        kw['hyperedge_weight'] = rng.uniform(0.5, 2.0, m).astype(np.float32)
    if case == 'mask':
        inc = np.concatenate([inc, [[N] * 3, [m] * 3]], 1)
        kw['mask'] = np.concatenate([rng.random(nnz) < 0.8,
                                     np.zeros(3, bool)])
    inc = inc.astype(np.int32)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    compare(jconv.HypergraphConv(out_channels=C),
            conv.HypergraphConv(F, C, **CPU), X, (jnp.asarray(inc),),
            (t(inc),), jkw=jkw, tkw=tkw)


def test_wl_conv_matches_jax():
    """Two refinements from one-hot colours, the colour map kept across
    calls, the padded edges dropped; the histograms, plain and
    normalised."""
    from pytorch_geometric_tpu.nn.conv import WLConv as JWLConv
    colours = np.random.default_rng(6).integers(0, 3, N)
    batch = np.repeat(np.arange(2), N // 2)
    jm, tm = JWLConv(), conv.WLConv()
    jx, tx = np.eye(3, dtype=np.float32)[colours], t(np.eye(
        3, dtype=np.float32)[colours])
    for _ in range(2):
        jx = jm(jx, COO)
        tx = tm(tx, t(COO))
        np.testing.assert_array_equal(tx.numpy(), jx)
    assert tm.hashmap == jm.hashmap
    for norm in (False, True):
        np.testing.assert_allclose(
            tm.histogram(tx, t(batch), norm).numpy(),
            jm.histogram(jx, batch, norm), rtol=0, atol=1e-7)


@pytest.mark.parametrize('layout', ['ring', 'adjacency'])
def test_meshcnn_conv_matches_jax(layout):
    rng = np.random.default_rng(7)
    ring = rng.integers(0, N, (N, 4)).astype(np.int32)
    if layout == 'adjacency':
        ring = np.stack([np.repeat(np.arange(N), 4),
                         ring.reshape(-1)]).astype(np.int32)
    compare(jconv.MeshCNNConv(out_channels=C),
            conv.MeshCNNConv(F, C, **CPU), X, (jnp.asarray(ring),),
            (t(ring),))


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('aggr,root', [('sum', None), ('mean', 'sum'),
                                       ('max', 'cat'), ('sum', 'self_loop'),
                                       ('mean', 'self_loop')])
def test_simple_conv_matches_jax(aggr, root, variant):
    _run(jconv.SimpleConv(aggr=aggr, combine_root=root),
         conv.SimpleConv(aggr=aggr, combine_root=root), variant,
         weighted=True)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('shared,theta,layer', [(True, None, None),
                                                (False, 0.5, 2),
                                                (True, 1.0, 3)])
def test_gcn2_conv_matches_jax(shared, theta, layer, variant):
    """On the masked COO without self loops: the JAX package's GCN2Conv
    leaves the mask E long after appending N loops and cannot run with both
    (ROADMAP Queue 3; the port grows the mask)."""
    x0 = np.random.default_rng(8).standard_normal((N, F)).astype(np.float32)
    loops = variant != 'coo mask'
    tm = conv.GCN2Conv(F, alpha=0.2, theta=theta, layer=layer,
                       shared_weights=shared, add_self_loops=loops, **CPU)
    if theta is not None:
        assert tm.beta == pytest.approx(np.log(theta / layer + 1))
    _run(jconv.GCN2Conv(channels=F, alpha=0.2, theta=theta, layer=layer,
                        shared_weights=shared, add_self_loops=loops), tm,
         variant, weighted=True, pre=(x0,))


def test_gcn2_conv_grows_the_mask_with_its_loops():
    """With self loops and a mask, the port's GCN2Conv over the padded COO
    whose real edges are all kept equals it over the real edges alone (the
    padded edges enter no degree)."""
    x0 = t(np.random.default_rng(8).standard_normal((N, F)).astype(
        np.float32))
    tm = conv.GCN2Conv(F, alpha=0.2, **CPU)
    close(tm(t(X), x0, t(COO), edge_mask=t(COO[1] < N)),
          tm(t(X), x0, t(COO[:, :E])).detach().numpy())


@pytest.mark.parametrize('variant', VARIANTS)
def test_point_gnn_conv_matches_jax(variant):
    pos = np.random.default_rng(9).standard_normal((N, 3)).astype(
        np.float32)
    _run(jconv.PointGNNConv(channels=F), conv.PointGNNConv(F, **CPU),
         variant, pre=(pos,))


def test_convert_dir_gnn_round_trip():
    """DirGNNConv's ``conv_in`` / ``conv_out`` subtrees (a bias-free
    copy's ``lin`` each, no ``lin_skip``) and its root ``lin`` load
    strictly and give back the flax arrays."""
    jm = jconv.DirGNNConv(conv=jconv.ResGatedGraphConv(out_channels=C))
    tm = conv.DirGNNConv(conv.ResGatedGraphConv(F, C, **CPU), **CPU)
    v = init_variables(jm, 0, jnp.asarray(X), jnp.asarray(COO[:, :E]))
    sd = flax_to_state_dict(v)
    tm.load_state_dict(sd)
    assert set(sd) == set(tm.state_dict())
    assert {'conv_in.lin_key.weight', 'conv_out.lin_value.bias',
            'lin.weight'} <= set(sd)
    got = tm.state_dict()
    np.testing.assert_array_equal(
        got['conv_out.lin_query.weight'].numpy(),
        np.asarray(v['params']['conv_out']['lin_query']['kernel']).T)


K_CLASSES, STEPS, LR = 5, 3, 1e-2


class _JStack(fnn.Module):
    @fnn.compact
    def __call__(self, x, edge_index, edge_mask):
        x0 = fnn.relu(fnn.Dense(C, name='lin_0')(x))
        h = x0
        for i in range(3):
            h = fnn.relu(jconv.GCN2Conv(
                channels=C, alpha=0.1, theta=0.5, layer=i + 1,
                shared_weights=i != 1, name=f'conv_{i}')(
                    h, x0, edge_index, edge_mask=edge_mask))
        return fnn.Dense(K_CLASSES, name='lin_1')(h)


class _Stack(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lins = torch.nn.ModuleList([linear(F, C, device='cpu'),
                                         linear(C, K_CLASSES, device='cpu')])
        self.convs = torch.nn.ModuleList(
            conv.GCN2Conv(C, alpha=0.1, theta=0.5, layer=i + 1,
                          shared_weights=i != 1, **CPU) for i in range(3))

    def forward(self, x, edge_index, edge_mask):
        x0 = torch.relu(self.lins[0](x))
        h = x0
        for c in self.convs:
            h = torch.relu(c(h, x0, edge_index, edge_mask=edge_mask))
        return self.lins[1](h)


def test_gcn2_stack_adam_steps_match_optax():
    """Three Adam (lr 1e-2) steps of a 3-layer GCN2Conv stack (the middle
    layer with separate weights) on a raw COO, softmax cross-entropy:
    the losses each step and the parameters after."""
    coo = COO[:, :E]
    y = np.random.default_rng(10).integers(0, K_CLASSES, N)
    jm, tm = _JStack(), _Stack()
    args = (jnp.asarray(X), jnp.asarray(coo), None)
    params = init_variables(jm, 0, *args)['params']
    tm.load_state_dict(flax_to_state_dict({'params': params}))

    def jloss(p):
        logits = jm.apply({'params': p}, *args)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    tx = optax.adam(LR)
    state = tx.init(params)
    step = jax.jit(jax.value_and_grad(jloss))
    opt = torch.optim.Adam(tm.parameters(), lr=LR)
    for _ in range(STEPS):
        jl, g = step(params)
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(
            tm(t(X), t(coo), None), t(y).long())
        loss.backward()
        opt.step()
        assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    want = flax_to_state_dict({'params': params})
    for k, v in tm.state_dict().items():
        close(v, want[k].numpy(), k)
