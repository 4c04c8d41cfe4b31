"""The port's graph transformers against the JAX package's, on the CPU, at
small widths: the encodings (``nn/encoding.py``), the four attention
modules of ``nn/attention`` and flax's multi-head attention, ``GPSConv``
(multi-head and Performer attention, batch and layer norm, a padded graph
slot, ``L = N`` against a given ``max_num_nodes``), ``RGATConv`` in every
mechanism, mode and mod (with ``num_bases`` and ``edge_dim``),
``HEATConv``, ``SGFormer`` (also on the cached normalisation),
``Polynormer`` (local and global, training-mode statistics),
``GraphMixer``, ``utils.dense.node_positions`` against the JAX package's
running count, ``convert.py``'s rules for these modules, and
``chip_smoke.py``'s path X model (GraphGPS on ZINC's shape) at two narrow
layers over three Adam steps against flax and optax.

The same numpy inputs go to both packages; the flax parameters and batch
statistics reach the port's modules through ``convert.flax_to_state_dict``.
Tolerances: outputs within 1e-5 * max(1, max|ref|), gradients (input and
every parameter, of ``sum(out * cot)``) within 1e-4 of each gradient's
largest entry, or within 1e-6 of the largest gradient of all where a
gradient vanishes in exact arithmetic (the bias of a Linear that a batch
norm follows), losses within 1e-4 relative, running statistics as
outputs."""

import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.data import Batch as JBatch, Data as JData
from pytorch_geometric_tpu.nn import attention as jattn
from pytorch_geometric_tpu.nn import conv as jconv
from pytorch_geometric_tpu.nn import encoding as jenc
from pytorch_geometric_tpu.nn import models as jmodels
from pytorch_geometric_tpu.nn.models import transformers as jtrans
from pytorch_geometric_tpu.nn.norm import BatchNorm as JBatchNorm
from pytorch_geometric_tpu.nn.pool import glob as jglob
from pytorch_geometric_tpu.transforms import \
    AddRandomWalkPE as JAddRandomWalkPE
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.loader import DataLoader
from pytorch_geometric_tpu_torch.nn import attention, conv, encoding, models
from pytorch_geometric_tpu_torch.nn.conv import cache_gcn_norm
from pytorch_geometric_tpu_torch.transforms import AddRandomWalkPE
from pytorch_geometric_tpu_torch.utils.dense import node_positions

ROOT = Path(__file__).resolve().parents[1]
N, E, F_IN = 26, 90, 12


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _close(got, ref, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = 1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _grad_close(got, ref, what='', floor=0.0):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = max(1e-4 * float(np.abs(ref).max(initial=0.0)), floor, 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _noise_floor(jgx, jgrads):
    return 1e-6 * max([float(np.abs(np.asarray(jgx)).max())]
                      + [float(g.abs().max()) for g in jgrads.values()])


def _graph(seed, n=N, e=E, f=F_IN, pad=0, edge_dim=None):
    """A random graph: x, coo (``pad`` extra edges at the sentinel ``n``),
    the edge mask (False on the padded edges and on a few random ones), and
    edge features."""
    rng = np.random.default_rng(seed)
    coo = rng.integers(0, n, (2, e)).astype(np.int32)
    coo = np.concatenate([coo, np.full((2, pad), n, np.int32)], 1)
    mask = np.concatenate([rng.random(e) < 0.85, np.zeros(pad, bool)])
    x = rng.standard_normal((n, f)).astype(np.float32)
    ea = (rng.standard_normal((e + pad, edge_dim)).astype(np.float32)
          if edge_dim else None)
    return x, coo, mask, ea


def _compare(jm, tm, x, jargs=(), targs=(), jkw=None, tkw=None,
             train=False, variables=None, seed=0):
    """The flax module ``jm`` and the port's ``tm`` on ``x`` (then
    ``jargs`` / ``targs``): the output, the gradients of ``sum(out * cot)``
    for ``x`` and every parameter (a flax parameter the port keeps as a
    buffer, the Performer's projection, must get a zero gradient), and in
    ``train`` mode the updated batch statistics. Returns the variables."""
    jkw, tkw = dict(jkw or {}), dict(tkw or {})
    xj = jnp.asarray(x)
    if variables is None:
        variables = _init(jm, seed, xj, *jargs, **jkw)
    variables = dict(variables)
    rest = {k: v for k, v in variables.items() if k != 'params'}
    stats = train and 'batch_stats' in rest

    def japply(p, xs):
        v = {'params': p, **rest}
        if stats:
            return jm.apply(v, xs, *jargs, mutable=['batch_stats'], **jkw)
        return jm.apply(v, xs, *jargs, **jkw), None

    def jloss(p, xs, cot):
        out, upd = japply(p, xs)
        return (out * cot).sum(), (out, upd)

    shape = jax.eval_shape(lambda p, xs: japply(p, xs)[0],
                           variables['params'], xj).shape
    cot = np.random.default_rng(seed + 7).standard_normal(
        shape).astype(np.float32)
    # one compiled forward and backward: op-by-op JAX is ~10x slower here
    (_, (ref, upd)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, (0, 1), has_aux=True))(variables['params'], xj, cot)
    tm.load_state_dict(flax_to_state_dict(variables))
    tm.train(train)
    tx = torch.from_numpy(np.asarray(x)).requires_grad_()
    out = tm(tx, *targs, **tkw)
    _close(out, ref, 'output')
    (out * torch.from_numpy(cot)).sum().backward()
    _grad_close(tx.grad, jgx, 'grad x')
    jgrads = flax_to_state_dict({'params': jgp})
    named = dict(tm.named_parameters())
    buffers = set(jgrads) - set(named)
    assert buffers <= {k for k, _ in tm.named_buffers()}, buffers
    for k in buffers:
        assert not jgrads[k].abs().max(), k
    assert set(named) <= set(jgrads), sorted(set(named) - set(jgrads))
    floor = _noise_floor(jgx, jgrads)
    for k, p in named.items():
        # a parameter of a branch that did not run has no gradient here and
        # a zero one in JAX
        got = torch.zeros_like(p) if p.grad is None else p.grad
        _grad_close(got, jgrads[k].numpy(), k, floor)
    if stats:
        want = flax_to_state_dict({'params': {},
                                   'batch_stats': upd['batch_stats']})
        got = {k: v for k, v in tm.state_dict().items() if 'running' in k}
        assert set(got) == set(want) and got
        for k in want:
            _close(got[k], want[k].numpy(), k)
    return variables


def _init(jm, seed, *args, **kw):
    """Variables of ``jm``'s shapes drawn with numpy (``jax.eval_shape``
    of ``jm.init``, nothing compiled): matrices normal with variance 1 /
    fan-in, vectors (biases, norms' shifts) normal / 10 and norms' scales 1
    + normal / 10, as near a fresh model as flax's own init keeps them,
    running means normal / 10, running variances uniform in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(seed), *args,
                                            **kw))
    rng = np.random.default_rng(seed + 100)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == 'var':
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif len(leaf.shape) < 2:
            v = rng.standard_normal(leaf.shape) * 0.1 + (name == 'scale')
        else:
            fan = int(np.prod(leaf.shape[:-1]))
            v = rng.standard_normal(leaf.shape) / np.sqrt(max(fan, 1))
        return jnp.asarray(v, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# -- encodings ----------------------------------------------------------------
@pytest.mark.parametrize('name', ['PositionalEncoding', 'TemporalEncoding',
                                  'TimeEncoder'])
def test_encodings_match_jax(name):
    t = np.random.default_rng(1).random(40).astype(np.float32) * 50
    if name == 'TimeEncoder':
        jm, tm = jenc.TimeEncoder(16), encoding.TimeEncoder(16, device='cpu')
        _compare(jm, tm, t)
        return
    kw = {'out_channels': 18}
    jm = getattr(jenc, name)(**kw)
    tm = getattr(encoding, name)(**kw)
    if name == 'PositionalEncoding':
        for g in (1.0, 2.5):
            jm, tm = jenc.PositionalEncoding(18, granularity=g), \
                encoding.PositionalEncoding(18, granularity=g)
            _close(tm(torch.from_numpy(t)), jm.apply({}, jnp.asarray(t)))
        with pytest.raises(ValueError):
            encoding.PositionalEncoding(7)
        return
    _close(tm(torch.from_numpy(t)), jm.apply({}, jnp.asarray(t)))


# -- attention ----------------------------------------------------------------
def _seq(seed, b=3, n=11, f=16, valid=(11, 7, 4)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, f)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    return x, mask


ATTN_CASES = {
    'performer': (lambda: jattn.PerformerAttention(channels=16, heads=2),
                  lambda: attention.PerformerAttention(16, 2, device='cpu'),
                  'float'),
    'performer-m': (lambda: jattn.PerformerAttention(channels=16, heads=4,
                                                     num_features=24),
                    lambda: attention.PerformerAttention(
                        16, 4, num_features=24, device='cpu'), 'float'),
    'sgformer': (lambda: jattn.SGFormerAttention(channels=16, heads=2),
                 lambda: attention.SGFormerAttention(16, 2, device='cpu'),
                 'float'),
    'sgformer-bias': (lambda: jattn.SGFormerAttention(
        channels=16, heads=3, head_channels=8, qkv_bias=True),
        lambda: attention.SGFormerAttention(16, 3, head_channels=8,
                                            qkv_bias=True, device='cpu'),
        'float'),
    'polynormer': (lambda: jattn.PolynormerAttention(channels=16, heads=2),
                   lambda: attention.PolynormerAttention(16, 2,
                                                         device='cpu'),
                   'float'),
    'polynormer-qk': (lambda: jattn.PolynormerAttention(
        channels=16, heads=4, head_channels=6, qk_shared=False,
        qkv_bias=True, beta=0.5),
        lambda: attention.PolynormerAttention(
            16, 4, head_channels=6, qk_shared=False, qkv_bias=True,
            beta=0.5, device='cpu'), 'float'),
    'qformer': (lambda: jattn.QFormer(hidden_channels=16, num_queries=5,
                                      heads=4, num_layers=2),
                lambda: attention.QFormer(16, 16, num_queries=5, heads=4,
                                          num_layers=2, device='cpu'),
                'bool'),
}


# (module, masked, flat): each module batched with a key mask, and flat or
# unmasked where its code has a branch for it
ATTN_RUNS = [('performer', True, False), ('performer', False, True),
             ('performer-m', True, False), ('sgformer', True, False),
             ('sgformer', True, True), ('sgformer-bias', False, False),
             ('polynormer', True, False), ('polynormer', True, True),
             ('polynormer-qk', False, False), ('qformer', True, False),
             ('qformer', True, True)]


@pytest.mark.parametrize('name,masked,flat', ATTN_RUNS)
def test_attention_matches_jax(name, masked, flat):
    jmake, tmake, kind = ATTN_CASES[name]
    x, mask = _seq(4)
    if flat:
        x, mask = x[0], mask[1]
    if not masked:
        mask = None
    elif kind == 'float':
        mask = mask.astype(np.float32)
    if name == 'qformer' and flat and masked:
        mask = mask[None]
    _compare(jmake(), tmake(), x, jkw={'mask': _j(mask)},
             tkw={'mask': _t(mask)})


def test_performer_key_features_take_one_global_max():
    """The key features subtract the max over the whole tensor, padded rows
    included; the query features each row's own."""
    x = torch.randn(2, 5, 3, 4)
    proj = torch.randn(8, 4)
    xp = (x / 4 ** 0.25) @ proj.T
    x2 = (x ** 2).sum(-1, keepdim=True) / 4
    k = attention.performer.softmax_kernel(x, proj, False)
    q = attention.performer.softmax_kernel(x, proj, True)
    torch.testing.assert_close(k, 8 ** -0.5 * (torch.exp(xp - x2 - xp.max())
                                               + 1e-4))
    torch.testing.assert_close(
        q, 8 ** -0.5 * (torch.exp(xp - x2 - xp.amax(-1, keepdim=True))
                        + 1e-4))
    m = attention.PerformerAttention(8, 2, device='cpu')
    assert 'projection' not in dict(m.named_parameters())
    assert m.projection.shape == (16, 4) and not m.projection.requires_grad


@pytest.mark.parametrize('case', ['masked', 'empty-row', 'cross'])
def test_multihead_attention_matches_flax(case):
    """flax's ``MultiHeadDotProductAttention``: a key mask, a batch row
    whose keys are all masked (a uniform row, not NaN), and cross
    attention to a wider key sequence."""
    x, mask = _seq(6, valid=(11, 0, 5) if case == 'empty-row' else
                   (11, 7, 4))
    kv = None
    jm = fnn.MultiHeadDotProductAttention(num_heads=4)
    tm = attention.MultiHeadDotProductAttention(16, 4, device='cpu')
    if case == 'cross':
        kv = np.random.default_rng(7).standard_normal(
            (3, 9, 10)).astype(np.float32)
        mask = mask[:, :9]
        tm = attention.MultiHeadDotProductAttention(16, 4, kv_features=10,
                                                    device='cpu')
    m4 = mask[:, None, None, :]
    # flax's inputs_k defaults to inputs_q: self-attention differentiates
    # through the keys and values too
    jargs = () if kv is None else (jnp.asarray(kv),)
    targs = () if kv is None else (torch.from_numpy(kv),)
    variables = _init(jm, 0, jnp.asarray(x), *jargs, mask=jnp.asarray(m4))
    _compare(jm, tm, x, jargs, targs, jkw={'mask': jnp.asarray(m4)},
             tkw={'mask': torch.from_numpy(m4)}, variables=variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), None if kv is None
                 else torch.from_numpy(kv), mask=torch.from_numpy(m4))
    assert torch.isfinite(got).all()


# -- GPSConv ------------------------------------------------------------------
SIZES = (5, 9, 7)


def _gps_batch(seed, pad_nodes=4, f=16, edge_dim=16):
    """Three graphs of SIZES in row order, then ``pad_nodes`` padded rows
    with batch id 3 (the collater's dump graph); in-graph random edges, a
    few padded ones at the sentinel."""
    rng = np.random.default_rng(seed)
    batch, coo, start = [], [], 0
    for g, s in enumerate(SIZES):
        batch += [g] * s
        coo.append(start + rng.integers(0, s, (2, 3 * s)))
        start += s
    n = start + pad_nodes
    batch = np.asarray(batch + [len(SIZES)] * pad_nodes, np.int32)
    coo = np.concatenate(coo + [np.full((2, 3), n)], 1).astype(np.int32)
    e = coo.shape[1]
    x = rng.standard_normal((n, f)).astype(np.float32)
    x[start:] = 0.0
    ea = rng.standard_normal((e, edge_dim)).astype(np.float32)
    emask = rng.random(e) < 0.9
    emask[-3:] = False
    nmask = np.arange(n) < start
    return x, coo, ea, batch, emask, nmask


GPS_CASES = {
    # attn_type, norm, batch_size, max_num_nodes, node_mask, conv, train;
    # batch_size 3 leaves the padded rows (id 3) outside every graph, 4
    # gives them a graph slot of their own; max_num_nodes None is the JAX
    # default L = N, 9 the largest graph, 6 cuts the larger graphs
    'multihead-bn-train': ('multihead', 'batch_norm', 3, 9, False, True,
                           True),
    'multihead-ln-L=n': ('multihead', 'layer_norm', 3, None, False, True,
                         False),
    'multihead-slot': ('multihead', 'batch_norm', 4, 9, True, True, True),
    'multihead-cut': ('multihead', 'layer_norm', 3, 6, False, True, False),
    'multihead-noconv': ('multihead', None, 3, 9, False, False, False),
    'performer-bn-train': ('performer', 'batch_norm', 3, 9, False, True,
                           True),
    'performer-ln-L=n': ('performer', 'layer_norm', 3, None, True, True,
                         False),
    'performer-slot': ('performer', 'batch_norm', 4, 9, False, True, False),
}


@pytest.mark.parametrize('case', sorted(GPS_CASES))
def test_gps_conv_matches_jax(case):
    attn, norm, bsz, L, use_nmask, with_conv, train = GPS_CASES[case]
    x, coo, ea, batch, emask, nmask = _gps_batch(2)
    f = x.shape[1]
    jm = jconv.GPSConv(
        channels=f, heads=4, attn_type=attn, norm=norm,
        conv=(jconv.GINEConv(mlp=jmodels.MLP(channel_list=[f, f]))
              if with_conv else None))
    tm = conv.GPSConv(
        f, conv.GINEConv(models.MLP(f, [f, f], device='cpu'))
        if with_conv else None, heads=4, attn_type=attn, norm=norm,
        device='cpu')
    nm = nmask if use_nmask else None
    common = dict(batch_size=bsz, max_num_nodes=L)
    jkw = dict(common, batch=jnp.asarray(batch), node_mask=_j(nm),
               edge_mask=jnp.asarray(emask), deterministic=not train)
    tkw = dict(common, batch=torch.from_numpy(batch), node_mask=_t(nm),
               edge_mask=torch.from_numpy(emask))
    if with_conv:
        jkw['edge_attr'], tkw['edge_attr'] = jnp.asarray(ea), _t(ea)
    # the batch statistics come from a training-mode init
    variables = _init(jm, 3, jnp.asarray(x), jnp.asarray(coo),
                      **dict(jkw, deterministic=False))
    _compare(jm, tm, x, (jnp.asarray(coo),), (torch.from_numpy(coo),),
             jkw=jkw, tkw=tkw, train=train, variables=variables)


def test_gps_conv_takes_no_dropout_and_checks_options():
    with pytest.raises(ValueError):
        conv.GPSConv(8, dropout=0.1, device='cpu')
    with pytest.raises(ValueError):
        conv.GPSConv(8, attn_type='flash', device='cpu')
    with pytest.raises(ValueError):
        conv.GPSConv(8, norm='graph_norm', device='cpu')


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_node_positions_match_the_running_count(seed):
    """The sort-based rank against the JAX package's ``cumsum`` of a
    one-hot, on unsorted ids with ids past the end and negative ones."""
    rng = np.random.default_rng(seed)
    b = 5
    batch = rng.integers(-2, b + 2, 60)
    if seed == 0:
        batch = np.sort(np.clip(batch, 0, b))
    counts = jnp.cumsum(jax.nn.one_hot(jnp.asarray(batch), b,
                                       dtype=jnp.int32), axis=0)
    ref = counts[jnp.arange(len(batch)), jnp.asarray(batch)] - 1
    got = node_positions(torch.from_numpy(batch), b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- RGATConv and HEATConv ----------------------------------------------------
RGAT_EXTRAS = [(None, None), (2, None), (None, 5), (3, 5)]


@pytest.mark.parametrize('mechanism', ['across-relation', 'within-relation'])
@pytest.mark.parametrize('mode', ['additive-self-attention',
                                  'multiplicative-self-attention'])
@pytest.mark.parametrize('mod', [None, 'f-additive', 'f-scaled'])
def test_rgat_conv_matches_jax(mechanism, mode, mod):
    """Every mechanism x mode x mod, with ``num_bases`` and ``edge_dim``
    set in turn (all four pairs in each mode), heads 2, ``dim`` 2 in the
    multiplicative mode, ``concat`` off in half of them."""
    index = (['across-relation', 'within-relation'].index(mechanism)
             + 2 * [None, 'f-additive', 'f-scaled'].index(mod))
    bases, edge_dim = RGAT_EXTRAS[index % 4]
    concat = bool(index % 2)
    x, coo, mask, ea = _graph(index, pad=3, edge_dim=edge_dim)
    et = np.random.default_rng(index).integers(0, 3, coo.shape[1])
    dim = 1 if mode.startswith('additive') else 2
    kw = dict(num_relations=3, num_bases=bases, heads=2, dim=dim,
              concat=concat, attention_mechanism=mechanism,
              attention_mode=mode, mod=mod)
    jm = jconv.RGATConv(out_channels=6, **kw)
    tm = conv.RGATConv(F_IN, 6, edge_dim=edge_dim, device='cpu', **kw)
    jargs = (jnp.asarray(coo), jnp.asarray(et), _j(ea))
    targs = (torch.from_numpy(coo), torch.from_numpy(et), _t(ea))
    _compare(jm, tm, x, jargs, targs, jkw={'edge_mask': jnp.asarray(mask)},
             tkw={'edge_mask': torch.from_numpy(mask)}, seed=index)


def test_rgat_conv_checks_options():
    for kw in ({'attention_mechanism': 'x'}, {'attention_mode': 'x'},
               {'mod': 'x'}, {'dim': 2}):
        with pytest.raises(ValueError):
            conv.RGATConv(4, 4, device='cpu', **kw)


@pytest.mark.parametrize('concat,root_weight', [(True, True),
                                                (False, False)])
def test_heat_conv_matches_jax(concat, root_weight):
    x, coo, mask, ea = _graph(8, pad=2, edge_dim=5)
    rng = np.random.default_rng(9)
    ntype = rng.integers(0, 3, N)
    etype = rng.integers(0, 4, coo.shape[1])
    kw = dict(num_node_types=3, num_edge_types=4, edge_type_emb_dim=6,
              edge_attr_emb_dim=7, heads=3, concat=concat,
              root_weight=root_weight)
    jm = jconv.HEATConv(out_channels=8, edge_dim=5, **kw)
    tm = conv.HEATConv(F_IN, 8, edge_dim=5, device='cpu', **kw)
    _compare(jm, tm, x, (jnp.asarray(coo), jnp.asarray(ntype),
                         jnp.asarray(etype), jnp.asarray(ea)),
             (torch.from_numpy(coo), torch.from_numpy(ntype),
              torch.from_numpy(etype), torch.from_numpy(ea)),
             jkw={'edge_mask': jnp.asarray(mask)},
             tkw={'edge_mask': torch.from_numpy(mask)})


# -- SGFormer, Polynormer, GraphMixer -----------------------------------------
def _one_graph(seed, pad_rows=3, loops=True):
    """One graph with ``pad_rows`` zero rows at the end (``mask`` False),
    and padded edges at the sentinel; without ``loops`` no self loop."""
    x, coo, _, _ = _graph(seed, pad=4)
    if not loops:
        coo = coo[:, coo[0] != coo[1]]
    x[N - pad_rows:] = 0.0
    keep = (coo[0] < N - pad_rows) & (coo[1] < N - pad_rows)
    coo = np.where(keep, coo, N).astype(np.int32)
    mask = np.arange(N) < N - pad_rows
    return x, coo, mask


@pytest.mark.parametrize('case,train', [('add', False), ('cat', True),
                                        ('cached', False),
                                        ('cached', True)])
def test_sgformer_matches_jax(case, train):
    """``cached``: the port's GCN layers on ``cache_gcn_norm``'s
    ``EdgeIndex`` (the normalisation computed once) against the JAX
    package's normalising on every call."""
    x, coo, mask = _one_graph(3, loops=case != 'cached')
    kw = dict(trans_num_layers=2, trans_num_heads=2, gnn_num_layers=2,
              graph_weight=0.3, aggregate='cat' if case == 'cat' else 'add')
    jm = jtrans.SGFormer(hidden_channels=10, out_channels=5, **kw)
    tm = models.SGFormer(F_IN, 10, 5, cached=case == 'cached',
                         device='cpu', **kw)
    if case == 'cached':
        tei = cache_gcn_norm(EdgeIndex(coo, (N, N), device='cpu'),
                             auto=True)
        assert tei.weight is not None
    else:
        tei = torch.from_numpy(coo)
    jkw = {'mask': jnp.asarray(mask), 'training': train}
    variables = _init(jm, 1, jnp.asarray(x), jnp.asarray(coo),
                      **dict(jkw, training=True))
    _compare(jm, tm, x, (jnp.asarray(coo),), (tei,), jkw=jkw,
             tkw={'mask': torch.from_numpy(mask)}, train=train,
             variables=variables)


def _polynormer_variables(jm_local, jm_global, x, coo):
    """Both modes' parameters: flax makes only the branch it runs, and the
    local layers' draws are the same in both (one key, one path)."""
    args = (jnp.asarray(x), jnp.asarray(coo))
    vg = _init(jm_global, 2, *args, training=True)
    vl = _init(jm_local, 2, *args, training=True)
    params = dict(vg['params'])
    params['pred_local'] = vl['params']['pred_local']
    return dict(vg, params=params)


@pytest.mark.parametrize('use_global,variant,train', [
    (False, 'default', True), (True, 'default', True),
    (False, 'pre_ln-qk_shared-nobn', False),
    (True, 'pre_ln-qk_shared-nobn', True)])
def test_polynormer_matches_jax(use_global, variant, train):
    x, coo, mask = _one_graph(4)
    emask = np.random.default_rng(5).random(coo.shape[1]) < 0.9
    kw = dict(local_layers=2, global_layers=2, heads=2, beta=0.7)
    if variant != 'default':
        kw.update(pre_ln=True, qk_shared=True, post_bn=False)
    jms = [jtrans.Polynormer(hidden_channels=6, out_channels=4,
                             use_global=g, **kw) for g in (False, True)]
    variables = _polynormer_variables(*jms, x, coo)
    tm = models.Polynormer(F_IN, 6, 4, use_global=use_global,
                           device='cpu', **kw)
    jkw = {'mask': jnp.asarray(mask), 'training': train,
           'edge_mask': jnp.asarray(emask)}
    _compare(jms[use_global], tm, x, (jnp.asarray(coo),),
             (torch.from_numpy(coo),), jkw=jkw,
             tkw={'mask': torch.from_numpy(mask),
                  'edge_mask': torch.from_numpy(emask)},
             train=train, variables=variables)


def test_graph_mixer_matches_jax():
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((15, 8, 5)).astype(np.float32)
    times = (rng.random((15, 8)) * 100).astype(np.float32)
    lmask = rng.random((15, 8)) < 0.7
    lmask[3] = False
    feats[~lmask] = 0.0
    jm = jtrans.GraphMixer(in_channels=5, hidden_channels=12,
                           out_channels=3, num_tokens=8, time_channels=6)
    tm = models.GraphMixer(5, 12, 3, num_tokens=8, time_channels=6,
                           device='cpu')
    _compare(jm, tm, feats, (jnp.asarray(times), jnp.asarray(lmask)),
             (torch.from_numpy(times), torch.from_numpy(lmask)))


def test_new_modules_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for make in (lambda: conv.RGATConv(4, 4), lambda: conv.HEATConv(4, 4),
                 lambda: conv.GPSConv(8), lambda: models.SGFormer(4, 8, 2),
                 lambda: models.Polynormer(4, 8, 2),
                 lambda: models.GraphMixer(4, 8, 2),
                 lambda: attention.PerformerAttention(8),
                 lambda: attention.QFormer(4, 8),
                 lambda: encoding.TimeEncoder(4)):
        with pytest.raises(RuntimeError, match='no CUDA card'):
            make()


# -- convert.py's rules for this slice ----------------------------------------
def test_convert_rules_for_dense_general_and_buffers():
    """flax MHA's 3-D DenseGeneral kernels and their [H, D] biases, the
    out projection's [H, D, F], and names kept (RGAT's banks, the
    Performer's projection, Polynormer's ``lin_i`` as ``lins.i``)."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((6, 2, 3))
    o = rng.standard_normal((2, 3, 5))
    tree = {'attn': {'query': {'kernel': q, 'bias': np.ones((2, 3))},
                     'out': {'kernel': o, 'bias': np.zeros(5)}},
            'perf': {'projection': np.eye(3),
                     'out': {'kernel': np.ones((4, 2)), 'bias': np.zeros(2)}},
            'rgat': {'weight': np.ones((3, 4, 5)), 'q': np.ones((5, 2))},
            'lin_2': {'kernel': np.ones((3, 4)), 'bias': np.zeros(4)}}
    sd = flax_to_state_dict(tree)
    np.testing.assert_array_equal(sd['attn.query.weight'].numpy(),
                                  q.reshape(6, 6).T.astype(np.float32))
    assert sd['attn.query.bias'].shape == (6,)
    np.testing.assert_array_equal(sd['attn.out.weight'].numpy(),
                                  o.reshape(6, 5).T.astype(np.float32))
    assert sd['perf.projection'].shape == (3, 3)
    assert sd['perf.out.weight'].shape == (2, 4)
    assert sd['rgat.weight'].shape == (3, 4, 5)
    assert sd['lins.2.weight'].shape == (4, 3)


@pytest.mark.parametrize('name', ['GPSConv-multihead', 'GPSConv-performer',
                                  'QFormer', 'Polynormer', 'RGATConv-bases',
                                  'HEATConv'])
def test_convert_round_trip_names(name):
    """Every parameter and buffer name of the port's module is one that
    ``convert.flax_to_state_dict`` makes from the JAX module's variables,
    with the same shape (``load_state_dict`` is strict)."""
    x, coo, ea, batch, emask, _ = _gps_batch(1)
    f = x.shape[1]
    xj, cj = jnp.asarray(x), jnp.asarray(coo)
    if name.startswith('GPSConv'):
        attn = name.split('-')[1]
        jm = jconv.GPSConv(channels=f, heads=2, attn_type=attn,
                           conv=jconv.GINEConv(mlp=jmodels.MLP(
                               channel_list=[f, f])))
        args = (xj, cj, jnp.asarray(batch), 3, 9)
        kw = {'edge_attr': jnp.asarray(ea)}
        tm = conv.GPSConv(f, conv.GINEConv(models.MLP(f, [f, f],
                                                      device='cpu')),
                          heads=2, attn_type=attn, device='cpu')
    elif name == 'QFormer':
        jm, args, kw = jattn.QFormer(hidden_channels=8, heads=2), (xj,), {}
        tm = attention.QFormer(f, 8, heads=2, device='cpu')
    elif name == 'Polynormer':
        jm = jtrans.Polynormer(hidden_channels=4, out_channels=3,
                               local_layers=2, use_global=True)
        args, kw = (xj, cj), {}
        tm = models.Polynormer(f, 4, 3, local_layers=2, device='cpu')
    elif name == 'RGATConv-bases':
        jm = jconv.RGATConv(out_channels=4, num_relations=3, num_bases=2)
        args = (xj, cj, jnp.zeros(coo.shape[1], jnp.int32),
                jnp.asarray(ea))
        kw = {}
        tm = conv.RGATConv(f, 4, num_relations=3, num_bases=2,
                           edge_dim=ea.shape[1], device='cpu')
    else:
        jm = jconv.HEATConv(out_channels=4, num_node_types=2,
                            num_edge_types=3)
        args = (xj, cj, jnp.zeros(len(x), jnp.int32),
                jnp.zeros(coo.shape[1], jnp.int32), jnp.asarray(ea))
        kw = {}
        tm = conv.HEATConv(f, 4, num_node_types=2, num_edge_types=3,
                           edge_dim=ea.shape[1], device='cpu')
    sd = flax_to_state_dict(dict(_init(jm, 0, *args, **kw)))
    if name == 'Polynormer':
        # the local head is made only when the model runs local
        sd['pred_local.weight'] = torch.zeros(3, 4)
        sd['pred_local.bias'] = torch.zeros(3)
    mine = tm.state_dict()
    assert set(sd) == set(mine), sorted(set(sd) ^ set(mine))
    for k, v in mine.items():
        assert tuple(sd[k].shape) == tuple(v.shape), (k, sd[k].shape,
                                                      v.shape)
    tm.load_state_dict(sd)


# -- path X at narrow widths, three Adam steps --------------------------------
def _synced_steps(jvg, variables, lr, jbatches, tm, tloss, tbatches):
    """Three optax Adam steps of the flax model; before each, the port's
    model takes the flax parameters (its running statistics stay its own)
    and its loss (1e-4 relative) and gradients on the same batch are held
    to flax's: each within 1e-4 of its own largest or 1e-5 of the largest
    of all, whichever is more (a gradient a batch norm cancels, an
    attention's key bias, is rounding noise of about 1e-6 of the largest
    on each side). The running statistics after the steps as outputs.
    ``jvg(params, stats, *batch)`` gives ``((loss, new stats),
    gradients)``. Returns the parameters and statistics after the
    steps."""
    params, stats = variables['params'], variables['batch_stats']
    tm.load_state_dict(flax_to_state_dict(dict(variables)))
    tm.train()
    tx = optax.adam(lr)
    opt = tx.init(params)

    @jax.jit
    def adam(g, opt, params):
        upd, opt = tx.update(g, opt)
        return optax.apply_updates(params, upd), opt

    for step, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        (loss, new_stats), g = jvg(params, stats, *jb)
        tm.load_state_dict(flax_to_state_dict({'params': params}),
                           strict=False)
        tm.zero_grad(set_to_none=True)
        tl = tloss(*tb)
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-4,
                                   err_msg=f'loss, step {step}')
        jgrads = flax_to_state_dict({'params': g})
        floor = 1e-5 * max(float(v.abs().max()) for v in jgrads.values())
        for k, p in tm.named_parameters():
            _grad_close(p.grad, jgrads[k].numpy(), f'{k}, step {step}',
                        floor)
        (params, opt), stats = adam(g, opt, params), new_stats
    want = flax_to_state_dict({'params': {}, 'batch_stats': stats})
    got = {k: v for k, v in tm.state_dict().items() if 'running' in k}
    assert set(got) == set(want) and got
    for k in want:
        _close(got[k], want[k].numpy(), k)
    return params, stats


class _JGPSNet(fnn.Module):
    """``chip_smoke.py::gps_zinc_net`` in flax."""
    channels: int
    pe_dim: int
    layers: int
    heads: int
    mlp: tuple
    attn_type: str
    atoms: int
    bonds: int

    @fnn.compact
    def __call__(self, atoms, pe, coo, bonds, batch, num_graphs, max_nodes,
                 training):
        c = self.channels
        pe = fnn.Dense(self.pe_dim, name='pe_lin')(JBatchNorm(
            in_channels=pe.shape[-1], name='pe_norm')(pe, training))
        x = jnp.concatenate([fnn.Embed(self.atoms, c - self.pe_dim,
                                       name='node_emb')(atoms), pe], -1)
        e = fnn.Embed(self.bonds, c, name='edge_emb')(bonds)
        for i in range(self.layers):
            # parent=None: the GINE conv belongs to its GPSConv, as in the
            # port, not to this module
            gine = jconv.GINEConv(mlp=jmodels.MLP(channel_list=[c, c],
                                                  parent=None), parent=None)
            x = jconv.GPSConv(channels=c, conv=gine, heads=self.heads,
                              attn_type=self.attn_type, name=f'conv_{i}')(
                x, coo, batch, num_graphs, max_nodes,
                deterministic=not training, edge_attr=e)
        x = jglob.global_add_pool(x, batch, num_graphs)
        return jmodels.MLP(channel_list=list(self.mlp), name='mlp')(x)[:, 0]


def test_path_x_steps_match_jax(attn_type='multihead'):
    """Path X's model (GraphGPS on ZINC's shape; its multi-head arm, the
    Performer's layer is held in ``test_gps_conv_matches_jax``) at 2
    layers of width 16 (PE 4 of it), 4 heads: ``AddRandomWalkPE(20)`` of
    both packages on
    ``chip_smoke.py::zinc_like`` graphs (bitwise), the 12 graphs in three
    orders collated by the port's ``DataLoader(pad=False)`` and the JAX
    package's ``Batch``, ``max_num_nodes`` the largest graph; three Adam
    steps (L1 loss, Adam 1e-3) with each step's loss and gradients and the
    running statistics after them (``_synced_steps``), then an eval
    forward."""
    cs = _chip_smoke()
    graphs = cs.zinc_like(12, seed=4)
    tdata = [AddRandomWalkPE(cs.PX_WALK)(Data(x=a, edge_index=c,
                                             edge_attr=b, y=y,
                                             num_nodes=len(a)))
             for a, c, b, y in graphs]
    jdata = [JAddRandomWalkPE(cs.PX_WALK)(JData(x=a, edge_index=c,
                                               edge_attr=b, y=y,
                                               num_nodes=len(a)))
             for a, c, b, y in graphs]
    for t, j in zip(tdata, jdata):
        np.testing.assert_array_equal(t.random_walk_pe.numpy(),
                                      np.asarray(j.random_walk_pe))
    # the same 12 graphs in three orders: three different batches of one
    # shape, so that JAX compiles the step once
    tbatches, jbatches, sizes = [], [], []
    for step in range(3):
        order = np.random.default_rng(step).permutation(12)
        (tb,) = DataLoader([tdata[i] for i in order], batch_size=12,
                           pad=False)
        jb = JBatch.from_data_list([jdata[i] for i in order])
        coo = jb.edge_index.coo if hasattr(jb.edge_index, 'coo') \
            else jb.edge_index
        np.testing.assert_array_equal(tb.edge_index.coo.numpy(),
                                      np.asarray(coo))
        largest = int(np.diff(tb.ptr.numpy()).max())
        sizes.append(largest)
        tbatches.append((tb.x, tb.random_walk_pe, tb.edge_index.coo,
                         tb.edge_attr, tb.batch, tb.y, 12, largest))
        jbatches.append(tuple(jnp.asarray(np.asarray(v)) for v in (
            jb.x, jb.random_walk_pe, coo, jb.edge_attr, jb.batch, jb.y)))
    dims = dict(channels=16, pe_dim=4, layers=2, heads=4, mlp=(8, 4, 1))
    jm = _JGPSNet(attn_type=attn_type, atoms=cs.PX_ATOMS,
                  bonds=cs.ZINC_BONDS, **dims)
    variables = _init(jm, 0, *jbatches[0][:5], 12, sizes[0], True)

    def jloss(p, st, atoms, pe, coo, bonds, batch, y, largest):
        out, upd = jm.apply({'params': p, 'batch_stats': st}, atoms, pe, coo,
                            bonds, batch, 12, largest, True,
                            mutable=['batch_stats'])
        return jnp.abs(out - y).mean(), upd['batch_stats']

    tm = cs.gps_zinc_net(torch, 'cpu', 0, attn_type, walk=cs.PX_WALK,
                         **dims)
    # the Performer's projection is a buffer of the port's model, carried
    # across once with the parameters
    tm.load_state_dict(flax_to_state_dict(dict(variables)))

    def tloss(*b):
        return (tm(*b[:5], b[6], b[7]) - b[5]).abs().mean()

    # the step compiled once (one batch shape; the largest graph static)
    jvg = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                  static_argnums=(8,))
    params, stats = _synced_steps(
        jvg, variables, 1e-3,
        [jb + (s,) for jb, s in zip(jbatches, sizes)], tm, tloss,
        tbatches)
    tm.load_state_dict(flax_to_state_dict({'params': params}), strict=False)
    tm.eval()
    ref = jax.jit(lambda v, *b: jm.apply(v, *b, 12, sizes[0], False))(
        {'params': params, 'batch_stats': stats}, *jbatches[0][:5])
    with torch.no_grad():
        _close(tm(*tbatches[0][:5], 12, sizes[0]), ref)
