"""The port's graph-level layers and models against the JAX package's, on
the CPU, at small widths: ``MLP`` and ``BasicGNN`` with ``batch_norm``
(training steps, running statistics, eval, a padded batch), ``GINEConv``,
the six convolutions of ``nn/conv/gen_conv.py``, ``EdgeConv`` /
``EdgeCNN``, ``PNA``, ``MessagePassing`` with an aggregation module, a list
of reductions and ``edge_updater`` (and its debug-mode bounds check), and
``chip_smoke.py``'s paths V (PNA on ZINC's shape) and W (GIN on COLLAB's)
at a few narrow layers over three Adam steps against flax and optax.

The same numpy inputs go to both packages; the flax parameters and batch
statistics reach the port's modules through ``convert.flax_to_state_dict``.
Tolerances: outputs within 1e-5 * max(1, max|ref|), gradients (input and
every parameter, of ``sum(out * cot)``) within 1e-4 of each gradient's
largest entry, losses within 1e-4 relative, running statistics as outputs.
A gradient that vanishes in exact arithmetic (the bias of a Linear right
before a batch norm, which removes any shift; a softmax gate's bias) is
rounding noise on both sides, and is held within 1e-6 of the largest
gradient of all instead."""

import importlib.util
from pathlib import Path
from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu import experimental as jexperimental
from pytorch_geometric_tpu.data import Batch as JBatch, Data as JData
from pytorch_geometric_tpu.nn import aggr as jaggr
from pytorch_geometric_tpu.nn import conv as jconv
from pytorch_geometric_tpu.nn import models as jmodels
from pytorch_geometric_tpu.nn.message_passing import \
    MessagePassing as JMessagePassing
from pytorch_geometric_tpu.nn.norm import BatchNorm as JBatchNorm
from pytorch_geometric_tpu.nn.pool import glob as jglob
from pytorch_geometric_tpu_torch import EdgeIndex, experimental
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.data import Batch, Data
from pytorch_geometric_tpu_torch.loader import DataLoader
from pytorch_geometric_tpu_torch.nn import MessagePassing, aggr, conv, models

ROOT = Path(__file__).resolve().parents[1]
N, E, F_IN = 30, 120, 6


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


def _check_module(jm, tm, jargs, targs, x, seed=0, sd_map=None,
                  jkw=None, tkw=None):
    """Forward and every gradient of ``sum(out * cot)``; ``jargs`` /
    ``targs`` follow ``x`` in the calls. ``sd_map`` renames flax keys
    before conversion."""
    jkw, tkw = jkw or {}, tkw or {}
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), *jargs, **jkw)
    ref = jm.apply(params, jnp.asarray(x), *jargs, **jkw)
    cot = np.random.default_rng(seed + 7).standard_normal(
        ref.shape).astype(np.float32)

    def jf(p, xs):
        return (jm.apply(p, xs, *jargs, **jkw) * cot).sum()

    jgp, jgx = jax.grad(jf, (0, 1))(params, jnp.asarray(x))
    rename = sd_map or (lambda tree: tree)
    tm.load_state_dict(flax_to_state_dict(rename(dict(params))))
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx, *targs, **tkw)
    _close(out, ref, 'output')
    (out * torch.from_numpy(cot)).sum().backward()
    _grad_close(tx.grad, jgx, 'grad x')
    jgrads = flax_to_state_dict(rename(dict(jgp)))
    named = dict(tm.named_parameters())
    assert set(named) == set(jgrads), (sorted(named), sorted(jgrads))
    floor = _noise_floor(jgx, jgrads)
    for k, p in named.items():
        _grad_close(p.grad, jgrads[k].numpy(), k, floor)
    return out


def _noise_floor(jgx, jgrads):
    """1e-6 of the largest gradient of all: the tolerance of a gradient
    that vanishes in exact arithmetic."""
    return 1e-6 * max([float(np.abs(np.asarray(jgx)).max())]
                      + [float(g.abs().max()) for g in jgrads.values()])


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# -- MLP and BasicGNN with batch norm ----------------------------------------------
def _bn_steps(jm, tm, xs, jcall, tcall, cot_seed=0):
    """Three training steps of a module holding flax BatchNorms: outputs,
    gradients and, after the steps, the running statistics; then eval."""
    variables = jm.init(jax.random.PRNGKey(0), *jcall(xs[0]))
    params, stats = variables['params'], variables['batch_stats']
    tm.load_state_dict(flax_to_state_dict(dict(variables)))
    tm.train()
    for step, x in enumerate(xs):
        def jf(p, xin, st):
            out, upd = jm.apply({'params': p, 'batch_stats': st},
                                *jcall(xin), deterministic=False,
                                mutable=['batch_stats'])
            cot = np.random.default_rng(cot_seed + step).standard_normal(
                out.shape).astype(np.float32)
            return (out * cot).sum(), (out, upd['batch_stats'], cot)

        (_, (ref, stats, cot)), (jgp, jgx) = jax.value_and_grad(
            jf, (0, 1), has_aux=True)(params, jnp.asarray(x), stats)
        tm.zero_grad()
        tx = torch.from_numpy(x).requires_grad_()
        out = tm(*tcall(tx))
        _close(out, ref, f'step {step}')
        (out * torch.from_numpy(np.asarray(cot))).sum().backward()
        _grad_close(tx.grad, jgx, f'grad x {step}')
        jgrads = flax_to_state_dict({'params': jgp})
        floor = _noise_floor(jgx, jgrads)
        for k, p in tm.named_parameters():
            _grad_close(p.grad, jgrads[k].numpy(), f'{k} {step}', floor)
    want = flax_to_state_dict({'params': {}, 'batch_stats': stats})
    got = {k: v for k, v in tm.state_dict().items() if 'running' in k}
    assert set(got) == set(want) and got
    for k in want:
        _close(got[k], want[k].numpy(), k)
    tm.eval()
    ref = jm.apply({'params': params, 'batch_stats': stats},
                   *jcall(jnp.asarray(xs[0])), deterministic=True)
    with torch.no_grad():
        _close(tm(*tcall(torch.from_numpy(xs[0]))), ref, 'eval')


@pytest.mark.parametrize('plain_last', [True, False])
def test_mlp_batch_norm_matches_jax(plain_last):
    rng = np.random.default_rng(1)
    xs = [(2 + rng.standard_normal((25, F_IN))).astype(np.float32)
          for _ in range(3)]
    jm = jmodels.MLP(channel_list=[16, 8, 4], norm='batch_norm',
                     plain_last=plain_last)
    tm = models.MLP(F_IN, [16, 8, 4], norm='batch_norm',
                    plain_last=plain_last, device='cpu')
    _bn_steps(jm, tm, xs, lambda x: (x,), lambda x: (x,))


@pytest.mark.parametrize('name', ['GCN', 'GraphSAGE', 'GIN'])
@pytest.mark.parametrize('jk', [None, 'cat'])
@pytest.mark.parametrize('layout', ['coo-mask', 'edge_index'])
def test_basic_gnn_batch_norm_matches_jax(name, jk, layout):
    """Three training steps, running statistics, eval; over a raw COO with
    padded edges and a mask, or over an ``EdgeIndex`` (GIN's fused SpMM)."""
    x, coo, mask, _ = _graph(len(name) + (jk is None), pad=5)
    rng = np.random.default_rng(4)
    xs = [x] + [rng.standard_normal(x.shape).astype(np.float32)
                for _ in range(2)]
    jm = getattr(jmodels, name)(hidden_channels=12, num_layers=3,
                                out_channels=4, norm='batch_norm', jk=jk)
    tm = getattr(models, name)(F_IN, 12, 3, 4, norm='batch_norm', jk=jk,
                               device='cpu')
    if layout == 'coo-mask':
        jei, tei = jnp.asarray(coo), torch.from_numpy(coo)
        jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    else:
        jei = JEdgeIndex(coo[:, :E], (N, N)).fill_cache()
        tei = EdgeIndex(coo[:, :E], (N, N), device='cpu').fill_cache()
        jmask = tmask = None
    _bn_steps(jm, tm, xs, lambda xin: (xin, jei, None, None, jmask),
              lambda xin: (xin, tei, None, None, tmask))


def test_basic_gnn_batch_norm_counts_padded_rows():
    """On a padded ``Batch`` the JAX package's BatchNorm normalises over
    every row it is given, the padded ones included; the port matches it
    (and so differs from normalising the real rows alone)."""
    graphs = [_graph(s, n=8 + s, e=20, pad=0)[:2] for s in range(3)]
    kw = dict(pad_num_nodes=40, pad_num_edges=80)
    jb = JBatch.from_data_list([JData(x=x, edge_index=c, num_nodes=len(x))
                                for x, c in graphs], **kw)
    tb = Batch.from_data_list([Data(x=x, edge_index=c, num_nodes=len(x))
                               for x, c in graphs], **kw)
    x = np.asarray(jb.x)
    np.testing.assert_array_equal(tb.x.numpy(), x)
    jcoo = np.asarray(jb.edge_index.coo)
    np.testing.assert_array_equal(tb.edge_index.coo.numpy(), jcoo)
    emask = jcoo[1] < 40
    jm = jmodels.GIN(hidden_channels=8, num_layers=2, norm='batch_norm',
                     jk='cat')
    tm = models.GIN(F_IN, 8, 2, norm='batch_norm', jk='cat', device='cpu')
    _bn_steps(jm, tm, [x, x, x],
              lambda xin: (xin, jnp.asarray(jcoo), None, None,
                           jnp.asarray(emask)),
              lambda xin: (xin, torch.from_numpy(jcoo), None, None,
                           torch.from_numpy(emask)))
    # the statistics saw all 40 rows, not the 27 real ones
    tm.train()
    h = tm.convs[0](torch.from_numpy(x), torch.from_numpy(jcoo),
                    edge_mask=torch.from_numpy(emask))
    before = tm.norms[0].running_mean.clone()
    tm.norms[0](h)
    m = tm.norms[0].momentum
    torch.testing.assert_close(tm.norms[0].running_mean,
                               (1 - m) * before + m * h.mean(0))
    assert not torch.allclose(h.mean(0), h[:tb.num_real_nodes].mean(0))


# -- convolutions ------------------------------------------------------------------
@pytest.mark.parametrize('edge_dim', [4, F_IN])
@pytest.mark.parametrize('train_eps', [False, True])
def test_gine_conv_matches_jax(edge_dim, train_eps):
    x, coo, mask, ea = _graph(5, pad=3, edge_dim=edge_dim)
    jm = jconv.GINEConv(mlp=jmodels.MLP(channel_list=[8, 8]),
                        train_eps=train_eps, eps_init=0.2)
    tm = conv.GINEConv(models.MLP(F_IN, [8, 8], device='cpu'),
                       eps_init=0.2, train_eps=train_eps, edge_dim=edge_dim)
    assert (tm.lin_edge is None) == (edge_dim == F_IN)
    _check_module(jm, tm, (jnp.asarray(coo), jnp.asarray(ea)),
                  (torch.from_numpy(coo), torch.from_numpy(ea)), x,
                  jkw={'edge_mask': jnp.asarray(mask)},
                  tkw={'edge_mask': torch.from_numpy(mask)})


GEN_CASES = {
    'softmax': dict(aggr_mode='softmax', t=0.5),
    'softmax-learn': dict(aggr_mode='softmax', learn_t=True, t=0.8),
    'powermean-learn': dict(aggr_mode='powermean', learn_p=True, p=1.5),
    'mean-msgnorm': dict(aggr_mode='mean', msg_norm=True,
                         learn_msg_scale=True),
    'max-layernorm': dict(aggr_mode='max', norm='layer_norm',
                          use_bias=True, num_layers=3),
    'add-edges': dict(aggr_mode='add', edge=True),
}


@pytest.mark.parametrize('case', sorted(GEN_CASES))
@pytest.mark.parametrize('out', [F_IN, 10])
def test_gen_conv_matches_jax(case, out):
    kw = dict(GEN_CASES[case])
    edge = kw.pop('edge', False)
    x, coo, mask, ea = _graph(6, pad=3, edge_dim=5 if edge else None)
    jm = jconv.GENConv(out_channels=out, **kw)
    tm = conv.GENConv(F_IN, out, **kw, edge_dim=5 if edge else None,
                      device='cpu')
    jargs = (jnp.asarray(coo), _j(ea), jnp.asarray(mask))
    targs = (torch.from_numpy(coo), _t(ea), torch.from_numpy(mask))
    _check_module(jm, tm, jargs, targs, x)


def test_gen_conv_batch_norm_mlp_matches_jax_in_eval():
    """GENConv's MLP with ``norm='batch_norm'``: the JAX package calls it
    with its default ``deterministic=True`` (running statistics), which is
    the port's eval mode."""
    x, coo, mask, _ = _graph(7, pad=2)
    jm = jconv.GENConv(out_channels=8, norm='batch_norm')
    tm = conv.GENConv(F_IN, 8, norm='batch_norm', device='cpu').eval()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(coo), None, jnp.asarray(mask))
    tm.load_state_dict(flax_to_state_dict(dict(variables)))
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(coo), None,
                   jnp.asarray(mask))
    _close(tm(torch.from_numpy(x), torch.from_numpy(coo), None,
              torch.from_numpy(mask)), ref)


@pytest.mark.parametrize('relations', [1, 3])
@pytest.mark.parametrize('act', ['relu', 'tanh'])
def test_film_conv_matches_jax(relations, act):
    x, coo, mask, _ = _graph(8, pad=2)
    etype = np.random.default_rng(9).integers(0, relations, coo.shape[1])
    jm = jconv.FiLMConv(out_channels=7, num_relations=relations, act=act)
    tm = conv.FiLMConv(F_IN, 7, num_relations=relations, act=act,
                       device='cpu')
    typed = relations > 1
    _check_module(jm, tm,
                  (jnp.asarray(coo), _j(etype) if typed else None,
                   jnp.asarray(mask)),
                  (torch.from_numpy(coo), _t(etype) if typed else None,
                   torch.from_numpy(mask)), x)


@pytest.mark.parametrize('normalize', [True, False])
@pytest.mark.parametrize('masked', [False, True])
def test_pdn_conv_matches_jax(normalize, masked):
    x, coo, mask, ea = _graph(10, pad=0, edge_dim=3)
    jm = jconv.PDNConv(out_channels=5, hidden_channels=6,
                       normalize=normalize)
    tm = conv.PDNConv(F_IN, 5, edge_dim=3, hidden_channels=6,
                      normalize=normalize, device='cpu')
    jm_ = _j(mask) if masked else None
    tm_ = _t(mask) if masked else None
    _check_module(jm, tm, (jnp.asarray(coo), jnp.asarray(ea), jm_),
                  (torch.from_numpy(coo), torch.from_numpy(ea), tm_), x)


GENERAL_CASES = {
    'plain': {},
    'undirected': dict(directed_msg=False),
    'attention': dict(attention=True, aggr='mean'),
    'skip-l2': dict(skip_linear=True, l2_normalize=True),
    'edges-max': dict(in_edge_channels=4, aggr='max'),
}


@pytest.mark.parametrize('case', sorted(GENERAL_CASES))
@pytest.mark.parametrize('out', [F_IN, 9])
def test_general_conv_matches_jax(case, out):
    kw = GENERAL_CASES[case]
    x, coo, mask, ea = _graph(11, pad=2, edge_dim=4)
    jm = jconv.GeneralConv(out_channels=out, **kw)
    tm = conv.GeneralConv(F_IN, out, **kw, device='cpu')
    _check_module(jm, tm, (jnp.asarray(coo), jnp.asarray(ea),
                           jnp.asarray(mask)),
                  (torch.from_numpy(coo), torch.from_numpy(ea),
                   torch.from_numpy(mask)), x)


@pytest.mark.parametrize('divide_input', [False, True])
@pytest.mark.parametrize('edges', [False, True])
@pytest.mark.parametrize('masked', [False, True])
def test_pna_conv_matches_jax(divide_input, edges, masked):
    """Unmasked, the padded edges are clamped into the last node, as the
    JAX package does; masked, they are dropped."""
    x, coo, mask, ea = _graph(12, f=8, pad=3, edge_dim=3)
    kw = dict(towers=2, pre_layers=2, post_layers=2,
              divide_input=divide_input, avg_deg_log=1.3, avg_deg_lin=3.9,
              aggregators=('mean', 'min', 'max', 'std'),
              scalers=('identity', 'amplification', 'attenuation',
                       'linear'))
    jm = jconv.PNAConv(out_channels=10, edge_dim=3 if edges else None, **kw)
    tm = conv.PNAConv(8, 10, edge_dim=3 if edges else None, **kw,
                      device='cpu')
    _check_module(jm, tm,
                  (jnp.asarray(coo), _j(ea) if edges else None,
                   _j(mask) if masked else None),
                  (torch.from_numpy(coo), _t(ea) if edges else None,
                   _t(mask) if masked else None), x)


@pytest.mark.parametrize('aggregators', [('symnorm',),
                                         ('symnorm', 'max', 'std'),
                                         ('mean', 'min', 'var')])
@pytest.mark.parametrize('self_loops', [True, False])
def test_eg_conv_matches_jax(aggregators, self_loops):
    """With self loops added, the graph's own loops are masked (the
    static-shape ``add_remaining_self_loops``)."""
    x, coo, mask, _ = _graph(13, pad=0)
    coo[:, :4] = np.array([[0, 3, 5, 5], [0, 3, 5, 5]])   # original loops
    jm = jconv.EGConv(out_channels=8, aggregators=aggregators, num_heads=2,
                      num_bases=3, add_self_loops=self_loops)
    tm = conv.EGConv(F_IN, 8, aggregators=aggregators, num_heads=2,
                     num_bases=3, add_self_loops=self_loops, device='cpu')
    masked = self_loops or 'symnorm' in aggregators
    _check_module(jm, tm, (jnp.asarray(coo),
                           jnp.asarray(mask) if masked else None),
                  (torch.from_numpy(coo),
                   torch.from_numpy(mask) if masked else None), x)


def test_edge_conv_matches_jax():
    """A flax EdgeConv built on its own keeps its network under ``nn``;
    the port keeps it as ``mlp`` (EdgeCNN's name), so the test renames."""
    x, coo, mask, _ = _graph(14, pad=2)
    jm = jconv.EdgeConv(nn=jmodels.MLP(channel_list=[8, 5]))
    tm = conv.EdgeConv(models.MLP(2 * F_IN, [8, 5], device='cpu'))

    def rename(tree):
        return {'params': {'mlp': tree['params']['nn']}}
    _check_module(jm, tm, (jnp.asarray(coo), jnp.asarray(mask)),
                  (torch.from_numpy(coo), torch.from_numpy(mask)), x,
                  sd_map=rename)


@pytest.mark.parametrize('norm', [None, 'batch_norm'])
def test_edge_cnn_matches_jax(norm):
    x, coo, mask, _ = _graph(15, pad=2)
    jm = jmodels.EdgeCNN(hidden_channels=8, num_layers=2, out_channels=3,
                         norm=norm)
    tm = models.EdgeCNN(F_IN, 8, 2, 3, norm=norm, device='cpu').eval()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(coo), edge_mask=jnp.asarray(mask))
    tm.load_state_dict(flax_to_state_dict(dict(variables)))
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(coo),
                   edge_mask=jnp.asarray(mask))
    _close(tm(torch.from_numpy(x), torch.from_numpy(coo),
              edge_mask=torch.from_numpy(mask)), ref)
    if norm is None:
        _check_module(jm, tm.train(), (jnp.asarray(coo),),
                      (torch.from_numpy(coo),), x,
                      jkw={'edge_mask': jnp.asarray(mask)},
                      tkw={'edge_mask': torch.from_numpy(mask)})


@pytest.mark.parametrize('jk', [None, 'cat'])
def test_pna_model_matches_jax(jk):
    x, coo, mask, ea = _graph(16, pad=2, edge_dim=3)
    ckw = dict(towers=2, edge_dim=3, avg_deg_log=1.2, avg_deg_lin=3.0)
    jm = jmodels.PNA(hidden_channels=8, num_layers=2, out_channels=4, jk=jk,
                     conv_kwargs=ckw)
    tm = models.PNA(F_IN, 8, 2, 4, jk=jk, conv_kwargs=ckw, device='cpu')
    _check_module(jm, tm, (jnp.asarray(coo),),
                  (torch.from_numpy(coo),), x,
                  jkw={'edge_attr': jnp.asarray(ea),
                       'edge_mask': jnp.asarray(mask)},
                  tkw={'edge_attr': torch.from_numpy(ea),
                       'edge_mask': torch.from_numpy(mask)})


def test_new_convs_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for build in (lambda: conv.GENConv(4, 4), lambda: conv.FiLMConv(4, 4),
                  lambda: conv.PDNConv(4, 4, 2),
                  lambda: conv.GeneralConv(4, 4), lambda: conv.PNAConv(4, 4),
                  lambda: conv.EGConv(4, 8), lambda: models.PNA(4, 4, 2),
                  lambda: models.EdgeCNN(4, 4, 2),
                  lambda: models.MLP(4, [4], norm='batch_norm')):
        with pytest.raises(RuntimeError, match='no CUDA card'):
            build()


# -- MessagePassing: aggregation modules, lists, edge_updater, debug ----------
class _JAggrConv(JMessagePassing):
    aggr: Any = 'sum'

    @fnn.compact
    def __call__(self, x, ei, edge_mask=None):
        return self.propagate(ei, x=x, edge_mask=edge_mask)


class _TAggrConv(MessagePassing):
    def __init__(self, aggr_):
        super().__init__()
        self.aggr = aggr_

    def forward(self, x, ei, edge_mask=None):
        return self.propagate(ei, x=x, edge_mask=edge_mask)


@pytest.mark.parametrize('case', ['module', 'learnable-module', 'list',
                                  'multi'])
@pytest.mark.parametrize('layout', ['coo', 'edge_index'])
def test_message_passing_aggregations_match_jax(case, layout):
    """An ``Aggregation`` module or a list as ``aggr``; over an
    ``EdgeIndex`` the fused route is not taken for them (it serves only
    sum / mean / min / max by name)."""
    x, coo, mask, _ = _graph(17, pad=0)
    jagg, tagg = {
        'module': (jaggr.StdAggregation(), aggr.StdAggregation()),
        'learnable-module': (
            jaggr.SoftmaxAggregation(learn=True, t=0.6),
            aggr.SoftmaxAggregation(learn=True, t=0.6, device='cpu')),
        'list': (['sum', 'max', 'mean'], ['sum', 'max', 'mean']),
        'multi': (jaggr.MultiAggregation(aggrs=('min', 'var')),
                  aggr.MultiAggregation(aggrs=('min', 'var'))),
    }[case]
    ei_j = (jnp.asarray(coo) if layout == 'coo'
            else JEdgeIndex(coo, (N, N)).fill_cache())
    ei_t = (torch.from_numpy(coo) if layout == 'coo'
            else EdgeIndex(coo, (N, N), device='cpu').fill_cache())
    # an EdgeIndex call takes no mask: it would force the gather path
    jm_ = jnp.asarray(mask) if layout == 'coo' else None
    tm_ = torch.from_numpy(mask) if layout == 'coo' else None

    def rename(tree):
        return {'params': {'aggr': tree['params']['aggr']}} if \
            tree.get('params') else tree
    _check_module(_JAggrConv(aggr=jagg), _TAggrConv(tagg), (ei_j, jm_),
                  (ei_t, tm_), x, sd_map=rename)


class _JEdgeScore(JMessagePassing):
    @fnn.compact
    def __call__(self, x, ei, edge_mask=None):
        return self.edge_updater(ei, x=x, edge_mask=edge_mask)

    def edge_update(self, x_i, x_j, edge_mask=None):
        s = (x_i * x_j).sum(-1)
        return s if edge_mask is None else jnp.where(edge_mask, s, 0.0)


class _TEdgeScore(MessagePassing):
    def forward(self, x, ei, edge_mask=None):
        return self.edge_updater(ei, x=x, edge_mask=edge_mask)

    def edge_update(self, x_i, x_j, edge_mask=None):
        s = (x_i * x_j).sum(-1)
        return s if edge_mask is None else torch.where(edge_mask, s, 0.0)


def test_edge_updater_matches_jax():
    x, coo, mask, _ = _graph(18, pad=3)
    out = _check_module(_JEdgeScore(), _TEdgeScore(),
                        (jnp.asarray(coo), jnp.asarray(mask)),
                        (torch.from_numpy(coo), torch.from_numpy(mask)), x)
    assert out.shape == (coo.shape[1],)


@pytest.mark.parametrize('bad', [-1, N + 1])
def test_debug_bounds_check_matches_jax(bad):
    """Under ``experimental.debug()`` both packages refuse an endpoint
    below 0 or past the padding sentinel ``n``, in ``propagate`` and in
    ``edge_updater``; ``n`` itself (padding) passes; off by default."""
    x, coo, _, _ = _graph(19, pad=1)
    coo_bad = coo.copy()
    coo_bad[1, 3] = bad
    tx = torch.from_numpy(x)
    for tm in (_TAggrConv('sum'), _TEdgeScore()):
        tm(tx, torch.from_numpy(coo_bad))       # off: no check
        with experimental.debug():
            tm(tx, torch.from_numpy(coo))       # the sentinel passes
            with pytest.raises(IndexError, match='destination'):
                tm(tx, torch.from_numpy(coo_bad))
    with jexperimental.debug():
        with pytest.raises(IndexError, match='destination'):
            _JAggrConv().init(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(coo_bad))
    assert not experimental.is_debug_enabled()
    with experimental.set_debug(True):
        assert experimental.is_debug_enabled()
    assert not experimental.is_debug_enabled()


# -- paths V and W at narrow widths, three Adam steps -------------------------
def _synced_adam_steps(jloss, variables, lr, jbatches, tm, tloss,
                       tbatches):
    """Three optax Adam steps of the flax model; before each, the port's
    model takes the flax parameters (its running statistics stay its own,
    updated by its own forwards) and its loss and gradients on the same
    batch are held to flax's. After the steps, the running statistics.

    The port's model is held at flax's parameters at every step rather
    than trained on its own: Adam's first steps move each parameter by
    about ``lr`` whatever the size of its gradient, so a gradient that a
    batch norm cancels (rounding noise of random sign on each side) moves
    the two float32 runs apart by ``lr`` a step in parameters that the
    next batch does feel."""
    params, stats = variables['params'], variables['batch_stats']
    tm.load_state_dict(flax_to_state_dict(dict(variables)))
    tm.train()
    tx = optax.adam(lr)
    opt = tx.init(params)
    for step, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        (loss, new_stats), g = jax.value_and_grad(jloss, has_aux=True)(
            params, stats, *jb)
        missing = tm.load_state_dict(flax_to_state_dict({'params': params}),
                                     strict=False).missing_keys
        assert missing and all('running' in k for k in missing), missing
        tm.zero_grad(set_to_none=True)
        tl = tloss(*tb)
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-4,
                                   err_msg=f'loss, step {step}')
        jgrads = flax_to_state_dict({'params': g})
        floor = _noise_floor(np.zeros(1), jgrads)
        for k, p in tm.named_parameters():
            _grad_close(p.grad, jgrads[k].numpy(), f'{k}, step {step}',
                        floor)
        upd, opt = tx.update(g, opt)
        params, stats = optax.apply_updates(params, upd), new_stats
    _stats_close(tm, stats)
    return params, stats


def _stats_close(tm, stats):
    want = flax_to_state_dict({'params': {}, 'batch_stats': stats})
    got = {k: v for k, v in tm.state_dict().items() if 'running' in k}
    assert set(got) == set(want) and got
    for k in want:
        _close(got[k], want[k].numpy(), k)


class _JPNANet(fnn.Module):
    """``chip_smoke.py::pna_zinc_net`` in flax."""
    hidden: int
    edge_dim: int
    layers: int
    towers: int
    mlp: tuple
    avg_deg_log: float
    avg_deg_lin: float

    @fnn.compact
    def __call__(self, atoms, coo, bonds, batch, num_graphs, training):
        cs = _chip_smoke()
        x = fnn.Embed(cs.ZINC_ATOMS, self.hidden, name='node_emb')(atoms)
        e = fnn.Embed(cs.ZINC_BONDS, self.edge_dim, name='edge_emb')(bonds)
        for i in range(self.layers):
            x = jconv.PNAConv(
                out_channels=self.hidden, aggregators=cs.PV_AGGREGATORS,
                scalers=cs.PV_SCALERS, avg_deg_log=self.avg_deg_log,
                avg_deg_lin=self.avg_deg_lin, towers=self.towers,
                edge_dim=self.edge_dim, name=f'conv_{i}')(x, coo, e)
            x = jax.nn.relu(JBatchNorm(in_channels=self.hidden,
                                       name=f'norm_{i}')(x, training))
        x = jglob.global_add_pool(x, batch, num_graphs)
        return jmodels.MLP(channel_list=list(self.mlp), name='mlp')(x)[:, 0]


def test_path_v_steps_match_jax():
    """Path V's model (PNA on ZINC's shape) at hidden 20, edge width 8, 2
    layers of 2 towers: three Adam steps (L1 loss, Adam 1e-3) over batches
    of ``chip_smoke.py::zinc_like`` graphs collated by the port's
    ``DataLoader(pad=False)`` and the JAX package's ``Batch``
    (``_synced_adam_steps``: each step's loss and gradients, the running
    statistics after the steps), an eval forward; the degree statistics
    against numpy."""
    cs = _chip_smoke()
    graphs = cs.zinc_like(36, seed=3)
    hist, log_avg, lin_avg = cs.pna_degree_stats(graphs)
    degs = np.concatenate([np.bincount(c[1], minlength=len(a))
                           for a, c, _, _ in graphs])
    np.testing.assert_array_equal(hist, np.bincount(degs))
    assert np.isclose(lin_avg, degs.mean())
    assert np.isclose(log_avg, np.log(degs + 1).mean())
    dims = dict(hidden=20, edge_dim=8, layers=2, towers=2, mlp=(10, 5, 1))
    data = [Data(x=a, edge_index=c, edge_attr=b, y=y, num_nodes=len(a))
            for a, c, b, y in graphs]
    tbatches = list(DataLoader(data, batch_size=12, pad=False))
    jbatches = []
    for i in range(0, 36, 12):
        jb = JBatch.from_data_list([
            JData(x=a, edge_index=c, edge_attr=b, y=y, num_nodes=len(a))
            for a, c, b, y in graphs[i:i + 12]])
        jbatches.append((jnp.asarray(jb.x), jnp.asarray(jb.edge_index.coo
                                                        if hasattr(
                                                            jb.edge_index,
                                                            'coo')
                                                        else jb.edge_index),
                         jnp.asarray(jb.edge_attr), jnp.asarray(jb.batch),
                         jnp.asarray(jb.y)))
    for tb, jb in zip(tbatches, jbatches):
        np.testing.assert_array_equal(tb.edge_index.coo.numpy(),
                                      np.asarray(jb[1]))
    jm = _JPNANet(avg_deg_log=log_avg, avg_deg_lin=lin_avg, **dims)
    variables = jm.init(jax.random.PRNGKey(0), *jbatches[0][:4], 12, True)

    def jloss(p, st, atoms, coo, bonds, batch, y):
        out, upd = jm.apply({'params': p, 'batch_stats': st}, atoms, coo,
                            bonds, batch, 12, True, mutable=['batch_stats'])
        return jnp.abs(out - y).mean(), upd['batch_stats']

    tm = cs.pna_zinc_net(torch, 'cpu', 0, log_avg, lin_avg, **dims)

    def tloss(b):
        out = tm(b.x, b.edge_index.coo, b.edge_attr, b.batch, b.num_graphs)
        return (out - b.y).abs().mean()

    params, stats = _synced_adam_steps(jloss, variables, 1e-3, jbatches, tm,
                                       tloss, [(b,) for b in tbatches])
    tm.load_state_dict(flax_to_state_dict({'params': params}), strict=False)
    tm.eval()
    b, jb = tbatches[0], jbatches[0]
    ref = jm.apply({'params': params, 'batch_stats': stats}, *jb[:4], 12,
                   False)
    with torch.no_grad():
        _close(tm(b.x, b.edge_index.coo, b.edge_attr, b.batch, 12), ref)


class _JGINNet(fnn.Module):
    """``chip_smoke.py::gin_collab_net`` in flax."""
    hidden: int
    layers: int
    classes: int

    @fnn.compact
    def __call__(self, x, ei, batch, num_graphs, training):
        h = jmodels.GIN(hidden_channels=self.hidden, num_layers=self.layers,
                        norm='batch_norm', jk='cat', name='gnn')(
            x, ei, deterministic=not training)
        return fnn.Dense(self.classes, name='lin')(
            jglob.global_add_pool(h, batch, num_graphs))


def test_path_w_steps_match_jax():
    """Path W's model (GIN with batch norm, ``jk='cat'``, on COLLAB's
    shape) at hidden 16 and 3 layers over ``chip_smoke.py::collab_graph``
    graphs (one-hot degree, 492 wide): three Adam steps (cross-entropy,
    Adam 0.01) over each batch's ``EdgeIndex`` (the fused SpMM: kernel 1's
    plain version here; ``_synced_adam_steps``: each step's loss and
    gradients, the running statistics after the steps), an eval
    forward."""
    cs = _chip_smoke()
    plan = cs.collab_like(seed=1)
    # small graphs of the plan, so that the test stays quick
    small = [i for i in range(len(plan[0])) if plan[0][i] <= 40][:24]
    graphs = [cs.collab_graph(i, plan, seed=1) for i in small]
    assert all(x.shape[1] == cs.COLLAB_F for x, _, _ in graphs)
    for x, coo, _ in graphs:
        np.testing.assert_array_equal(
            x.argmax(1), np.bincount(coo[1], minlength=len(x)))
    dims = dict(hidden=16, layers=3, classes=cs.COLLAB_C)
    data = [Data(x=x, edge_index=c, y=y, num_nodes=len(x))
            for x, c, y in graphs]
    tbatches, jbatches = [], []
    for b in DataLoader(data, batch_size=8, pad=False):
        n = b.num_nodes
        coo = b.edge_index.coo.numpy()
        tbatches.append((b.x, EdgeIndex(coo, (n, n), device='cpu')
                         .fill_cache(blocked=False), b.batch, b.y.long()))
        jbatches.append((jnp.asarray(b.x.numpy()),
                         JEdgeIndex(coo, (n, n)).fill_cache(),
                         jnp.asarray(b.batch.numpy()),
                         jnp.asarray(b.y.numpy())))
    jm = _JGINNet(**dims)
    variables = jm.init(jax.random.PRNGKey(1), *jbatches[0][:3], 8, True)

    def jloss(p, st, x, ei, batch, y):
        out, upd = jm.apply({'params': p, 'batch_stats': st}, x, ei, batch,
                            8, True, mutable=['batch_stats'])
        ce = optax.softmax_cross_entropy_with_integer_labels(out, y)
        return ce.mean(), upd['batch_stats']

    tm = cs.gin_collab_net(torch, 'cpu', 0, hidden=16, layers=3)

    def tloss(x, ei, batch, y):
        return F.cross_entropy(tm(x, ei, batch, 8), y)

    params, stats = _synced_adam_steps(jloss, variables, 0.01, jbatches, tm,
                                       tloss, tbatches)
    tm.load_state_dict(flax_to_state_dict({'params': params}), strict=False)
    tm.eval()
    ref = jm.apply({'params': params, 'batch_stats': stats},
                   *jbatches[0][:3], 8, False)
    with torch.no_grad():
        _close(tm(*tbatches[0][:3], 8), ref)


# -- convert.py's rules for this slice's modules -------------------------------
def test_convert_rules_for_graph_level_modules():
    """Each rule ``convert.flax_to_state_dict`` gained for this slice, on a
    synthetic tree: batch statistics, PNA's towers, FiLM's relations, an
    ``mlp_i`` that is one Dense (PDNConv's) against one that is an MLP
    (GIN's, EdgeCNN's), a flax ``Embed``, a ``scale`` beside a ``bias``
    against MsgNorm's lone one, and Set2Set's LSTM cell."""
    rng = np.random.default_rng(0)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dense = {'kernel': arr(3, 2), 'bias': arr(2)}
    cell = {f'i{g}': {'kernel': arr(4, 2)} for g in 'ifgo'}
    cell.update({f'h{g}': {'kernel': arr(2, 2), 'bias': arr(2)}
                 for g in 'ifgo'})
    tree = {'params': {
        'conv_0': {'pre_1': {'lin_0': dense}, 'post_0': {'lin_0': dense},
                   'edge_enc_1': dense, 'lin_out': dense},
        'film': {'film_2': dense, 'lin_1': dense},
        'pdn': {'mlp_0': dense, 'mlp_1': dense},
        'mlp_3': {'lin_0': dense},
        'node_emb': {'embedding': arr(5, 3)},
        'norm_0': {'bn': {'scale': arr(3), 'bias': arr(3)}},
        'msg_norm': {'scale': arr(1)},
        'lstm': cell},
        'batch_stats': {'norm_0': {'bn': {'mean': arr(3), 'var': arr(3)}}}}
    sd = flax_to_state_dict(tree)
    p = tree['params']
    want = {
        'convs.0.pre_nns.1.lins.0.weight': dense['kernel'].T,
        'convs.0.post_nns.0.lins.0.bias': dense['bias'],
        'convs.0.edge_encoders.1.weight': dense['kernel'].T,
        'convs.0.lin_out.weight': dense['kernel'].T,
        'film.films.2.weight': dense['kernel'].T,
        'film.lins.1.bias': dense['bias'],
        'pdn.mlp_0.weight': dense['kernel'].T,
        'pdn.mlp_1.bias': dense['bias'],
        'convs.3.mlp.lins.0.weight': dense['kernel'].T,
        'node_emb.weight': p['node_emb']['embedding'],
        'norms.0.bn.weight': p['norm_0']['bn']['scale'],
        'norms.0.bn.running_mean': tree['batch_stats']['norm_0']['bn'][
            'mean'],
        'norms.0.bn.running_var': tree['batch_stats']['norm_0']['bn'][
            'var'],
        'msg_norm.scale': p['msg_norm']['scale'],
        'lstm.weight_ih': np.concatenate([cell[f'i{g}']['kernel'].T
                                          for g in 'ifgo']),
        'lstm.weight_hh': np.concatenate([cell[f'h{g}']['kernel'].T
                                          for g in 'ifgo']),
        'lstm.bias_hh': np.concatenate([cell[f'h{g}']['bias']
                                        for g in 'ifgo'])}
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert 'lstm.bias_ih' not in sd and 'norms.0.bn.bias' in sd
    # a BatchNorm without affine has batch statistics and no parameters
    sd = flax_to_state_dict({'batch_stats': {'bn': {'mean': arr(2),
                                                    'var': arr(2)}}})
    assert set(sd) == {'bn.running_mean', 'bn.running_var'}


def test_convert_ignores_other_collections():
    """A flax variables dict holding collections besides ``params`` and
    ``batch_stats`` (``intermediates``, ``cache``, ``losses``) is unwrapped
    all the same, and only the state is carried."""
    rng = np.random.default_rng(1)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dense = {'kernel': arr(3, 2), 'bias': arr(2)}
    sd = flax_to_state_dict({'params': {'lin': dense},
                             'batch_stats': {'bn': {'mean': arr(2),
                                                    'var': arr(2)}},
                             'intermediates': {'lin': {'out': arr(2)}},
                             'cache': {'k': arr(2)}})
    assert set(sd) == {'lin.weight', 'lin.bias', 'bn.running_mean',
                       'bn.running_var'}
    np.testing.assert_array_equal(sd['lin.weight'].numpy(), dense['kernel'].T)
    assert set(flax_to_state_dict({'params': {'lin': dense},
                                   'losses': {'l2': arr(1)}})) == {
        'lin.weight', 'lin.bias'}
