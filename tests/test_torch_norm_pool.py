"""The port's normalisation layers (``nn/norm/norms.py``) and global
pooling (``nn/pool/glob.py``) against the JAX package's, on the CPU.

Every norm runs on the same numpy inputs in both packages, its flax
parameters (and batch statistics) carried across by
``convert.flax_to_state_dict``: the batch norms in training mode (flax's
``use_running_average=False``, the port's ``module.train()``) for three
steps, their running statistics after them, then in eval mode; the
per-graph norms over a padded batch with a node mask. Tolerances: outputs
and running statistics within 1e-5 * max(1, max|ref|) (both packages take
the fast variance E[x^2] - E[x]^2, flax's ``use_fast_variance``, in
another summation order; the inputs sit at mean 3 and standard deviation
2, so the cancellation costs about 13 / 4 of float32's rounding), gradients
within 1e-4 of each gradient's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.nn import norm as jnorm
from pytorch_geometric_tpu.nn.pool import glob as jglob
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.nn import norm, pool

N, F, GRAPHS = 40, 5, 4


def _close(got, ref, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = 1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _grad_close(got, ref, what=''):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = 1e-4 * max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _x(seed, n=N, f=F):
    rng = np.random.default_rng(seed)
    return (3 + 2 * rng.standard_normal((n, f))).astype(np.float32)


def _batch(seed):
    """Four graphs of 9, 12, 7 and 8 nodes, then four padded rows whose
    graph id is ``GRAPHS``; the mask marks the real rows."""
    batch = np.repeat(np.arange(GRAPHS + 1), [9, 12, 7, 8, 4]).astype(
        np.int32)
    mask = batch < GRAPHS
    return batch, mask


# -- batch norms: three training steps, running statistics, eval --------------
@pytest.mark.parametrize('kind', ['BatchNorm', 'BatchNorm-plain',
                                  'BatchNorm-momentum', 'DiffGroupNorm'])
def test_batch_norms_train_and_eval_match_jax(kind):
    if kind == 'DiffGroupNorm':
        jm = jnorm.DiffGroupNorm(in_channels=F, groups=3, lamda=0.3)
        tm = norm.DiffGroupNorm(F, groups=3, lamda=0.3, device='cpu')
    else:
        kw = {'BatchNorm': {}, 'BatchNorm-plain': {'affine': False},
              'BatchNorm-momentum': {'momentum': 0.3, 'eps': 1e-3}}[kind]
        jm = jnorm.BatchNorm(in_channels=F, **kw)
        tm = norm.BatchNorm(F, device='cpu', **kw)
    xs = [_x(s) for s in range(3)]
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    params = variables.get('params', {})
    stats = variables['batch_stats']
    tm.load_state_dict(flax_to_state_dict(dict(variables)))
    tm.train()
    cot = np.random.default_rng(9).standard_normal((N, F)).astype(
        np.float32)
    for step, x in enumerate(xs):
        def jf(p, xin, st):
            out, upd = jm.apply({'params': p, 'batch_stats': st}, xin,
                                training=True, mutable=['batch_stats'])
            return (out * cot).sum(), (out, upd['batch_stats'])

        (_, (ref, stats)), (jgp, jgx) = jax.value_and_grad(
            jf, (0, 1), has_aux=True)(params, jnp.asarray(x), stats)
        tx = torch.from_numpy(x).requires_grad_()
        tm.zero_grad()
        out = tm(tx)
        _close(out, ref, f'step {step}')
        (out * torch.from_numpy(cot)).sum().backward()
        _grad_close(tx.grad, jgx, f'grad x, step {step}')
        jgrads = flax_to_state_dict(jgp) if jgp else {}
        named = dict(tm.named_parameters())
        assert set(named) == set(jgrads)
        for k, p in named.items():
            _grad_close(p.grad, jgrads[k].numpy(), f'{k}, step {step}')
    # the running statistics after three steps
    want = flax_to_state_dict({'params': {}, 'batch_stats': stats})
    got = {k: v for k, v in tm.state_dict().items() if 'running' in k}
    assert set(got) == set(want) and got
    for k in want:
        _close(got[k], want[k].numpy(), k)
    # eval mode: the running statistics
    tm.eval()
    x = _x(5)
    ref = jm.apply({'params': params, 'batch_stats': stats},
                   jnp.asarray(x), training=False)
    _close(tm(torch.from_numpy(x)), ref, 'eval')


def test_batch_norm_is_not_batchnorm1d():
    """The running variance takes the biased batch variance (flax), where
    ``torch.nn.BatchNorm1d`` takes the unbiased one."""
    x = torch.from_numpy(_x(3))
    bn = norm.BatchNorm(F, device='cpu')
    ref = torch.nn.BatchNorm1d(F, momentum=0.1)
    bn(x), ref(x)
    biased = x.var(0, unbiased=False)
    torch.testing.assert_close(bn.bn.running_var, 0.9 + 0.1 * biased)
    assert not torch.allclose(bn.bn.running_var, ref.running_var,
                              rtol=1e-4, atol=0)


# -- the per-graph norms ---------------------------------------------------------
def _graph_norm_pair(name):
    return {
        'InstanceNorm': (jnorm.InstanceNorm(in_channels=F),
                         norm.InstanceNorm(F, device='cpu')),
        'InstanceNorm-affine': (
            jnorm.InstanceNorm(in_channels=F, affine=True),
            norm.InstanceNorm(F, affine=True, device='cpu')),
        'LayerNorm-graph': (jnorm.LayerNorm(in_channels=F),
                            norm.LayerNorm(F, device='cpu')),
        'LayerNorm-graph-plain': (
            jnorm.LayerNorm(in_channels=F, affine=False),
            norm.LayerNorm(F, affine=False, device='cpu')),
        'LayerNorm-node': (jnorm.LayerNorm(in_channels=F, mode='node'),
                           norm.LayerNorm(F, mode='node', device='cpu')),
        'GraphNorm': (jnorm.GraphNorm(in_channels=F),
                      norm.GraphNorm(F, device='cpu')),
        'GraphSizeNorm': (jnorm.GraphSizeNorm(), norm.GraphSizeNorm()),
        'PairNorm': (jnorm.PairNorm(scale=1.5), norm.PairNorm(scale=1.5)),
        'PairNorm-SI': (jnorm.PairNorm(scale_individually=True),
                        norm.PairNorm(scale_individually=True)),
        'MeanSubtractionNorm': (jnorm.MeanSubtractionNorm(),
                                norm.MeanSubtractionNorm()),
    }[name]


def _perturb(tm, seed):
    """Move the port's affine parameters off their initial values, so the
    test sees them act (``_flax_params`` carries them back to flax)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(torch.from_numpy(
                0.3 * rng.standard_normal(p.shape).astype(np.float32)))


@pytest.mark.parametrize('padded', [False, True], ids=['plain', 'padded'])
@pytest.mark.parametrize('name', [
    'InstanceNorm', 'InstanceNorm-affine', 'LayerNorm-graph',
    'LayerNorm-graph-plain', 'LayerNorm-node', 'GraphNorm',
    'GraphSizeNorm', 'PairNorm', 'PairNorm-SI', 'MeanSubtractionNorm'])
def test_graph_norms_match_jax(name, padded):
    jm, tm = _graph_norm_pair(name)
    x = _x(len(name))
    batch, mask = _batch(1)
    jmask = jnp.asarray(mask) if padded else None
    tmask = torch.from_numpy(mask) if padded else None
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                     jnp.asarray(batch), GRAPHS, jmask)
    if params:
        tm.load_state_dict(flax_to_state_dict(params))
        _perturb(tm, 3)
        params = {'params': jax.tree_util.tree_map(
            jnp.asarray, _flax_params(tm, params['params']))}
    cot = np.random.default_rng(2).standard_normal((N, F)).astype(
        np.float32)

    def jf(p, xin):
        out = jm.apply(p, xin, jnp.asarray(batch), GRAPHS, jmask)
        return (out * cot).sum(), out

    (_, ref), (jgp, jgx) = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx, torch.from_numpy(batch), GRAPHS, tmask)
    _close(out, ref)
    (out * torch.from_numpy(cot)).sum().backward()
    _grad_close(tx.grad, jgx, 'grad x')
    jgrads = flax_to_state_dict(jgp) if jgp else {}
    for k, p in tm.named_parameters():
        _grad_close(p.grad, jgrads[k].numpy(), k)


def _flax_params(tm, like):
    """The port's parameters back in flax's tree (``like``'s layout)."""
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            if hasattr(v, 'items'):
                out[k] = walk(v, prefix + (k,))
            else:
                leaf = 'weight' if k == 'scale' and 'bias' in tree else k
                out[k] = sd['.'.join(prefix + (leaf,))]
        return out
    return walk(like, ())


@pytest.mark.parametrize('masked', [False, True])
def test_mean_subtraction_without_batch_matches_jax(masked):
    x = _x(7)
    _, mask = _batch(0)
    jmask = jnp.asarray(mask) if masked else None
    ref = jnorm.MeanSubtractionNorm().apply({}, jnp.asarray(x), None, 1,
                                            jmask)
    got = norm.MeanSubtractionNorm()(torch.from_numpy(x), None, 1,
                                     torch.from_numpy(mask) if masked
                                     else None)
    _close(got, ref)


@pytest.mark.parametrize('learn', [False, True])
def test_msg_norm_matches_jax(learn):
    x, msg = _x(8), _x(9) - 3
    jm = jnorm.MsgNorm(learn_scale=learn)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(msg))
    tm = norm.MsgNorm(learn_scale=learn, device='cpu')
    sd = flax_to_state_dict(params) if params else {}
    assert set(sd) == ({'scale'} if learn else set())
    tm.load_state_dict(sd)
    cot = np.random.default_rng(3).standard_normal((N, F)).astype(
        np.float32)

    def jf(p, a, b):
        return (jm.apply(p, a, b) * cot).sum()

    jgp, ga, gb = jax.grad(jf, (0, 1, 2))(params, jnp.asarray(x),
                                          jnp.asarray(msg))
    ta = torch.from_numpy(x).requires_grad_()
    tb = torch.from_numpy(msg).requires_grad_()
    out = tm(ta, tb)
    _close(out, jm.apply(params, jnp.asarray(x), jnp.asarray(msg)))
    (out * torch.from_numpy(cot)).sum().backward()
    _grad_close(ta.grad, ga)
    _grad_close(tb.grad, gb)
    if learn:
        _grad_close(tm.scale.grad, jgp['params']['scale'])


@pytest.mark.parametrize('kind', ['HeteroBatchNorm', 'HeteroLayerNorm'])
def test_hetero_norms_match_jax(kind):
    x = _x(10)
    types = np.random.default_rng(4).integers(0, 3, N).astype(np.int32)
    jm = getattr(jnorm, kind)(in_channels=F, num_types=3)
    tm = getattr(norm, kind)(F, num_types=3, device='cpu')
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                     jnp.asarray(types))
    tm.load_state_dict(flax_to_state_dict(params))
    _perturb(tm, 5)
    params = {'params': _flax_params(tm, params['params'])}
    cot = np.random.default_rng(6).standard_normal((N, F)).astype(
        np.float32)

    def jf(p, xin):
        return (jm.apply(p, xin, jnp.asarray(types)) * cot).sum()

    jgp, jgx = jax.grad(jf, (0, 1))(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx, torch.from_numpy(types))
    _close(out, jm.apply(params, jnp.asarray(x), jnp.asarray(types)))
    (out * torch.from_numpy(cot)).sum().backward()
    _grad_close(tx.grad, jgx)
    for k, p in tm.named_parameters():
        _grad_close(p.grad, flax_to_state_dict(jgp)[k].numpy(), k)


# -- global pooling ------------------------------------------------------------
@pytest.mark.parametrize('op', ['global_add_pool', 'global_mean_pool',
                                'global_max_pool'])
@pytest.mark.parametrize('mode', ['no-batch', 'batch', 'padded'])
def test_global_pooling_matches_jax(op, mode):
    x = _x(11) - 3
    batch, mask = _batch(0)
    # graph 2 has no real node in the padded case: its max and mean are 0
    if mode == 'padded':
        batch = batch.copy()
        batch[21:28] = GRAPHS
        mask = batch < GRAPHS
    jb = None if mode == 'no-batch' else jnp.asarray(batch)
    tb = None if mode == 'no-batch' else torch.from_numpy(batch)
    jmask = jnp.asarray(mask) if mode == 'padded' else None
    tmask = torch.from_numpy(mask) if mode == 'padded' else None

    def jf(xin):
        return getattr(jglob, op)(xin, jb, GRAPHS, jmask)

    ref = jf(jnp.asarray(x))
    cot = np.random.default_rng(7).standard_normal(ref.shape).astype(
        np.float32)
    jgx = jax.grad(lambda xin: (jf(xin) * cot).sum())(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = getattr(pool, op)(tx, tb, GRAPHS, tmask)
    _close(out, ref)
    (out * torch.from_numpy(cot)).sum().backward()
    _grad_close(tx.grad, jgx)
    if mode == 'padded' and op != 'global_add_pool':
        assert (out[2] == 0).all()


@pytest.mark.parametrize('op', ['avg_pool_neighbor_x', 'max_pool_neighbor_x'])
@pytest.mark.parametrize('flow', ['source_to_target', 'target_to_source'])
def test_pool_neighbor_x_matches_jax(op, flow):
    rng = np.random.default_rng(12)
    coo = rng.integers(0, 20, (2, 70)).astype(np.int32)
    x = rng.standard_normal((20, 3)).astype(np.float32)
    ref = getattr(jglob, op)(JData(x=x, edge_index=coo, num_nodes=20),
                             flow).x
    got = getattr(pool, op)(Data(x=x, edge_index=coo, num_nodes=20), flow).x
    _close(got, ref)
