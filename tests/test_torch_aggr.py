"""The port's aggregations (``nn/aggr``) and the graph utilities they stand
on (``utils/core.py``, ``utils/dense.py``) against the JAX package's, on
the CPU.

Every aggregation of ``nn/aggr/{basic,multi,attention}.py`` runs on the
same numpy inputs in both packages, with a ``mask``, empty segments and
padded rows whose index equals ``dim_size``; the learnable ones get the
flax parameters through ``convert.flax_to_state_dict``. Tolerances: the
output within 1e-5 * max(1, max|ref|), the gradients (input and every
parameter, of ``sum(out * cot)``) within 1e-4 of each gradient's largest
entry."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.nn import aggr as jaggr
from pytorch_geometric_tpu.utils import core as jcore
from pytorch_geometric_tpu.utils import dense as jdense
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import aggr
from pytorch_geometric_tpu_torch.nn.inits import linear
from pytorch_geometric_tpu_torch.utils import core, dense

N, F, SEGMENTS = 48, 6, 9


def _inputs(seed, f=F):
    """Rows in segments 0-8 but never 4 or 7 (empty), four rows padded
    to ``index == SEGMENTS``, a random mask."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, f)).astype(np.float32)
    index = rng.choice([0, 1, 2, 3, 5, 6, 8], N).astype(np.int32)
    index[rng.choice(N, 4, replace=False)] = SEGMENTS
    mask = rng.random(N) < 0.8
    return x, index, mask


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


def _run(jm, tm, x, index, mask, use_mask, seed=0, jax_grads=True):
    """Forward and gradients of both modules; the port's module gets the
    flax parameters. A parameter gradient that vanishes in exact
    arithmetic (a softmax gate's bias: the softmax ignores a shift) is
    held within 1e-6 of the input gradient's largest entry instead."""
    jmask = jnp.asarray(mask) if use_mask else None
    tmask = torch.from_numpy(mask) if use_mask else None
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                     jnp.asarray(index), SEGMENTS, jmask)
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(index), SEGMENTS,
                   jmask)
    cot = np.random.default_rng(seed + 1).standard_normal(
        ref.shape).astype(np.float32)
    sd = flax_to_state_dict(params) if params else {}
    tm.load_state_dict(sd)
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx, torch.from_numpy(index), SEGMENTS, tmask)
    _close(out, ref, 'output')
    if not jax_grads:
        return out

    def jf(p, xs):
        return (jm.apply(p, xs, jnp.asarray(index), SEGMENTS, jmask)
                * cot).sum()

    jgp, jgx = jax.grad(jf, (0, 1))(params, jnp.asarray(x))
    (out * torch.from_numpy(cot)).sum().backward()
    _grad_close(tx.grad, jgx, 'grad x')
    # the flax gradients in the port's layout (kernels transposed, the LSTM
    # cell's Denses stacked), checked parameter by parameter
    jgrads = flax_to_state_dict(jgp) if jgp else {}
    named = dict(tm.named_parameters())
    assert set(named) == set(jgrads) == set(sd)
    floor = 1e-6 * float(np.abs(np.asarray(jgx)).max())
    for k, p in named.items():
        _grad_close(p.grad, jgrads[k].numpy(), k, floor)
    return out


BASIC = {
    'sum': (jaggr.SumAggregation, aggr.SumAggregation, {}),
    'mean': (jaggr.MeanAggregation, aggr.MeanAggregation, {}),
    'max': (jaggr.MaxAggregation, aggr.MaxAggregation, {}),
    'min': (jaggr.MinAggregation, aggr.MinAggregation, {}),
    'mul': (jaggr.MulAggregation, aggr.MulAggregation, {}),
    'var': (jaggr.VarAggregation, aggr.VarAggregation, {}),
    'std': (jaggr.StdAggregation, aggr.StdAggregation, {}),
    'softmax': (jaggr.SoftmaxAggregation, aggr.SoftmaxAggregation,
                {'t': 0.7}),
    'softmax-learn': (jaggr.SoftmaxAggregation, aggr.SoftmaxAggregation,
                      {'t': 1.3, 'learn': True}),
    'softmax-learn-channels': (jaggr.SoftmaxAggregation,
                               aggr.SoftmaxAggregation,
                               {'t': 0.9, 'learn': True, 'channels': F}),
    'powermean': (jaggr.PowerMeanAggregation, aggr.PowerMeanAggregation,
                  {'p': 2.5}),
    'powermean-learn': (jaggr.PowerMeanAggregation,
                        aggr.PowerMeanAggregation,
                        {'p': 1.5, 'learn': True}),
    'variance_preserving': (jaggr.VariancePreservingAggregation,
                            aggr.VariancePreservingAggregation, {}),
}


@pytest.mark.parametrize('use_mask', [False, True], ids=['nomask', 'mask'])
@pytest.mark.parametrize('name', sorted(BASIC))
def test_basic_aggregation_matches_jax(name, use_mask):
    jcls, tcls, kw = BASIC[name]
    x, index, mask = _inputs(len(name))
    if name == 'mul':
        x = (1 + 0.3 * x).astype(np.float32)   # products of order 1
    tkw = dict(kw)
    if kw.get('learn'):
        tkw['device'] = 'cpu'
    # the JAX package's segment product has no gradient (scatter_mul
    # needs unique indices): the port's is held to prod / x_i in float64
    out = _run(jcls(**kw), tcls(**tkw), x, index, mask, use_mask,
               jax_grads=name != 'mul')
    if name == 'mul':
        x64 = torch.from_numpy(x).double().requires_grad_()
        tcls()(x64, torch.from_numpy(index), SEGMENTS,
               torch.from_numpy(mask) if use_mask else None).sum().backward()
        keep = (index < SEGMENTS) & (mask if use_mask else True)
        prod = np.ones((SEGMENTS + 1, F))
        np.multiply.at(prod, np.where(keep, index, SEGMENTS),
                       x.astype(np.float64))
        want = np.where(keep[:, None], prod[index.clip(max=SEGMENTS)]
                        / x.astype(np.float64), 0.0)
        np.testing.assert_allclose(x64.grad.numpy(), want, rtol=1e-9,
                                   atol=1e-12)
    # empty segments (4, 7): 0 for every reduction but mul, 1 there
    empty = out.detach()[[4, 7]]
    want = 1.0 if name == 'mul' else 0.0
    if name.startswith('powermean'):
        want = float(torch.tensor(1e-12) ** (1 / kw['p']))
    np.testing.assert_allclose(empty.numpy(), want, rtol=1e-6)


def test_std_zeroes_undefined_outputs():
    """A segment of one row has variance 0: the clamp at 1e-5 gives
    sqrt(1e-5), which counts as undefined and comes out as 0."""
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    index = np.array([0, 1, 1, 2], np.int32)
    got = aggr.StdAggregation()(torch.from_numpy(x),
                                torch.from_numpy(index), 3)
    ref = jaggr.StdAggregation().apply({}, jnp.asarray(x),
                                       jnp.asarray(index), 3)
    _close(got, ref)
    assert (got[[0, 2]] == 0).all() and (got[1] > 0).all()


@pytest.mark.parametrize('mode', ['cat', 'sum', 'mean', 'max', 'min',
                                  'proj'])
def test_multi_aggregation_matches_jax(mode):
    x, index, mask = _inputs(11)
    aggrs = ('mean', 'max', 'std')
    jm = jaggr.MultiAggregation(aggrs=aggrs, mode=mode,
                                out_channels=4 if mode == 'proj' else None)
    kw = dict(in_channels=3 * F, out_channels=4) if mode == 'proj' else {}
    tm = aggr.MultiAggregation(aggrs=aggrs, mode=mode, device='cpu', **kw)
    _run(jm, tm, x, index, mask, True, seed=3)


def test_multi_aggregation_proj_default_width():
    """Without ``out_channels``, 'proj' maps to one aggregation's width, as
    the JAX package's ``Dense(x.shape[-1])`` does."""
    tm = aggr.MultiAggregation(aggrs=('sum', 'max'), mode='proj',
                               in_channels=2 * F, device='cpu')
    assert tm.proj.out_features == F


@pytest.mark.parametrize('scalers', [
    ('identity', 'amplification', 'attenuation'),
    ('linear', 'inverse_linear', 'identity')])
@pytest.mark.parametrize('use_mask', [False, True], ids=['nomask', 'mask'])
def test_degree_scaler_aggregation_matches_jax(scalers, use_mask):
    x, index, mask = _inputs(12)
    kw = dict(aggr=('mean', 'min', 'max', 'std'), scaler=scalers,
              avg_deg_log=1.7, avg_deg_lin=3.2)
    out = _run(jaggr.DegreeScalerAggregation(**kw),
               aggr.DegreeScalerAggregation(**kw), x, index, mask, use_mask)
    assert out.shape == (SEGMENTS, 4 * F * 3)


def test_degree_scaler_refuses_unknown_scaler():
    with pytest.raises(ValueError, match='scaler'):
        aggr.DegreeScalerAggregation(scaler=('identity', 'cubic'))


def test_degree_scaler_refuses_train_norm():
    """Trained degree statistics are not supported: asking for them
    raises rather than training nothing."""
    with pytest.raises(NotImplementedError, match='train_norm'):
        aggr.DegreeScalerAggregation(train_norm=True)


@pytest.mark.parametrize('with_nn', [False, True])
def test_attentional_aggregation_matches_jax(with_nn):
    x, index, mask = _inputs(13)
    jm = jaggr.AttentionalAggregation(gate_nn=fnn.Dense(1),
                                      nn=fnn.Dense(5) if with_nn else None)
    tm = aggr.AttentionalAggregation(
        gate_nn=linear(F, 1, device='cpu'),
        nn=linear(F, 5, device='cpu') if with_nn else None)
    _run(jm, tm, x, index, mask, True, seed=4)


def test_set2set_matches_jax():
    """Set2Set's flax ``LSTMCell`` (eight Denses) carried across as the
    port's stacked cell, gates in the order i, f, g, o."""
    x, index, mask = _inputs(14)
    jm = jaggr.Set2Set(in_channels=F, processing_steps=3)
    tm = aggr.Set2Set(F, processing_steps=3, device='cpu')
    out = _run(jm, tm, x, index, mask, True, seed=5)
    assert out.shape == (SEGMENTS, 2 * F)
    assert set(dict(tm.named_parameters())) == {
        'lstm.weight_ih', 'lstm.weight_hh', 'lstm.bias_hh'}


def test_deep_sets_aggregation_matches_jax():
    x, index, mask = _inputs(15)
    jm = jaggr.DeepSetsAggregation(local_nn=fnn.Dense(7),
                                   global_nn=fnn.Dense(3))
    tm = aggr.DeepSetsAggregation(local_nn=linear(F, 7, device='cpu'),
                                  global_nn=linear(7, 3, device='cpu'))
    _run(jm, tm, x, index, mask, True, seed=6)


@pytest.mark.parametrize('name', ['sum', 'mean', 'max', 'std', 'softmax',
                                  'powermean', 'variance_preserving'])
def test_aggregation_resolver_matches_jax(name):
    jm, tm = jaggr.aggregation_resolver(name), aggr.aggregation_resolver(
        name)
    assert type(tm).__name__ == type(jm).__name__
    x, index, mask = _inputs(16)
    _run(jm, tm, x, index, mask, True)
    multi = aggr.aggregation_resolver(['sum', 'max'])
    assert isinstance(multi, aggr.MultiAggregation)
    with pytest.raises(ValueError, match='Unknown aggregation'):
        aggr.aggregation_resolver('median3')


def test_aggregation_without_index_is_one_segment():
    x, _, _ = _inputs(17)
    got = aggr.MeanAggregation()(torch.from_numpy(x))
    ref = jaggr.MeanAggregation().apply({}, jnp.asarray(x))
    _close(got, ref)


@pytest.mark.parametrize('use_mask', [False, True], ids=['nomask', 'mask'])
def test_to_dense_matches_jax(use_mask):
    x, index, mask = _inputs(18)
    jmask = jnp.asarray(mask) if use_mask else None
    tmask = torch.from_numpy(mask) if use_mask else None
    for cap in (3, N):
        ref_d, ref_m = jaggr.SumAggregation().to_dense(
            jnp.asarray(x), jnp.asarray(index), SEGMENTS, jmask, cap)
        got_d, got_m = aggr.SumAggregation().to_dense(
            torch.from_numpy(x), torch.from_numpy(index), SEGMENTS, tmask,
            cap)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))


# -- utils/core.py and utils/dense.py ----------------------------------------
def test_core_utils_match_jax():
    rng = np.random.default_rng(20)
    index = rng.integers(0, 7, 30).astype(np.int32)
    index[:3] = 7                                  # padded: dropped
    mask = rng.random(30) < 0.7
    for m in (None, mask):
        got = core.degree(torch.from_numpy(index), 7,
                          mask=None if m is None else torch.from_numpy(m))
        ref = jcore.degree(jnp.asarray(index), 7,
                           mask=None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    x = rng.standard_normal((5, 4)).astype(np.float32)
    for axis in (0, 1):
        _close(core.cumsum(torch.from_numpy(x), axis),
               jcore.cumsum(jnp.asarray(x), axis))
    cls = np.array([0, 3, 5, -1, 2], np.int32)
    np.testing.assert_array_equal(
        core.one_hot(torch.from_numpy(cls), 5).numpy(),
        np.asarray(jcore.one_hot(jnp.asarray(cls), 5)))
    keys = rng.integers(0, 4, 25).astype(np.int32)
    s, perm = core.index_sort(torch.from_numpy(keys))
    js, jperm = jcore.index_sort(jnp.asarray(keys))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    k2 = rng.integers(0, 3, 25).astype(np.int32)
    for desc in (False, True):
        got = core.lexsort([torch.from_numpy(keys), torch.from_numpy(k2)],
                           descending=desc)
        ref = jcore.lexsort([jnp.asarray(keys), jnp.asarray(k2)],
                            descending=desc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    w = rng.random(30).astype(np.float32)
    seg = rng.integers(0, 7, 30).astype(np.int32)
    _close(core.scatter_normalize(torch.from_numpy(w), torch.from_numpy(seg),
                                  7),
           jcore.scatter_normalize(jnp.asarray(w), jnp.asarray(seg), 7))
    coo = np.array([[0, 4, 2], [1, 1, 3]], np.int32)
    assert core.maybe_num_nodes(torch.from_numpy(coo)) == \
        jcore.maybe_num_nodes(jnp.asarray(coo)) == 5


@pytest.mark.parametrize('cap', [3, 6])
def test_dense_utils_match_jax(cap):
    rng = np.random.default_rng(21)
    sizes = [4, 6, 2, 5]
    batch = np.repeat(np.arange(4), sizes).astype(np.int32)
    x = rng.standard_normal((len(batch), 3)).astype(np.float32)
    got_x, got_m = dense.to_dense_batch(torch.from_numpy(x),
                                        torch.from_numpy(batch), 4, cap)
    ref_x, ref_m = jdense.to_dense_batch(jnp.asarray(x), jnp.asarray(batch),
                                         4, cap)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(ref_x))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    src, dst = [], []
    for g, n in enumerate(sizes):
        s = rng.integers(0, n, 6) + ptr[g]
        d = rng.integers(0, n, 6) + ptr[g]
        src.append(s)
        dst.append(d)
    coo = np.stack([np.concatenate(src), np.concatenate(dst)]).astype(
        np.int32)
    ea = rng.standard_normal((coo.shape[1], 2)).astype(np.float32)
    for attr in (None, ea):
        got = dense.to_dense_adj(
            torch.from_numpy(coo), torch.from_numpy(batch), 4, cap,
            None if attr is None else torch.from_numpy(attr))
        ref = jdense.to_dense_adj(jnp.asarray(coo), jnp.asarray(batch), 4,
                                  cap,
                                  None if attr is None else jnp.asarray(attr))
        _close(got, ref)
    got = dense.to_dense_adj(torch.from_numpy(coo[:, :6]), None, 1, 4)
    ref = jdense.to_dense_adj(jnp.asarray(coo[:, :6]), None, 1, 4)
    _close(got, ref)
    adj = np.asarray(ref)
    for a in (adj[0], adj):
        gc, gv = dense.dense_to_sparse(torch.from_numpy(np.array(a)))
        rc, rv = jdense.dense_to_sparse(jnp.asarray(a))
        assert gc.dtype == torch.int64
        np.testing.assert_array_equal(gc.numpy(), rc)
        np.testing.assert_array_equal(gv.numpy(), rv)


def test_dense_to_sparse_mask_and_gradient():
    """``dense_to_sparse`` with ``to_dense_batch``'s mask inverts
    ``to_dense_adj`` (real nodes numbered by their rank, the edges in
    row-major order, their weights summed where an edge repeats), stays
    on the input's device and passes the gradient to the adjacency; a
    mask with an unbatched adjacency, or of the wrong shape, is refused."""
    rng = np.random.default_rng(22)
    sizes, cap = [4, 6, 2, 5], 6
    batch = torch.from_numpy(np.repeat(np.arange(4), sizes))
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    pairs = {}
    for g, n in enumerate(sizes):
        for s, d in rng.integers(0, n, (7, 2)) + ptr[g]:
            pairs[(s, d)] = pairs.get((s, d), 0.0) + 1.0
    coo = torch.tensor(sorted(pairs)).t()
    w = torch.from_numpy(rng.standard_normal(coo.shape[1])
                         ).float().requires_grad_()
    _, mask = dense.to_dense_batch(torch.zeros(len(batch), 1), batch, 4, cap)
    adj = dense.to_dense_adj(coo, batch, 4, cap, w)
    got, vals = dense.dense_to_sparse(adj, mask)
    assert got.device == adj.device and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), coo.numpy())
    np.testing.assert_array_equal(vals.detach().numpy(), w.detach().numpy())
    cot = torch.from_numpy(rng.standard_normal(len(vals))).float()
    (vals * cot).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), cot.numpy())
    # without the mask, graph b's node i is b * cap + i
    got, _ = dense.dense_to_sparse(adj.detach())
    local = coo - torch.from_numpy(ptr[batch[coo[0]].numpy()])
    np.testing.assert_array_equal(
        got.numpy(), (local + batch[coo[0]] * cap).numpy())
    with pytest.raises(ValueError, match='batched'):
        dense.dense_to_sparse(adj[0], mask[0])
    with pytest.raises(ValueError, match='mask of shape'):
        dense.dense_to_sparse(adj, mask[:, :3])
