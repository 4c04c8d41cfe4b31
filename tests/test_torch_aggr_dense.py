"""The port's ``nn/aggr/dense.py`` and ``nn/aggr/advanced.py`` against the
JAX package's, on the CPU, over a batch of segments with a masked row, an
empty segment and a padded row at the sentinel: ``SortAggregation``
(``k`` below and above the longest segment; equal keys, which the stable
sort keeps in row order on both), ``QuantileAggregation`` in every
interpolation and at several ``q``, ``MedianAggregation``, the GRU, LSTM
and MLP aggregations, ``SetTransformerAggregation``,
``GraphMultisetTransformer``, ``LCMAggregation``,
``PatchTransformerAggregation`` and ``EquilibriumAggregation``; and what
``EquilibriumAggregation`` does under ``torch.no_grad`` (the same value)
and under ``torch.inference_mode`` (it raises), and with an unmasked row
at the sentinel (no gradient in the port, one in the JAX package).

Tolerances: outputs within 1e-5 * max(1, max|ref|) and gradients within
1e-4 of each gradient's largest entry (``_torch_parity``); the attention
aggregations and ``EquilibriumAggregation`` outputs within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, compare, grad_close, init_variables, t
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu.nn.aggr import advanced as jadv
from pytorch_geometric_tpu.nn.aggr import dense as jdense
from pytorch_geometric_tpu_torch.nn.aggr import advanced as tadv
from pytorch_geometric_tpu_torch.nn.aggr import dense as tdense

CPU = dict(device='cpu')
N, F, S, L = 30, 5, 5, 9
_rng = np.random.default_rng(51)
X = _rng.standard_normal((N, F)).astype(np.float32)
# segments 0-4 of sizes 9, 8, 6, 6, 0; the last row padded at the sentinel
INDEX = np.repeat(np.arange(S), [9, 8, 6, 6, 0]).astype(np.int32)
INDEX = np.concatenate([INDEX, [S]]).astype(np.int32)
MASK = np.ones(N, bool)
MASK[[3, 12]] = False


# the sentinel row masked too: EquilibriumAggregation reads ``y[index]``
# directly, and there the packages part on an unmasked out-of-range row
# (test_equilibrium_sentinel_row)
MASK_SENTINEL = MASK.copy()
MASK_SENTINEL[-1] = False


def _run(jm, tm, x=X, index=INDEX, tol=1e-5, partial=None, mask=MASK):
    compare(jm, tm, x, (jnp.asarray(index), S, jnp.asarray(mask), L),
            (t(index), S, t(mask), L), out_tol=tol, partial=partial)


# torch's GRU cell has hidden biases for the reset and update gates, which
# flax's lacks: their gradients have no counterpart, only b_hn's is held
GRU_PARTIAL = {'gru.bias_hh': slice(14, None),
               'combine.bias_hh': slice(12, None)}


@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('k', [4, 12])
def test_sort_aggregation_matches_jax(k, ties):
    x = X.copy()
    if ties:
        x[::2, -1] = 0.25          # equal keys within every segment
    _run(jdense.SortAggregation(k=k), tdense.SortAggregation(k), x)


@pytest.mark.parametrize('q', [0.0, 0.3, 0.5, 1.0])
@pytest.mark.parametrize('interpolation', ['linear', 'lower', 'higher',
                                           'nearest', 'midpoint'])
def test_quantile_aggregation_matches_jax(interpolation, q):
    _run(jdense.QuantileAggregation(q=q, interpolation=interpolation),
         tdense.QuantileAggregation(q, interpolation))


def test_median_aggregation_matches_jax():
    """The median of a 1-D input too (the squeezed branch)."""
    _run(jdense.MedianAggregation(), tdense.MedianAggregation())
    _run(jdense.MedianAggregation(), tdense.MedianAggregation(), X[:, 0])


RECURRENT = {
    'GRU': (lambda: jdense.GRUAggregation(in_channels=F, out_channels=7),
            lambda: tdense.GRUAggregation(F, 7, **CPU)),
    'LSTM': (lambda: jdense.LSTMAggregation(in_channels=F, out_channels=7),
             lambda: tdense.LSTMAggregation(F, 7, **CPU)),
    'MLP': (lambda: jdense.MLPAggregation(out_channels=7,
                                          max_num_elements_static=L),
            lambda: tdense.MLPAggregation(F, 7, L, **CPU)),
}


@pytest.mark.parametrize('name', sorted(RECURRENT))
def test_learned_dense_aggregations_match_jax(name):
    jbuild, tbuild = RECURRENT[name]
    _run(jbuild(), tbuild(), partial=GRU_PARTIAL)


ADVANCED = {
    'SetTransformer': (
        lambda: jadv.SetTransformerAggregation(channels=8, num_seed_points=2,
                                               heads=2,
                                               num_encoder_blocks=2),
        lambda: tadv.SetTransformerAggregation(F, 8, 2, 2, 2, **CPU)),
    'GraphMultisetTransformer': (
        lambda: jadv.GraphMultisetTransformer(channels=8, heads=2),
        lambda: tadv.GraphMultisetTransformer(F, 8, heads=2, **CPU)),
    'LCM': (lambda: jadv.LCMAggregation(in_channels=F, out_channels=6),
            lambda: tadv.LCMAggregation(F, 6, **CPU)),
    'PatchTransformer': (
        lambda: jadv.PatchTransformerAggregation(channels=8, patch_size=4,
                                                 heads=2),
        lambda: tadv.PatchTransformerAggregation(F, 8, 4, 2, **CPU)),
    'Equilibrium': (
        lambda: jadv.EquilibriumAggregation(in_channels=F, out_channels=3,
                                            num_steps=6),
        lambda: tadv.EquilibriumAggregation(F, 3, num_steps=6, **CPU)),
}


@pytest.mark.parametrize('name', sorted(ADVANCED))
def test_advanced_aggregations_match_jax(name):
    """Outputs within 1e-4 (attention and the unrolled descent), gradients
    through every step within 1e-4 of their largest."""
    jbuild, tbuild = ADVANCED[name]
    _run(jbuild(), tbuild(), tol=1e-4, partial=GRU_PARTIAL,
         mask=MASK_SENTINEL if name == 'Equilibrium' else MASK)


def test_equilibrium_sentinel_row():
    """An unmasked row at the sentinel index: the same output on both
    (it adds nothing to the energy's gradient), and no gradient for its x
    in the port, where the JAX package's unrolled ``jax.grad`` gives it
    one: its out-of-range gather clamps to the last segment, the gradient's
    scatter drops it, and the transpose of that scatter, in the second
    derivative, gathers the last segment's cotangent back. The JAX
    package's output does not move with that row's x, so the port's zero
    is the true derivative (a deliberate divergence, ROADMAP)."""
    jbuild, tbuild = ADVANCED['Equilibrium']
    jm, tm = jbuild(), tbuild()
    args = (jnp.asarray(INDEX), S, jnp.asarray(MASK), L)
    variables = init_variables(jm, 0, jnp.asarray(X), *args)
    want, vjp = jax.vjp(lambda x: jm.apply(variables, x, *args),
                        jnp.asarray(X))
    tm.load_state_dict(flax_to_state_dict(variables))
    tx = t(X).requires_grad_()
    got = tm(tx, t(INDEX), S, t(MASK), L)
    close(got, want, tol=1e-4)
    got.sum().backward()
    gx = np.asarray(vjp(jnp.ones_like(want))[0])
    assert np.abs(gx[-1]).max() > 1e-3
    moved = jnp.asarray(X).at[-1].add(1.0)
    np.testing.assert_array_equal(np.asarray(jm.apply(variables, moved,
                                                      *args)),
                                  np.asarray(want))
    assert float(tx.grad[-1].abs().max()) == 0.0
    grad_close(tx.grad[:-1], gx[:-1], 'grad x')


def test_equilibrium_under_no_grad_and_inference_mode():
    """Under ``no_grad`` the steps run all the same (a detached result of
    the same value); under ``inference_mode`` the call raises."""
    gen = torch.Generator().manual_seed(0)
    m = tadv.EquilibriumAggregation(F, 3, generator=gen, **CPU)
    args = (t(X), t(INDEX), S, t(MASK), L)
    want = m(*args)
    assert want.requires_grad and want.abs().max() > 0
    with torch.no_grad():
        got = m(*args)
    assert not got.requires_grad
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match='inference_mode'):
            m(*args)
        x_inf = t(X)
    with torch.no_grad():
        torch.testing.assert_close(m(x_inf, *args[1:]), want.detach(),
                                   rtol=0, atol=0)
