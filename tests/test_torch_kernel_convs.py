"""The port's ``nn/conv/kernel_conv.py`` against the JAX package's, on the
CPU: GMMConv, SplineConv, NNConv, CGConv and FeaStConv on a raw COO, a
padded COO with an edge mask and an ``EdgeIndex``; ``_bspline_basis`` at
degrees 1-3; SplineConv's design (``x @ weight`` for every kernel, then one
gather of every corner's rows) against the JAX package's gather formula
(``weight[idx]`` an ``[E, F_in, F_out]`` tensor a corner) at degrees 1-3 in
1-3 dimensions; and ``chip_smoke.py``'s SplineCNN (path AB) on a small UV
sphere over three Adam steps against flax and optax.

Tolerances: outputs within 1e-5 * max(1, max|ref|), gradients within 1e-4
of each gradient's largest entry (``_torch_parity``); the basis within
1e-6; the SplineCNN losses within 1e-4 relative each step and its
parameters after the steps within 1e-5 * max(1, max|p|) of optax's."""

import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (close, compare, edge_variant, grad_close, graph,
                           init_variables, t)
from pytorch_geometric_tpu.nn import conv as jconv
from pytorch_geometric_tpu.nn import models as jmodels
from pytorch_geometric_tpu.nn.conv.kernel_conv import \
    _bspline_basis as jbasis
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import conv
from pytorch_geometric_tpu_torch.nn.conv.kernel_conv import \
    _bspline_basis as tbasis
from pytorch_geometric_tpu_torch.nn.models import MLP

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device='cpu')
N, E, F, PAD, C = 30, 110, 6, 5, 7
X, COO, MASK, W = graph(21, N, E, F, PAD)
# pseudo-coordinates in [0, 1], the last edges on the knots' ends
PSEUDO = np.random.default_rng(22).random((E + PAD, 3)).astype(np.float32)
PSEUDO[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 0.75], [1, 0, 0.5]]
VARIANTS = ['coo', 'coo mask', 'EdgeIndex']


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _run(jm, tm, variant, attr=True, dim=3):
    je, te, kw = edge_variant(variant, COO, MASK, W, N, E)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: t(v) for k, v in kw.items()}
    ea = PSEUDO[:, :dim] if variant == 'coo mask' else PSEUDO[:E, :dim]
    jargs, targs = (je,), (te,)
    if attr:
        jargs, targs = (je, jnp.asarray(ea)), (te, t(ea))
    return compare(jm, tm, X, jargs, targs, jkw=jkw, tkw=tkw)


@pytest.mark.parametrize('degree', [1, 2, 3])
def test_bspline_basis_matches_jax(degree):
    for k in (degree + 1, 5):
        wj, ij = jbasis(jnp.asarray(PSEUDO), k, degree)
        wt, it = tbasis(t(PSEUDO), k, degree)
        close(wt, wj, f'weights k {k}', 1e-6)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        # the taps of each dimension sum to 1
        np.testing.assert_allclose(wt.sum(-1).numpy(), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match='degree'):
        tbasis(t(PSEUDO), 3, 0)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('case', ['mean', 'add plain'])
def test_gmm_conv_matches_jax(case, variant):
    kw = {} if case == 'mean' else dict(aggr='add', root_weight=False,
                                        use_bias=False)
    _run(jconv.GMMConv(out_channels=C, dim=3, kernel_size=4, **kw),
         conv.GMMConv(F, C, dim=3, kernel_size=4, **kw, **CPU), variant)


@pytest.mark.parametrize('variant', VARIANTS)
def test_spline_conv_matches_jax(variant):
    """Degree 1 in 3 dimensions on each edge form."""
    _run(jconv.SplineConv(out_channels=C, dim=3, kernel_size=4),
         conv.SplineConv(F, C, dim=3, kernel_size=4, **CPU), variant)


@pytest.mark.parametrize('dim', [1, 2, 3])
@pytest.mark.parametrize('degree', [1, 2, 3])
def test_spline_conv_design_matches_the_gather_formula(degree, dim):
    """The port's ``x @ weight`` then one gather of the corners against
    the JAX package's gather formula (its ``[E, F_in, F_out]`` tensor a
    corner),
    at each degree in 1-3 dimensions, on the padded COO with its mask;
    sum aggregation without root where ``dim`` is 2."""
    kw = dict(aggr='add', root_weight=False) if dim == 2 else {}
    _run(jconv.SplineConv(out_channels=C, dim=dim, kernel_size=degree + 2,
                          degree=degree, **kw),
         conv.SplineConv(F, C, dim=dim, kernel_size=degree + 2,
                         degree=degree, **kw, **CPU), 'coo mask', dim=dim)


@pytest.mark.parametrize('variant', VARIANTS)
def test_nn_conv_matches_jax(variant):
    _run(jconv.NNConv(out_channels=C,
                      nn=jmodels.MLP(channel_list=[12, F * C])),
         conv.NNConv(F, C, MLP(3, [12, F * C], **CPU), **CPU), variant)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('dim', [0, 3])
def test_cg_conv_matches_jax(dim, variant):
    if dim:
        _run(jconv.CGConv(channels=F, dim=3, aggr='mean'),
             conv.CGConv(F, dim=3, aggr='mean', **CPU), variant)
    else:
        _run(jconv.CGConv(channels=F), conv.CGConv(F, **CPU), variant,
             attr=False)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('heads', [1, 3])
def test_feast_conv_matches_jax(heads, variant):
    _run(jconv.FeaStConv(out_channels=C, heads=heads),
         conv.FeaStConv(F, C, heads=heads, **CPU), variant, attr=False)


# -- path AB's model: three Adam steps on a small sphere ----------------------
class _JSplineNet(fnn.Module):
    """``chip_smoke.py::spline_faust_net`` in flax, dropout off."""
    channels: tuple
    hidden: int
    classes: int
    kernel_size: int

    @fnn.compact
    def __call__(self, x, coo, pseudo):
        for i, ch in enumerate(self.channels):
            x = jax.nn.elu(jconv.SplineConv(
                out_channels=ch, dim=3, kernel_size=self.kernel_size,
                aggr='add', name=f'convs_{i}')(x, coo, pseudo))
        x = jax.nn.elu(fnn.Dense(self.hidden, name='lin1')(x))
        return jax.nn.log_softmax(fnn.Dense(self.classes, name='lin2')(x),
                                  -1)


def test_path_ab_steps_match_jax():
    """Path AB's model cut to 2 convs (channels 8 -> 8, kernel 5, hidden
    16) on ``chip_smoke.py::faust_like``'s sphere at 8 rings x 7 vertices
    (58 vertices, 112 triangles): its edge count by Euler's formula, its
    pseudo-coordinates in [0, 1]; three Adam steps (1e-3) of the NLL over
    the vertex ids, each step's loss and gradients against flax's with the
    port trained on its own by ``torch.optim.Adam`` (in eval mode: no
    dropout; the model has no batch norm), its parameters after the steps
    against optax's."""
    cs = _chip_smoke()
    pos, face, coo, pseudo = cs.faust_like(0, rings=8, segs=7)
    n = len(pos)
    assert n == 58 and face.shape[1] == 112
    assert coo.shape[1] == 2 * (n + face.shape[1] - 2)
    assert 0 <= float(pseudo.min()) and float(pseudo.max()) <= 1
    dims = dict(channels=(8, 8), hidden=16, classes=n, kernel_size=5)
    x = np.ones((n, 1), np.float32)
    jargs = (jnp.asarray(x), jnp.asarray(coo), jnp.asarray(pseudo.numpy()))
    jm = _JSplineNet(**dims)
    params = init_variables(jm, 0, *jargs)['params']
    y = np.arange(n)

    def jloss(p):
        return -jm.apply({'params': p}, *jargs)[jnp.arange(n), y].mean()

    tm = cs.spline_faust_net(torch, 'cpu', 0, channels=dims['channels'],
                             hidden=16, classes=n, kernel_size=5)
    tm.load_state_dict(flax_to_state_dict({'params': params}))
    tm.eval()
    topt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    tx = optax.adam(1e-3)
    opt = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(jloss))
    for step in range(3):
        loss, g = grad_fn(params)
        topt.zero_grad(set_to_none=True)
        tl = torch.nn.functional.nll_loss(
            tm(t(x), t(coo), pseudo), t(y))
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-4,
                                   err_msg=f'loss, step {step}')
        jgrads = flax_to_state_dict({'params': g})
        for k, p in tm.named_parameters():
            grad_close(p.grad, jgrads[k].numpy(), f'{k}, step {step}')
        topt.step()
        upd, opt = tx.update(g, opt)
        params = optax.apply_updates(params, upd)
    want = flax_to_state_dict({'params': params})
    for k, p in tm.named_parameters():
        close(p, want[k].numpy(), k)
