"""The port's propagation convs against the JAX package's, on the CPU, at
small widths: every class of ``nn/conv/spectral_conv.py`` (ChebConv both
normalisations, ARMAConv with and without shared weights, SGConv, SSGConv,
TAGConv, APPNP, MixHopConv), the rest of ``nn/conv/graph_conv.py``
(ResGatedGraphConv, GatedGraphConv, LEConv, MFConv, FAConv, AGNNConv,
WLConvContinuous, LGConv) and ``nn/conv/dna_conv.py`` (DNAConv, PANConv,
``restricted_softmax``), each on a raw COO, on a raw COO with padded edges
at the sentinel and an edge mask, and on an ``EdgeIndex``, with edge
weights where the conv takes them; and ``convert.py``'s rules for them
(ARMAConv's shared names, MFConv's banks, the GRU cell).

The same numpy inputs go to both packages; the flax parameters reach the
port's modules through ``convert.flax_to_state_dict``. Tolerances: outputs
within 1e-5 * max(1, max|ref|), gradients (input and every parameter, of
``sum(out * cot)``) within 1e-4 of each gradient's largest entry
(``_torch_parity``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import compare, edge_variant, graph, init_variables, t
from pytorch_geometric_tpu.nn import conv as jconv
from pytorch_geometric_tpu.nn.conv import dna_conv as jdna
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import conv
from pytorch_geometric_tpu_torch.nn.conv import dna_conv

N, E, F, PAD, C = 26, 90, 12, 4, 8
X, COO, MASK, W = graph(0, N, E, F, PAD)


def _edges(variant, weighted):
    return edge_variant(variant, COO, MASK, W, N, E, weighted)


def _run(jm, tm, variant, weighted, x=X, partial=None):
    je, te, kw = _edges(variant, weighted)
    compare(jm, tm, x, (je,), (te,),
            jkw={k: jnp.asarray(v) for k, v in kw.items()},
            tkw={k: t(v) for k, v in kw.items()}, partial=partial)


CPU = dict(device='cpu')
# (name, flax module, port module, takes edge weights)
CONVS = [
    ('ChebConv sym K=3', lambda: jconv.ChebConv(out_channels=C, K=3),
     lambda: conv.ChebConv(F, C, K=3, **CPU), True),
    ('ChebConv rw K=2', lambda: jconv.ChebConv(out_channels=C, K=2,
                                               normalization='rw'),
     lambda: conv.ChebConv(F, C, K=2, normalization='rw', **CPU), True),
    ('ARMAConv', lambda: jconv.ARMAConv(out_channels=C, num_stacks=2,
                                        num_layers=2),
     lambda: conv.ARMAConv(F, C, num_stacks=2, num_layers=2, **CPU), True),
    ('ARMAConv shared', lambda: jconv.ARMAConv(
        out_channels=C, num_stacks=2, num_layers=2, shared_weights=True,
        act='tanh'),
     lambda: conv.ARMAConv(F, C, num_stacks=2, num_layers=2,
                           shared_weights=True, act='tanh', **CPU), True),
    ('SGConv', lambda: jconv.SGConv(out_channels=C, K=2),
     lambda: conv.SGConv(F, C, K=2, **CPU), True),
    ('SSGConv', lambda: jconv.SSGConv(out_channels=C, alpha=0.2, K=3),
     lambda: conv.SSGConv(F, C, alpha=0.2, K=3, **CPU), True),
    ('TAGConv', lambda: jconv.TAGConv(out_channels=C, K=2),
     lambda: conv.TAGConv(F, C, K=2, **CPU), True),
    ('TAGConv raw', lambda: jconv.TAGConv(out_channels=C, K=2,
                                          normalize=False, use_bias=False),
     lambda: conv.TAGConv(F, C, K=2, normalize=False, use_bias=False,
                          **CPU), True),
    ('APPNP', lambda: jconv.APPNP(K=5, alpha=0.2),
     lambda: conv.APPNP(K=5, alpha=0.2), True),
    ('MixHopConv', lambda: jconv.MixHopConv(out_channels=C,
                                            powers=(0, 1, 3)),
     lambda: conv.MixHopConv(F, C, powers=(0, 1, 3), **CPU), True),
    ('ResGatedGraphConv', lambda: jconv.ResGatedGraphConv(out_channels=C),
     lambda: conv.ResGatedGraphConv(F, C, **CPU), False),
    ('ResGatedGraphConv no root', lambda: jconv.ResGatedGraphConv(
        out_channels=C, root_weight=False, use_bias=False),
     lambda: conv.ResGatedGraphConv(F, C, root_weight=False, use_bias=False,
                                    **CPU), False),
    ('LEConv', lambda: jconv.LEConv(out_channels=C),
     lambda: conv.LEConv(F, C, **CPU), True),
    ('MFConv', lambda: jconv.MFConv(out_channels=C, max_degree=3),
     lambda: conv.MFConv(F, C, max_degree=3, **CPU), False),
    ('FAConv', lambda: jconv.FAConv(eps=0.2),
     lambda: conv.FAConv(F, eps=0.2, **CPU), True),
    ('FAConv raw', lambda: jconv.FAConv(normalize=False),
     lambda: conv.FAConv(F, normalize=False, **CPU), True),
    ('AGNNConv', lambda: jconv.AGNNConv(),
     lambda: conv.AGNNConv(**CPU), False),
    ('AGNNConv fixed beta, no loops', lambda: jconv.AGNNConv(
        requires_grad_beta=False, add_self_loops=False),
     lambda: conv.AGNNConv(requires_grad_beta=False, add_self_loops=False,
                           **CPU), False),
    ('WLConvContinuous', lambda: jconv.WLConvContinuous(),
     lambda: conv.WLConvContinuous(), True),
    ('LGConv', lambda: jconv.LGConv(), lambda: conv.LGConv(), True),
    ('LGConv raw', lambda: jconv.LGConv(normalize=False),
     lambda: conv.LGConv(normalize=False), True),
]


@pytest.mark.parametrize('variant', ['coo', 'coo mask', 'EdgeIndex'])
@pytest.mark.parametrize('name,jbuild,tbuild,weighted', CONVS,
                         ids=[c[0] for c in CONVS])
def test_conv_matches_jax(name, jbuild, tbuild, weighted, variant):
    _run(jbuild(), tbuild(), variant, weighted)


@pytest.mark.parametrize('variant', ['coo', 'coo mask', 'EdgeIndex'])
def test_gated_graph_conv_matches_jax(variant):
    """Input padded from 12 to 16 columns, two GRU rounds; the EdgeIndex
    goes to ``propagate`` as given. torch's cell carries hidden biases of
    the reset and update gates that flax's lacks: they load as 0 and only
    the new-gate part of ``bias_hh`` has a flax gradient."""
    _run(jconv.GatedGraphConv(out_channels=16, num_layers=2),
         conv.GatedGraphConv(16, num_layers=2, **CPU), variant, True,
         partial={'rnn.bias_hh': slice(32, None)})


@pytest.mark.parametrize('variant', ['coo', 'coo mask', 'EdgeIndex'])
@pytest.mark.parametrize('heads,groups', [(1, 1), (2, 2)])
def test_dna_conv_matches_jax(heads, groups, variant):
    x = np.random.default_rng(3).standard_normal((N, 3, F)).astype(
        np.float32)
    _run(jconv.DNAConv(channels=F, heads=heads, groups=groups),
         conv.DNAConv(F, heads=heads, groups=groups, **CPU), variant, True,
         x=x)


@pytest.mark.parametrize('variant', ['coo', 'coo mask', 'EdgeIndex'])
def test_pan_conv_matches_jax(variant):
    """Both outputs, ``lin(M x)`` and the normalised MET matrix."""
    _run(jconv.PANConv(out_channels=C, filter_size=2),
         conv.PANConv(F, C, filter_size=2, **CPU), variant, False)


def test_restricted_softmax_matches_jax():
    a = np.random.default_rng(4).standard_normal((7, 5, 3)).astype(
        np.float32) * 3
    for dim in (1, -1):
        np.testing.assert_allclose(
            dna_conv.restricted_softmax(t(a), dim).numpy(),
            np.asarray(jdna.restricted_softmax(jnp.asarray(a), dim)),
            rtol=0, atol=1e-6)


def test_cheb_conv_lambda_max():
    """``lambda_max`` scales the Laplacian and the folded diagonal."""
    je, te, _ = _edges('coo', False)
    compare(jconv.ChebConv(out_channels=C, K=3),
            conv.ChebConv(F, C, K=3, **CPU), X, (je,), (te,),
            jkw={'lambda_max': 1.5}, tkw={'lambda_max': 1.5})


def test_convert_rules_round_trip():
    """ARMAConv's ``stack_k_{w,v}_{t|shared}``, MFConv's ``lin_{l,r}_d``
    and GatedGraphConv's flax ``GRUCell`` (r, z, n packed; ``b_hr = b_hz =
    0``) load strictly into the port's modules and give back the flax
    arrays."""
    cases = [(jconv.ARMAConv(out_channels=C, num_stacks=2, num_layers=2,
                             shared_weights=True),
              conv.ARMAConv(F, C, num_stacks=2, num_layers=2,
                            shared_weights=True, **CPU)),
             (jconv.MFConv(out_channels=C, max_degree=2),
              conv.MFConv(F, C, max_degree=2, **CPU)),
             (jconv.GatedGraphConv(out_channels=F, num_layers=1),
              conv.GatedGraphConv(F, **CPU))]
    coo = jnp.asarray(COO[:, :E])
    for jm, tm in cases:
        v = init_variables(jm, 0, jnp.asarray(X), coo)
        sd = flax_to_state_dict(v)
        tm.load_state_dict(sd)
        assert set(sd) == set(tm.state_dict())
    p = v['params']
    rnn = tm.state_dict()
    for i, g in enumerate('rzn'):
        np.testing.assert_array_equal(
            rnn['rnn.weight_ih'][i * F:(i + 1) * F].numpy(),
            np.asarray(p['rnn']['i' + g]['kernel']).T)
        np.testing.assert_array_equal(
            rnn['rnn.bias_ih'][i * F:(i + 1) * F].numpy(),
            np.asarray(p['rnn']['i' + g]['bias']))
    assert not rnn['rnn.bias_hh'][:2 * F].any()
    np.testing.assert_array_equal(rnn['rnn.bias_hh'][2 * F:].numpy(),
                                  np.asarray(p['rnn']['hn']['bias']))
    arma = cases[0][1].state_dict()
    assert {'stacks.1.w_shared.weight', 'stacks.1.v_shared.bias',
            'stacks.0.w_0.weight'} <= set(arma)
