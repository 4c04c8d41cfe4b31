"""The port's ``nn/pool/select.py``, ``nn/pool/topk_pool.py`` and
``GraphUNet`` against the JAX package's, on the CPU: ``select_topk`` over
batched, padded and masked scores (by ratio and by ``min_score``),
``filter_edges``, ``SelectTopK``, ``TopKPooling``, ``SAGPooling`` and
``PANPooling`` on a batch of graphs (every output of ``PoolOutput``), and
``GraphUNet`` (sum and concatenated skips, edge weights, an edge mask);
ties in every top-k going to the lowest index, as ``jax.lax.top_k`` breaks
them.

Tolerances: outputs within 1e-5 * max(1, max|ref|), gradients within 1e-4
of each gradient's largest entry (``_torch_parity``); indices and masks
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (close, compare, edge_variant, grad_close, graph,
                           init_variables, t)
from pytorch_geometric_tpu.nn import models as jmodels
from pytorch_geometric_tpu.nn.pool import select as jselect
from pytorch_geometric_tpu.nn.pool import topk_pool as jtopk
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import models
from pytorch_geometric_tpu_torch.nn.pool import select as tselect
from pytorch_geometric_tpu_torch.nn.pool import topk_pool as ttopk

CPU = dict(device='cpu')
N, E, F, PAD, B = 36, 120, 5, 4, 3
X, COO, MASK, W = graph(31, N, E, F, PAD)
# three graphs of 14, 12 and 10 nodes; edges kept inside their graph
BATCH = np.repeat(np.arange(B), [14, 12, 10]).astype(np.int32)
_inside = BATCH[np.minimum(COO[0], N - 1)] == BATCH[np.minimum(COO[1],
                                                                N - 1)]
COO[1] = np.where(_inside | (COO[0] == N), COO[1], COO[0])
MAX_NODES = 14
NODE_MASK = np.random.default_rng(32).random(N) < 0.9


def _same(got, ref, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(ref), err_msg=what)


def _scores(seed, ties=False):
    s = np.random.default_rng(seed).standard_normal(N).astype(np.float32)
    if ties:
        s[::3] = s[0]                     # many equal scores
    return s


@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('case', ['ratio', 'ratio masked', 'min_score',
                                  'min_score masked'])
def test_select_topk_and_filter_edges_match_jax(case, ties):
    score = _scores(33, ties)
    ratio, min_score = 0.5, None
    if case.startswith('min_score'):
        ratio, min_score = 0.5, -0.2
    nm = NODE_MASK if case.endswith('masked') else None
    want = jselect.select_topk(jnp.asarray(score), jnp.asarray(BATCH), B,
                               ratio, MAX_NODES, min_score,
                               None if nm is None else jnp.asarray(nm))
    got = tselect.select_topk(t(score), t(BATCH), B, ratio, MAX_NODES,
                              min_score, t(nm))
    for name in ('node_index', 'mask', 'weight', 'batch'):
        _same(getattr(got, name), getattr(want, name), name)
    assert got.cluster_size == want.cluster_size
    for coo in (COO, COO[:, :E]):
        jcoo, jkeep = jselect.filter_edges(jnp.asarray(coo), want, N)
        tcoo, tkeep = tselect.filter_edges(t(coo), got, N)
        _same(tcoo, jcoo, 'edges')
        _same(tkeep, jkeep, 'edge mask')


@pytest.mark.parametrize('min_score', [None, 0.02])
def test_select_top_k_module_matches_jax(min_score):
    """The selection exact, the weights within the tolerance, and the
    gradients of the weights' weighted sum for x and the scoring weight."""
    jm = jselect.SelectTopK(in_channels=F, min_score=min_score)
    args = (jnp.asarray(BATCH), B, MAX_NODES, jnp.asarray(NODE_MASK))
    variables = init_variables(jm, 0, jnp.asarray(X), *args)
    slots = MAX_NODES if min_score is not None else -(-MAX_NODES // 2)
    cot = np.random.default_rng(34).standard_normal(B * slots).astype(
        np.float32)

    def jf(p, x):
        out = jm.apply({'params': p}, x, *args)
        return (out.weight * cot).sum(), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        jf, (0, 1), has_aux=True))(variables['params'], jnp.asarray(X))
    tm = tselect.SelectTopK(F, min_score=min_score, **CPU)
    tm.load_state_dict(flax_to_state_dict(variables))
    tx = t(X).requires_grad_()
    got = tm(tx, t(BATCH), B, MAX_NODES, t(NODE_MASK))
    for name in ('node_index', 'mask', 'batch'):
        _same(getattr(got, name), getattr(want, name), name)
    close(got.weight, want.weight)
    (got.weight * t(cot)).sum().backward()
    grad_close(tx.grad, gx)
    grad_close(tm.weight.grad, gp['weight'])


POOLS = {
    'TopKPooling': (lambda **kw: jtopk.TopKPooling(in_channels=F, **kw),
                    lambda **kw: ttopk.TopKPooling(F, **kw, **CPU)),
    'SAGPooling': (lambda **kw: jtopk.SAGPooling(in_channels=F, **kw),
                   lambda **kw: ttopk.SAGPooling(F, **kw, **CPU)),
    'PANPooling': (lambda **kw: jtopk.PANPooling(in_channels=F, **kw),
                   lambda **kw: ttopk.PANPooling(F, **kw, **CPU)),
}


@pytest.mark.parametrize('case', ['ratio', 'min_score multiplier'])
@pytest.mark.parametrize('name', sorted(POOLS))
def test_pooling_matches_jax(name, case):
    """Every ``PoolOutput`` field: the gated features (and gradients) and
    the scores within the tolerances, the rest exact; a self loop on some
    nodes for PANPooling's diagonal."""
    kw = ({'ratio': 0.6} if case == 'ratio'
          else {'min_score': 0.0, 'multiplier': 2.0})
    jbuild, tbuild = POOLS[name]
    coo = COO.copy()
    coo[1, :5] = coo[0, :5]
    args = (B, MAX_NODES)
    compare(jbuild(**kw), tbuild(**kw), X,
            (jnp.asarray(coo), jnp.asarray(BATCH)) + args,
            (t(coo), t(BATCH)) + args)


def test_pooling_defaults_to_one_graph():
    """No ``batch``: one graph of every node, on both."""
    jm, tm = POOLS['TopKPooling'][0](), POOLS['TopKPooling'][1]()
    compare(jm, tm, X, (jnp.asarray(COO[:, :E]),), (t(COO[:, :E]),))


@pytest.mark.parametrize('variant', ['coo', 'coo mask', 'EdgeIndex'])
@pytest.mark.parametrize('sum_res', [True, False])
def test_graph_unet_matches_jax(sum_res, variant):
    """Depth 3 at ratio 0.5 (36 -> 18 -> 9 -> 5 nodes); the masked COO
    carries edge weights."""
    je, te, kw = edge_variant(variant, COO, MASK, W, N, E,
                              weighted=variant == 'coo mask')
    compare(jmodels.GraphUNet(hidden_channels=8, out_channels=4, depth=3,
                              sum_res=sum_res),
            models.GraphUNet(F, 8, 4, depth=3, sum_res=sum_res, **CPU), X,
            (je,), (te,), jkw={k: jnp.asarray(v) for k, v in kw.items()},
            tkw={k: t(v) for k, v in kw.items()})


def test_graph_unet_ties_go_to_the_lowest_node():
    """Rows of x repeated (and no edges into them), so pooling scores
    tie: the kept nodes and the output are the JAX package's."""
    x = np.repeat(X[:12], 3, axis=0)
    coo = np.stack([np.arange(0, N, 3), np.arange(0, N, 3)])
    compare(jmodels.GraphUNet(hidden_channels=8, out_channels=4, depth=2),
            models.GraphUNet(F, 8, 4, depth=2, **CPU), x,
            (jnp.asarray(coo),), (t(coo),))
    # the select's top-k helper on ties, the lowest index first
    score = torch.tensor([0.5, 0.2, 0.5, 0.9, 0.5, 0.9])
    _same(tselect.top_k(score, 5)[1], [3, 5, 0, 2, 4])
