"""The port's scan pair (``loader/scan_train.py``) against the JAX
package's, on the CPU: ``stack_batches`` (its keys, its arrays, the int16
rule on both sides of ``2**15 - 1``) and ``make_device_train_step``'s
``step_fn`` x K and ``scan_fn`` from the same ``GraphSAGE(hidden 16, 2
layers)`` weights (carried across by ``convert.flax_to_state_dict``),
``optax.adam`` against ``torch.optim.Adam``. The port's step runs the kernel
route (each batch's ``EdgeIndex``, a SAGE mean over its CSC); the JAX
package's aggregates the COO with the mask (the gather route), which the
port's step also takes with a loss that passes them: the two routes agree
within 1e-6, and a row with no valid in-edge is 0 on both. Also: the
port's ``NeighborLoader`` over ``chip_smoke.py``'s products graph at 0.01
scale gives the JAX package's batches, on the native and the numpy sampler.

The batches are made from a numpy seed at the padded shape a
``NeighborLoader`` gives (``n_cap`` local nodes, the ``n_cap`` sentinel on
padded edges, node and edge masks, the seeds first). On the CPU the
compiled pair runs eagerly, as the JAX package's tests run its jit on the
CPU.

Tolerances: losses within 1e-5 relative, parameters within 1e-5 absolute
(float32 sums and Adam's arithmetic in another order); the port's
``scan_fn`` equals its ``step_fn`` x K exactly."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.loader.scan_train import (
    make_device_train_step as jmake_device_train_step,
    stack_batches as jstack_batches)
from pytorch_geometric_tpu.nn.models import GraphSAGE as JGraphSAGE
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.loader import (make_device_train_step,
                                                stack_batches)
from pytorch_geometric_tpu_torch.nn.models import GraphSAGE

N, F, C, K = 300, 12, 5, 4
BATCH, FANOUTS = 16, (5, 3)
LR = 1e-2


def padded_batch(rng, n, batch, fanouts, valid=0.8):
    """One batch at a NeighborLoader's padded shape: ``batch`` seeds, then
    ``fanouts[0]`` slots per seed, then ``fanouts[1]`` per hop-1 slot; a
    slot is filled with probability ``valid`` (a padded node has ``n_id``
    ``n``, out of the table, which the node mask must hide); an edge runs
    from a slot to its parent and is padded (both ends ``n_cap``) when
    either end is."""
    f1, f2 = fanouts
    n_cap = batch * (1 + f1 + f1 * f2)
    node_mask = np.concatenate([np.ones(batch, bool),
                                rng.random(n_cap - batch) < valid])
    n_id = np.where(node_mask, rng.integers(0, n, n_cap), n)
    hop1 = np.arange(batch, batch + batch * f1)
    hop2 = np.arange(batch + batch * f1, n_cap)
    src = np.concatenate([hop1, hop2])
    dst = np.concatenate([np.arange(batch).repeat(f1),
                          hop1.repeat(f2)])
    edge_mask = node_mask[src] & node_mask[dst]
    coo = np.where(edge_mask, np.stack([src, dst]), n_cap).astype(np.int32)
    return SimpleNamespace(num_nodes=n_cap, batch_size=batch,
                           n_id=n_id.astype(np.int32), node_mask=node_mask,
                           edge_index=coo, edge_mask=edge_mask)


def _pipeline(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F)).astype(np.float32)
    Y = rng.integers(0, C, N).astype(np.int32)
    batches = [padded_batch(rng, N, BATCH, FANOUTS) for _ in range(K)]
    jm = JGraphSAGE(hidden_channels=16, num_layers=2, out_channels=C)
    n_cap = batches[0].num_nodes
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(X[:n_cap]),
                     batches[0].edge_index)
    return jm, params, X, Y, batches


def _port(params):
    model = GraphSAGE(F, 16, 2, C, device='cpu')
    model.load_state_dict(flax_to_state_dict(params))
    return model, torch.optim.Adam(model.parameters(), lr=LR)


def _close_params(model, jparams):
    ref = flax_to_state_dict(jparams)
    got = model.state_dict()
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_stack_batches_matches_jax():
    _, _, _, _, batches = _pipeline()
    ref = jstack_batches(batches)
    got = stack_batches(batches, device='cpu')
    assert list(got) == list(ref)
    for k in ref:
        r = np.asarray(ref[k])
        g = got[k].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        np.testing.assert_array_equal(g, r, err_msg=k)
    assert got['edge_index'].dtype == torch.int16
    assert got['seed_mask'][:, :BATCH].all()
    assert not got['seed_mask'][:, BATCH:].any()


@pytest.mark.parametrize('n_cap,dtype', [(2 ** 15 - 2, torch.int16),
                                         (2 ** 15 - 1, torch.int32)])
def test_int16_rule_matches_jax(n_cap, dtype):
    """The edge ids (the ``n_cap`` sentinel included) travel as int16 only
    while ``n_cap < 2**15 - 1``, on both sides."""
    rng = np.random.default_rng(n_cap)
    batches = []
    for _ in range(2):
        coo = rng.integers(0, n_cap, (2, 40))
        coo[:, -4:] = n_cap
        batches.append(SimpleNamespace(
            num_nodes=n_cap, batch_size=3,
            n_id=rng.integers(0, 10 ** 6, n_cap).astype(np.int32),
            node_mask=np.ones(n_cap, bool), edge_index=coo.astype(np.int32),
            edge_mask=np.arange(40) < 36))
    ref = jstack_batches(batches)
    got = stack_batches(batches, device='cpu')
    assert got['edge_index'].dtype == dtype
    assert np.asarray(ref['edge_index']).dtype == got['edge_index'].numpy(
        ).dtype
    np.testing.assert_array_equal(got['edge_index'].numpy(),
                                  np.asarray(ref['edge_index']))
    assert int(got['edge_index'].max()) == n_cap


def test_step_and_scan_match_jax():
    jm, params, X, Y, batches = _pipeline()
    tx = optax.adam(LR)
    jstep, jscan = jmake_device_train_step(jm, tx)
    jstacked = jstack_batches(batches)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    pa, oa, jlosses = params, tx.init(params), []
    for i in range(K):
        b = jax.tree_util.tree_map(lambda v: v[i], jstacked)
        pa, oa, loss = jstep(pa, oa, Xj, Yj, b)
        jlosses.append(float(loss))
    pb, _, jscan_loss = jscan(params, tx.init(params), Xj, Yj, jstacked)

    stacked = stack_batches(batches, device='cpu')
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    model_a, opt_a = _port(params)
    step_fn, _ = make_device_train_step(model_a, opt_a)
    losses = [float(step_fn(Xt, Yt, {k: v[i] for k, v in stacked.items()}))
              for i in range(K)]
    model_b, opt_b = _port(params)
    _, scan_fn = make_device_train_step(model_b, opt_b)
    scan_loss = scan_fn(Xt, Yt, stacked)

    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(float(scan_loss), float(jscan_loss),
                               rtol=1e-5)
    _close_params(model_a, pa)
    _close_params(model_b, pb)
    # one body: the scan takes the same steps, bit for bit
    assert float(scan_loss) == losses[-1]
    for (ka, a), (kb, b) in zip(model_a.state_dict().items(),
                                model_b.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    assert losses[-1] < losses[0]


def test_pair_runs_eagerly_on_the_cpu():
    """CPU tensors are the caller asking for the CPU: no capture, no
    replay, and each call is one step."""
    _, params, X, Y, batches = _pipeline(seed=1)
    stacked = stack_batches(batches, device='cpu')
    model, opt = _port(params)
    step_fn, scan_fn = make_device_train_step(model, opt)
    scan_fn(torch.from_numpy(X), torch.from_numpy(Y), stacked)
    assert opt.state[next(model.parameters())]['step'] == K
    assert scan_fn.replays == 0 and scan_fn.captures == 0
    assert step_fn.replays == 0


ROOT = Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _loader_batches(cls, data_cls, coo, n, k):
    """The first ``k`` batches of ``products_bench.py``'s sampled-training
    loader (``:171-174``) over ``coo``, from one package's classes."""
    loader = cls(data_cls(edge_index=coo, num_nodes=n), [15, 10],
                 batch_size=512, shuffle=True, filter_features=False)
    it = iter(loader)
    return [next(it) for _ in range(k)]


# products_bench's graph at 1 % of its size: 24,490 nodes, 1,237,182 edges
PRODUCTS_SCALE = 0.01


def _products_loaders_match(monkeypatch, native, k):
    """``chip_smoke.py``'s copy of ``build_products_like`` gives the bench's
    graph, and the port's ``NeighborLoader`` over it the JAX package's first
    ``k`` batches (batch 512, fan-outs [15, 10], ``filter_features=False``),
    field for field, both on their native or both on their numpy sampler.
    Returns the port's batches."""
    import pytorch_geometric_tpu.csrc as jcsrc
    from pytorch_geometric_tpu.data import Data as JData
    from pytorch_geometric_tpu.loader import NeighborLoader as JNeighborLoader
    from pytorch_geometric_tpu_torch import csrc
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.loader import NeighborLoader
    smoke = _load('chip_smoke', 'chip_smoke.py')
    bench = _load('products_bench', 'benchmarks/products_bench.py')
    coo, n, e = bench.build_products_like(scale=PRODUCTS_SCALE)
    np.testing.assert_array_equal(smoke.products_graph(n, e, 0), coo)
    if native:
        assert jcsrc.WITH_NATIVE_SAMPLER and csrc.WITH_NATIVE_SAMPLER
    monkeypatch.setattr(jcsrc, 'WITH_NATIVE_SAMPLER', native)
    monkeypatch.setattr(csrc, 'WITH_NATIVE_SAMPLER', native)
    got = _loader_batches(NeighborLoader, Data, coo, n, k)
    ref = _loader_batches(JNeighborLoader, JData, coo, n, k)
    for g, r in zip(got, ref):
        assert g.num_nodes == int(r.num_nodes) == 84992
        assert int(g.batch_size) == int(r.batch_size) == 512
        assert sorted(g.keys()) == sorted(r.keys())
        for key in r.keys():
            a, b = g[key].numpy(), np.asarray(r[key])
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
    return smoke, got


def test_chip_smoke_products_batches_match_the_jax_loader(monkeypatch):
    """The scan traffic of ``chip_smoke.py`` is ``products_bench.py``'s: the
    same graph, and the port's loader gives the JAX package's batches on the
    numpy sampler."""
    _products_loaders_match(monkeypatch, native=False, k=3)


def test_chip_smoke_products_fill_matches_the_native_sampler(monkeypatch):
    """On the native sampler (``products_bench.py``'s, and the one
    ``chip_smoke.py`` requires), the port's loader gives the JAX package's
    batches too, and ``chip_smoke.batch_fill`` reads their fill: it draws
    other neighbours than the numpy sampler but fills a like share of the
    padded batch."""
    smoke, got = _products_loaders_match(monkeypatch, native=True, k=4)
    fill = smoke.batch_fill(got, (15, 10))
    assert fill['n_cap'] == 84992 and fill['edge_slots'] == 84480
    assert 0.2 < fill['node_fill'] < 0.9
    assert 0.5 < fill['edge_fill'] <= 1.0


def test_kernel_route_step_matches_the_gather_route():
    """From the same weights, one step of the kernel route (the batch's
    ``EdgeIndex``, a SAGE mean over its CSC) and one of the gather route (the
    COO and the mask) on each batch: losses within 1e-6 relative, every
    gradient within 1e-6 of its largest magnitude (float32 sums in another
    order)."""
    from pytorch_geometric_tpu_torch.loader.scan_train import \
        gather_cross_entropy
    _, params, X, Y, batches = _pipeline(seed=2)
    stacked = stack_batches(batches, device='cpu')
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    for i in range(K):
        b = {k: v[i] for k, v in stacked.items()}
        runs = []
        for loss_fn in (None, gather_cross_entropy):
            model, opt = _port(params)
            step_fn, _ = make_device_train_step(model, opt, loss_fn)
            loss = float(step_fn(Xt, Yt, b))
            runs.append((loss, {k: p.grad.clone()
                                for k, p in model.named_parameters()}))
        (l_k, g_k), (l_g, g_g) = runs
        assert abs(l_k - l_g) <= 1e-6 * abs(l_g)
        for k in g_g:
            scale = float(g_g[k].abs().max())
            assert float((g_k[k] - g_g[k]).abs().max()) <= 1e-6 * max(
                scale, 1e-30), (i, k)


def test_mean_with_no_valid_in_edge_is_zero():
    """A row whose in-edges are all padded (or that has none): the CSC mean
    of the kernel route divides its empty sum by max(degree, 1), the
    gather route's masked scatter-mean by max(count, 1); both give 0, and a
    SAGE layer on either route agrees everywhere."""
    from pytorch_geometric_tpu_torch.loader.scan_train import (
        batch_edge_index)
    from pytorch_geometric_tpu_torch.nn.conv import SAGEConv
    from pytorch_geometric_tpu_torch.ops import scatter, spmm
    rng = np.random.default_rng(3)
    n_cap = 12
    coo = torch.tensor([[3, 4, 5, 6, 7, 8], [0, 0, 1, 2, 2, 9]])
    mask = torch.tensor([True, True, True, False, False, True])
    x = torch.from_numpy(rng.standard_normal((n_cap, 5)).astype(np.float32))
    ei = batch_edge_index(coo, mask, n_cap)
    kernel = spmm(ei, x, reduce='mean')
    gather = scatter(x[coo[0]], coo[1], n_cap, reduce='mean', mask=mask)
    # row 2 (both in-edges padded) and rows without in-edges: exactly 0
    empty = [2, 3, 4, 5, 6, 7, 8, 10, 11]
    assert torch.equal(kernel[empty], torch.zeros(len(empty), 5))
    assert torch.equal(gather[empty], torch.zeros(len(empty), 5))
    torch.testing.assert_close(kernel, gather, rtol=0, atol=1e-6)
    conv = SAGEConv(5, 4, device='cpu')
    torch.testing.assert_close(conv(x, ei), conv(x, coo, edge_mask=mask),
                               rtol=0, atol=1e-6)
