"""The port's SpMM regime policy against the JAX package's, on the CPU:
``spmm_regime`` and ``fill_cache(auto=True)`` decide alike under equal
constants (the ``tpu_decisions`` fixture emulates an accelerator's policy
on the CPU as ``tests/test_spmm_policy.py``'s does, and every knob is set to
one value for both packages); the port's own H100 defaults are pinned by
cases that name the rows of the sweep that set them (``kernel_ab.py --only
policy``, PERF.md section 6); ``cache_gcn_norm(auto=True)``; and the sparse
runtime on the CPU as a whole in both packages: ``products_bench.py --infer``'s
net on a tiny products graph in the windowed regime, and
``examples/giant_graph.py``'s model at its toy default, 3 Adam steps.

The JAX package's ``'pallas'`` / ``'gather-sorted'`` / ``'gather'`` are the
port's ``'kernel'`` (on the card) / ``'plain'`` (on the CPU): one sparse
sum, mapped to one name here.

Limits: outputs within ``1e-5 * max(1, max|ref|)``, losses within 1e-4
relative, gradients within ``1e-4 * max|g|`` (sums in other orders)."""

import importlib
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.nn import GATConv as JGATConv
from pytorch_geometric_tpu.nn import SAGEConv as JSAGEConv
from pytorch_geometric_tpu.nn import cache_gcn_norm as jcache_gcn_norm
from pytorch_geometric_tpu.ops import spmm as jspmm, spmm_regime as jregime
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import cache_gcn_norm
from pytorch_geometric_tpu_torch.ops import auto_dense_cap, spmm, spmm_regime

ROOT = Path(__file__).resolve().parents[1]
JSPMM = importlib.import_module('pytorch_geometric_tpu.ops.spmm')
TSPMM = importlib.import_module('pytorch_geometric_tpu_torch.ops.spmm')
SPARSE = {'pallas', 'gather-sorted', 'gather', 'kernel', 'plain'}


def _name(regime):
    return 'sparse' if regime in SPARSE else regime


@pytest.fixture
def tpu_decisions(monkeypatch):
    """Emulate an accelerator's policy on the CPU backend, in both
    packages."""
    monkeypatch.setenv('PGT_FORCE_DENSE_SPMM', '1')
    yield


def _clustered_coo(rng, n_blocks=24, per_block=260):
    """Edges inside 128-node blocks (block-dense), as
    ``tests/test_spmm_policy.py``'s graph."""
    base = np.repeat(np.arange(n_blocks) * 128, per_block)
    return np.stack([base + rng.integers(0, 128, base.size),
                     base + rng.integers(0, 128, base.size)]).astype(
        np.int32), n_blocks * 128


def _graph(kind, rng):
    if kind == 'small':
        return rng.integers(0, 500, (2, 4000)).astype(np.int32), 500
    if kind == 'clustered':
        return _clustered_coo(rng)
    if kind == 'scattered':
        return rng.integers(0, 3072, (2, 4000)).astype(np.int32), 3072
    return rng.integers(0, 2000, (2, 30_000)).astype(np.int32), 2000


# (graph, knobs both packages read, whether the fill passes weights)
CASES = [
    ('small', {}, False),
    ('small', {}, True),
    ('small', {'PGT_DENSE_SPMM_ENTRIES': '1000'}, False),
    ('clustered', {'PGT_DENSE_SPMM_ENTRIES': '100000'}, False),
    ('clustered', {'PGT_DENSE_SPMM_ENTRIES': '100000',
                   'PGT_DISABLE_BSR_SPMM': '1'}, False),
    ('scattered', {'PGT_DENSE_SPMM_ENTRIES': '100000'}, False),
    ('scattered', {'PGT_DENSE_SPMM_ENTRIES': '100000',
                   'PGT_AUTO_WIN_MIN_EDGES': '1000'}, False),
    ('scattered', {'PGT_DENSE_SPMM_ENTRIES': '100000',
                   'PGT_AUTO_WIN_MIN_EDGES': '1000',
                   'PGT_DISABLE_WIN_SPMM': '1'}, True),
    ('large', {'PGT_DENSE_SPMM_ENTRIES': '100000',
               'PGT_AUTO_BLOCKED_MAX_EDGES': '10000'}, False),
    ('large', {'PGT_DENSE_SPMM_ENTRIES': '100000',
               'PGT_SPMM_CHUNK_TRIGGER': '1e6'}, False),
    ('small', {'PGT_DISABLE_DENSE_SPMM': '1'}, False),
]


def _equal_constants(monkeypatch, knobs):
    """Every knob at one value in both packages: the environment (both read
    most at call time), the JAX package's import-time chunk trigger and
    dense cap, and the windowed and slot-order thresholds, whose defaults
    differ (the port's come from the card's sweep)."""
    knobs = dict({'PGT_AUTO_WIN_MIN_EDGES': '1e9',
                  'PGT_AUTO_BLOCKED_MAX_EDGES': '1e9'}, **knobs)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    trigger = float(knobs.get('PGT_SPMM_CHUNK_TRIGGER', 4e9))
    monkeypatch.setenv('PGT_SPMM_CHUNK_TRIGGER', repr(trigger))
    monkeypatch.setattr(JSPMM, '_CHUNK_TRIGGER_BYTES', trigger)
    monkeypatch.setattr(JSPMM, '_DENSE_MAX_ENTRIES',
                        int(float(knobs.get('PGT_DENSE_SPMM_ENTRIES',
                                            2.5e8))))


def _outcome(ei):
    return {'dense': ei.dense_adj is not None, 'bsr': ei.bsr is not None,
            'win': ei.win is not None, 'blocked': ei.blocked is not None,
            'weight': ei.weight is not None}


def _decisions(ei, regime):
    return {(f, r, w): _name(regime(ei, f, r, w))
            for f in (1, 16, 64) for r in ('sum', 'mean', 'max')
            for w in (False, True)}


@pytest.mark.parametrize('kind,knobs,weighted', CASES)
@pytest.mark.parametrize('emulate', [True, False])
def test_auto_decides_as_jax(monkeypatch, kind, knobs, weighted, emulate):
    """``fill_cache(auto=True)`` bakes, carries and builds what the JAX
    package does, and ``spmm_regime`` then names the same regime for every
    width, reduction and weighting, on raw and on cached graphs, with and
    without the accelerator emulation (without it, on CPU tensors, auto
    carries the weights and bakes nothing in both)."""
    if emulate:
        monkeypatch.setenv('PGT_FORCE_DENSE_SPMM', '1')
    _equal_constants(monkeypatch, knobs)
    rng = np.random.default_rng(len(kind) + weighted)
    coo, n = _graph(kind, rng)
    w = rng.random(coo.shape[1]).astype(np.float32) if weighted else None
    j = JEdgeIndex(coo, (n, n))
    t = EdgeIndex(coo, (n, n), device='cpu')
    assert _decisions(t, spmm_regime) == _decisions(j, jregime)
    jf = j.fill_cache(auto=True, dense_weight=w)
    tf = t.fill_cache(auto=True, dense_weight=w)
    assert _outcome(tf) == _outcome(jf)
    assert _decisions(tf, spmm_regime) == _decisions(jf, jregime)
    if not emulate:
        assert not _outcome(tf)['dense'] and not _outcome(tf)['bsr']
        assert _outcome(tf)['weight'] == weighted
    # the cached graph computes what the plain sum does
    x = rng.standard_normal((n, 8)).astype(np.float32)
    ref = np.asarray(jspmm(JEdgeIndex(coo, (n, n)), jnp.asarray(x),
                           None if w is None else jnp.asarray(w)))
    got = spmm(tf, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(
        1.0, np.abs(ref).max()))


def test_uncached_dense_decides_as_jax(tpu_decisions, monkeypatch):
    """The uncached dense regime's size rule (``n_src * n_dst`` within the
    dense cap and ``DENSE_ADVANTAGE * E * F``) at equal constants: dense
    where it holds, the sparse sum where it does not, in both packages."""
    monkeypatch.setattr(TSPMM, 'DENSE_ADVANTAGE', JSPMM._DENSE_ADVANTAGE)
    rng = np.random.default_rng(7)
    for n, e in ((300, 3000), (2000, 2000), (4000, 200_000)):
        coo = rng.integers(0, n, (2, e)).astype(np.int32)
        j, t = JEdgeIndex(coo, (n, n)), EdgeIndex(coo, (n, n), device='cpu')
        assert _decisions(t, spmm_regime) == _decisions(j, jregime)
    assert spmm_regime(EdgeIndex(rng.integers(0, 300, (2, 3000)).astype(
        np.int32), (300, 300), device='cpu'), 16) == 'dense'


def _fake_card_adj(n, e, **fields):
    """An EdgeIndex-shaped stand-in on a CUDA device (the policy reads only
    sizes and which caches exist), for the card's decisions on the CPU."""
    base = dict(device=torch.device('cuda'), num_src_nodes=n,
                num_dst_nodes=n, num_edges=e, dense_adj=None, bsr=None,
                bsr_t=None, win=None, win_t=None, weight=None)
    base.update(fields)
    return SimpleNamespace(**base)


def test_card_defaults_pinned_by_the_sweep(monkeypatch):
    """The port's H100 defaults (``ops/spmm.py``), each set by rows of the
    sweep (measured on one H100 80GB HBM3 at 700 W):

    * the uncached dense regime never runs on the card unasked (rows
      'random n=1000 ... n=30000', arm 'dense': slower than 'kernel' at
      every point), even where the JAX package's size rule would pick it
      (30k nodes, 1M edges, F = 128: the serving graph);
    * ``PGT_FORCE_DENSE_SPMM`` still reaches it, under the size rule;
    * auto's dense cache holds at most 1e6 entries (rows 'random n=1000',
      captured: the bf16 cache ahead of 'kernel' at 5 of 9 points; rows
      'random n=10000': behind at every point), bf16 (rows 'random
      n=1000', captured: bf16 ahead of float32 at every point), and no
      block cache (row 'path A clustered': 'bsr' 6.8x behind 'kernel');
    * no windowed layouts unasked (the 'windowed' arm is the 'kernel' arm
      over the CSC views of its layouts: rows 'training n=100000
      deg=100', 'products'); the slot orders up to
      62.5M edges (the 'products' builds); no chunking unasked (rows
      'products': 'chunked' behind 'kernel uncached')."""
    assert TSPMM.AUTO_DENSE_MAX_ENTRIES == 1_000_000
    assert TSPMM.AUTO_CACHE_DTYPE == torch.bfloat16
    assert TSPMM.AUTO_WIN_MIN_EDGES == float('inf')
    assert TSPMM.AUTO_BLOCKED_MAX_EDGES == 62_500_000
    assert TSPMM.CHUNK_TRIGGER_BYTES == float('inf')
    for k in ('PGT_FORCE_DENSE_SPMM', 'PGT_DENSE_SPMM_ENTRIES',
              'PGT_SPMM_CHUNK_TRIGGER', 'PGT_AUTO_WIN_MIN_EDGES',
              'PGT_AUTO_BLOCKED_MAX_EDGES'):
        monkeypatch.delenv(k, raising=False)
    serving = _fake_card_adj(30_000, 1_030_000)
    assert spmm_regime(serving, 128) == 'kernel'
    # the JAX package's rule would densify it: 9e8 <= 36 * E * F
    assert 30_000 ** 2 <= JSPMM._DENSE_ADVANTAGE * 1_030_000 * 128
    monkeypatch.setenv('PGT_FORCE_DENSE_SPMM', '1')
    monkeypatch.setenv('PGT_DENSE_SPMM_ENTRIES', '1e9')
    assert spmm_regime(serving, 128) == 'dense'
    monkeypatch.delenv('PGT_FORCE_DENSE_SPMM')
    monkeypatch.delenv('PGT_DENSE_SPMM_ENTRIES')
    # products at full size: no chunking, no windowed layouts unasked, the
    # windowed regime where they were built
    from pytorch_geometric_tpu_torch.edge_index import auto_win_min_edges
    assert auto_win_min_edges() == float('inf')
    products = _fake_card_adj(2_449_029, 123_718_280)
    assert spmm_regime(products, 100) == 'kernel'
    assert spmm_regime(_fake_card_adj(2_449_029, 123_718_280, win=1,
                                      win_t=1), 100) == 'windowed'
    # the dense cap: the memory rule of an 80 GB card, then the sweep's
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda dev: SimpleNamespace(total_memory=80e9))
    assert auto_dense_cap(4, 'cuda') == 1_000_000
    assert auto_dense_cap(4, 'cpu') == int(2.5e8)
    monkeypatch.setenv('PGT_DENSE_SPMM_ENTRIES', '12345')
    assert auto_dense_cap(4, 'cuda') == 12345


def test_auto_on_cpu_carries_weights_and_bakes_nothing():
    """On CPU tensors auto bakes nothing and carries the weights it is
    given, as the JAX package does on its CPU backend; ``spmm`` applies
    the carried weights (the carried-weight rule)."""
    rng = np.random.default_rng(8)
    coo = rng.integers(0, 120, (2, 900)).astype(np.int32)
    w = rng.random(900).astype(np.float32)
    t = EdgeIndex(coo, (120, 120), device='cpu').fill_cache(
        auto=True, dense_weight=w)
    j = JEdgeIndex(coo, (120, 120)).fill_cache(auto=True,
                                               dense_weight=jnp.asarray(w))
    assert _outcome(t) == _outcome(j) == {
        'dense': False, 'bsr': False, 'win': False, 'blocked': True,
        'weight': True}
    x = rng.standard_normal((120, 8)).astype(np.float32)
    np.testing.assert_allclose(spmm(t, torch.from_numpy(x)).numpy(),
                               np.asarray(jspmm(j, jnp.asarray(x))),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize('emulate', [False, True])
def test_cache_gcn_norm_auto_matches_jax(monkeypatch, emulate):
    """``cache_gcn_norm(auto=True)`` in both packages: the normalised
    weights carried (CPU) or baked into the float32 dense cache (the
    accelerator emulation), the same aggregation either way."""
    if emulate:
        monkeypatch.setenv('PGT_FORCE_DENSE_SPMM', '1')
    rng = np.random.default_rng(9)
    coo = rng.integers(0, 150, (2, 1200)).astype(np.int32)
    t = cache_gcn_norm(EdgeIndex(coo, (150, 150), device='cpu'), auto=True)
    j = jcache_gcn_norm(JEdgeIndex(coo, (150, 150)), auto=True)
    assert _outcome(t) == _outcome(j)
    assert _outcome(t)['dense'] == emulate
    if emulate:
        np.testing.assert_allclose(t.dense_adj.numpy(),
                                   np.asarray(j.dense_adj), rtol=0,
                                   atol=1e-6)
    x = rng.standard_normal((150, 16)).astype(np.float32)
    ref = np.asarray(jspmm(j, jnp.asarray(x)))
    np.testing.assert_allclose(spmm(t, torch.from_numpy(x)).numpy(), ref,
                               rtol=0, atol=1e-5 * max(1, np.abs(ref).max()))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_products_infer_net_matches_jax(monkeypatch):
    """``chip_smoke.py``'s path R model (``products_bench.py --infer``'s
    net) on a 600-node products graph through ``fill_cache(auto=True)``
    with the windowed threshold lowered, in float32 and with bf16 x,
    against the JAX package's net (``run_infer``'s ``Layer`` / ``Net``) on
    the same weights and graph, both in the windowed regime."""
    monkeypatch.setenv('PGT_AUTO_WIN_MIN_EDGES', '1000')
    smoke = _load('chip_smoke', 'chip_smoke.py')
    n, e = 600, 9000
    coo = smoke.products_graph(n, e, 0)
    x = np.random.default_rng(3).standard_normal(
        (n, smoke.PR_F)).astype(np.float32)
    jei = JEdgeIndex(coo, (n, n)).fill_cache(auto=True)
    tei = EdgeIndex(coo, (n, n), device='cpu').fill_cache(auto=True)
    assert jregime(jei, smoke.PR_HIDDEN) == 'windowed'
    assert spmm_regime(tei, smoke.PR_HIDDEN) == 'windowed'

    class Layer(fnn.Module):
        feats: int

        @fnn.compact
        def __call__(self, x, ei):
            agg = jspmm(ei, x, reduce='mean')
            return (fnn.Dense(self.feats, name='l')(agg)
                    + fnn.Dense(self.feats, name='r')(x))

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x, ei):
            x = fnn.relu(Layer(smoke.PR_HIDDEN)(x, ei))
            return Layer(smoke.PR_CLASSES)(x, ei)

    net = Net()
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x), jei)
    model = smoke.products_infer_net(torch, 'cpu', 0)
    model.load_state_dict(flax_to_state_dict(params))
    ref = np.asarray(net.apply(params, jnp.asarray(x), jei))
    with torch.no_grad():
        got = model(torch.from_numpy(x), tei).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    # bf16 x: layer 1's messages in bf16 (each package rounds its own way),
    # the rest float32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref_b = np.asarray(net.apply(params, jnp.asarray(x, jnp.bfloat16), jei),
                       np.float32)
    with torch.no_grad():
        got_b = model(xb, tei)
    assert got_b.dtype == torch.float32
    np.testing.assert_allclose(got_b.numpy(), ref_b, rtol=0,
                               atol=2e-2 * max(1.0, np.abs(ref_b).max()))


def test_giant_graph_model_trains_like_jax(monkeypatch):
    """``examples/giant_graph.py``'s model at its toy default (2,000 nodes,
    20,000 edges, its env caps: the windowed regime for the SAGE layer, the
    flash scan for the GAT layer) in both packages from the same weights:
    the first step's forward and gradients, and 3 Adam (1e-2) steps'
    losses, against optax."""
    smoke = _load('chip_smoke', 'chip_smoke.py')
    for k, v in smoke.PS_TOY_ENV.items():
        monkeypatch.setenv(k, v)
    n, e = smoke.PS_TOY_NODES, smoke.PS_TOY_EDGES
    rng = np.random.default_rng(0)
    coo = np.stack([rng.integers(0, n, e),
                    rng.integers(0, n, e)]).astype(np.int32)
    x = rng.standard_normal((n, smoke.PS_F)).astype(np.float32)
    y = rng.integers(0, smoke.PS_CLASSES, n).astype(np.int32)
    jei = JEdgeIndex(coo, (n, n)).fill_cache(auto=True, block_sparse=False)
    tei = EdgeIndex(coo, (n, n), device='cpu').fill_cache(
        auto=True, block_sparse=False)
    assert jregime(jei) == spmm_regime(tei) == 'windowed'

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x, ei, coo):
            x = fnn.relu(JSAGEConv(out_channels=smoke.PS_HIDDEN)(x, ei))
            x = fnn.relu(JGATConv(out_channels=smoke.PS_HIDDEN
                                  // smoke.PS_HEADS,
                                  heads=smoke.PS_HEADS)(x, coo))
            return fnn.Dense(smoke.PS_CLASSES)(x)

    net = Net()
    xj, cj, yj = jnp.asarray(x), jnp.asarray(coo), jnp.asarray(y)
    params = net.init(jax.random.PRNGKey(0), xj, jei, cj)
    tx = optax.adam(smoke.PS_LR)

    def loss_fn(p):
        out = net.apply(p, xj, jei, cj)
        return optax.softmax_cross_entropy_with_integer_labels(
            out, yj).mean(), out

    @jax.jit
    def step(p, o):
        (loss, out), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        upd, o = tx.update(g, o)
        return optax.apply_updates(p, upd), o, loss, g, out

    p, o = params, tx.init(params)
    jlosses = []
    for i in range(3):
        p, o, loss, g, out = step(p, o)
        jlosses.append(float(loss))
        if i == 0:
            jgrads, jout = flax_to_state_dict(g), np.asarray(out)
    model = smoke.giant_graph_net(torch, 'cpu', 0)
    model.load_state_dict(flax_to_state_dict(params))
    opt = torch.optim.Adam(model.parameters(), lr=smoke.PS_LR)
    graph = {'ei': tei, 'coo': torch.from_numpy(coo)}
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    tlosses = []
    for i in range(3):
        opt.zero_grad(set_to_none=True)
        out = model(xt, graph)
        loss = F.cross_entropy(out, yt)
        loss.backward()
        if i == 0:
            np.testing.assert_allclose(
                out.detach().numpy(), jout, rtol=0,
                atol=1e-5 * max(1.0, np.abs(jout).max()))
            for k, prm in model.named_parameters():
                ref = jgrads[k].numpy()
                np.testing.assert_allclose(
                    prm.grad.numpy(), ref, rtol=0,
                    atol=1e-4 * max(np.abs(ref).max(), 1e-30), err_msg=k)
        opt.step()
        tlosses.append(loss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
