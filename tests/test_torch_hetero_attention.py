"""HGTConv and HANConv through the PyTorch port against the JAX package
(the slice end to end, path N's model trained, is
``tests/test_torch_hetero_train.py``).

Every port module is built from the JAX module's parameters
(``convert.flax_to_state_dict``, strict names). HGT runs on all three
``attn_path`` s ('fused' on raw COOs, its wide op and, with
``PGT_ATTN_WIDE_BYTES=0``, its flash scan; 'blocked' over ``EdgeIndex`` es
with slot orders, rectangular relations included; 'concat') and on the
``flash_layouts`` route; HAN on its plain and flash routes. The JAX
package's fused branches run under ``PGT_FORCE_PALLAS=1`` (Pallas interpret
mode), the port's kernels as their plain versions, through the same
wrappers and autograd Functions that serve the card. Graphs carry padded
edges (both endpoints at the node counts).

Tolerances: outputs and every parameter's and input's gradient in float32
with ``rtol=1e-4``, ``atol=1e-5`` (the same sums in another order)."""

import sys

import jax
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.nn import HANConv as JHAN
from pytorch_geometric_tpu.nn import HGTConv as JHGT
from pytorch_geometric_tpu.ops import build_hgt_flash_layouts as j_layouts
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import HANConv, HGTConv
from pytorch_geometric_tpu_torch.ops import build_hgt_flash_layouts

RTOL, ATOL = 1e-4, 1e-5
NODES = {'paper': 17, 'author': 23, 'institution': 4, 'field': 7}
RELS = {('author', 'writes', 'paper'): 50, ('paper', 'cites', 'paper'): 40,
        ('paper', 'has_topic', 'field'): 30,
        ('author', 'affiliated_with', 'institution'): 12}


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv('PGT_FORCE_PALLAS', '1')


def _close(got, ref, what='', rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


def _graph(seed, f=16):
    """The MAG schema at a tiny size with its reverse relations; the
    ``writes`` relation and its reverse carry 3 padded edges each."""
    rng = np.random.default_rng(seed)
    ei = {}
    for (s, r, d), e in RELS.items():
        coo = np.stack([rng.integers(0, NODES[s], e),
                        rng.integers(0, NODES[d], e)])
        if r == 'writes':
            coo = np.concatenate(
                [coo, [[NODES[s]] * 3, [NODES[d]] * 3]], 1)
        ei[(s, r, d)] = coo.astype(np.int32)
        if s != d:
            rev = coo[::-1].copy()
            if r == 'writes':
                rev[:, -3:] = [[NODES[d]], [NODES[s]]]
            ei[(d, f'rev_{r}', s)] = rev
    x = {t: rng.standard_normal((n, f)).astype(np.float32)
         for t, n in NODES.items()}
    return x, ei, (tuple(NODES), tuple(ei))


def _check_grads(module, jgrads):
    ref = flax_to_state_dict(jgrads)
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(ref)
    for k, p in named.items():
        if p.grad is None:          # unused (a skip gate of another width)
            np.testing.assert_array_equal(ref[k].numpy(), 0, err_msg=k)
        else:
            _close(p.grad, ref[k], f'grad of {k}')


def _pair(jm, tm, x, jei, tei, seed=3, **kw):
    """Outputs and gradients of both modules under ``sum_t sum(out[t] *
    c[t])``; ``kw`` goes to both (numpy for JAX, torch for the port)."""
    jkw = {k: v[0] for k, v in kw.items()}
    tkw = {k: v[1] for k, v in kw.items()}
    params = jm.init(jax.random.PRNGKey(seed), x, jei, **jkw)
    tm.load_state_dict(flax_to_state_dict(params))
    jout = jm.apply(params, x, jei, **jkw)
    cs = {t: np.random.default_rng(i).standard_normal(v.shape).astype(
        np.float32) for i, (t, v) in enumerate(sorted(jout.items()))
        if v is not None}

    def loss(p, x):
        out = jm.apply(p, x, jei, **jkw)
        return sum((out[t] * c).sum() for t, c in cs.items())

    jgp, jgx = jax.grad(loss, (0, 1))(params, x)
    tx = {t: torch.from_numpy(v.copy()).requires_grad_()
          for t, v in x.items()}
    tout = tm(tx, tei, **tkw)
    assert sorted(tout) == sorted(jout)
    sum((tout[t] * torch.from_numpy(c)).sum() for t, c in cs.items()
        ).backward()
    for t, v in jout.items():
        if v is None:
            assert tout[t] is None
        else:
            _close(tout[t], v, f'out {t}')
    _check_grads(tm, jgp)
    for t in x:
        if tx[t].grad is None:
            np.testing.assert_array_equal(np.asarray(jgx[t]), 0)
        else:
            _close(tx[t].grad, jgx[t], f'grad x {t}')


def _edge_indexes(ei, blocked):
    """Both packages' relations as edge indexes (rectangular where the
    types differ), with the slot orders when ``blocked``."""
    j, t = {}, {}
    for et, coo in ei.items():
        size = (NODES[et[0]], NODES[et[2]])
        j[et] = JEdgeIndex(coo, size)
        t[et] = EdgeIndex(coo, size, device='cpu')
        if blocked:
            j[et] = j[et].fill_cache(blocked=True)
            t[et] = t[et].fill_cache(blocked=True)
    return j, t


@pytest.mark.parametrize('route', ['fused_wide', 'fused_flash', 'blocked',
                                   'concat'])
def test_hgt_conv(monkeypatch, route):
    if route == 'fused_flash':
        monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', '0')
        monkeypatch.setenv('PGT_ATTN_CHUNK_EDGES', '16')
    x, ei, meta = _graph(1)
    path = 'fused' if route.startswith('fused') else route
    jei, tei = _edge_indexes(ei, route == 'blocked')
    jm = JHGT(out_channels=16, metadata=meta, heads=2, attn_path=path)
    tm = HGTConv(16, 16, meta, heads=2, attn_path=path, device='cpu')
    _pair(jm, tm, x, jei, tei)


def test_hgt_conv_auto_route(monkeypatch):
    """The auto rule: 'blocked' when every relation carries slot orders
    (the same bits as asking for it), 'fused' when one does not, and
    'fused' for a type with a flash layout."""
    sddmm = sys.modules['pytorch_geometric_tpu_torch.ops.sddmm']
    ea = sys.modules['pytorch_geometric_tpu_torch.ops.edge_attention']
    calls = []
    for mod, name in ((sddmm, 'multi_relation_softmax_aggregate'),
                      (ea, 'hetero_edge_attention_multi')):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    x, ei, meta = _graph(4)
    tx = {t: torch.from_numpy(v) for t, v in x.items()}
    _, blocked = _edge_indexes(ei, True)
    auto = HGTConv(16, 16, meta, heads=2, device='cpu')
    explicit = HGTConv(16, 16, meta, heads=2, attn_path='blocked',
                       device='cpu')
    explicit.load_state_dict(auto.state_dict())
    got, ref = auto(tx, blocked), explicit(tx, blocked)
    for t in ref:
        torch.testing.assert_close(got[t], ref[t], rtol=0, atol=0)
    assert calls == ['multi_relation_softmax_aggregate'] * 2 * len(NODES)
    calls.clear()
    mixed = dict(blocked)
    mixed[meta[1][0]] = torch.from_numpy(ei[meta[1][0]])
    auto(tx, mixed)
    assert calls.count('hetero_edge_attention_multi') == 1   # 'paper'
    calls.clear()
    tl = build_hgt_flash_layouts(meta, ei, NODES, device='cpu')
    auto(tx, blocked, {'field': tl['field']})
    assert calls.count('hetero_edge_attention_multi') == 1   # 'field'


def test_hgt_conv_layouts_and_mixed_widths(monkeypatch):
    """``flash_layouts`` (every type on the flash route over presorted
    edges, the source-sorted backward), input widths that differ by type,
    so the skip gate applies to none (out 12, inputs 16 / 8)."""
    x, ei, meta = _graph(2)
    x['author'] = x['author'][:, :8].copy()
    jl = j_layouts(meta, ei, NODES, chunk=16)
    tl = build_hgt_flash_layouts(meta, ei, NODES, chunk=16, device='cpu')
    jm = JHGT(out_channels=12, metadata=meta, heads=2)
    widths = {t: v.shape[1] for t, v in x.items()}
    tm = HGTConv(widths, 12, meta, heads=2, device='cpu')
    tei = {k: torch.from_numpy(v) for k, v in ei.items()}
    _pair(jm, tm, x, ei, tei, flash_layouts=(jl, tl))
    # a stale layout (another relation set) is refused
    part = {k: v for k, v in tei.items() if k[1] != 'cites'}
    with pytest.raises(ValueError, match='stale'):
        tm({t: torch.from_numpy(v) for t, v in x.items()}, part, tl)


@pytest.mark.parametrize('route', ['plain', 'flash'])
def test_han_conv(monkeypatch, route):
    if route == 'flash':
        monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', '0')
        monkeypatch.setenv('PGT_ATTN_CHUNK_EDGES', '16')
    x, ei, meta = _graph(3)
    # 'institution' is reached by one metapath, 'paper' by two; without
    # 'has_topic', 'field' by none (None)
    ei = {k: v for k, v in ei.items() if k[1] != 'has_topic'}
    meta = (meta[0], tuple(ei))
    jm = JHAN(out_channels=16, metadata=meta, heads=2)
    tm = HANConv(16, 16, meta, heads=2, device='cpu')
    _pair(jm, tm, x, ei, {k: torch.from_numpy(v) for k, v in ei.items()})
