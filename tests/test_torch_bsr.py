"""The PyTorch port's block-sparse (BSR) cache and ``'bsr'`` SpMM arm against
the JAX package's, on the same numpy inputs. The JAX side runs its BSR
Pallas kernel in interpret mode on the CPU, as ``tests/test_bsr_spmm.py``
does; the port runs the kernel's plain version.

Layouts: integer layouts and the residual must be equal, block values equal
(both sum duplicate edges in float64, in edge order, then round to float32).
The JAX layout splices one zero block into each empty dst block row; the
port's row pointer makes that unnecessary, so those blocks are dropped
before comparing.

Tolerances: forwards 1e-5 of the reference's largest magnitude, gradients
1e-4 (float32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.ops import spmm as jspmm
from pytorch_geometric_tpu.ops import bsr_spmm as jbsr
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.ops import bsr_spmm as tbsr
from pytorch_geometric_tpu_torch.ops import spmm, spmm_regime

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _clustered(n, e, seed, n_tail=300):
    """Edges inside 128-node communities plus a scattered tail that stays
    on the gather path."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, n // 128 + 1, e)
    src = np.clip(c * 128 + rng.integers(0, 128, e), 0, n - 1)
    dst = np.clip(c * 128 + rng.integers(0, 128, e), 0, n - 1)
    tail = rng.integers(0, n, (2, n_tail))
    return np.concatenate([np.stack([src, dst]), tail], 1).astype(np.int32)


def _powerlaw(n, e, seed, n_pad=0):
    """Scrambled power-law graph: the natural order scatters its hubs, so
    fill_cache bakes a hubs-first relabel; ``n_pad`` padded edges."""
    rng = np.random.default_rng(seed)
    pw = np.arange(1, n + 1) ** -0.9
    pw /= pw.sum()
    sc = rng.permutation(n)
    coo = np.stack([sc[rng.choice(n, e, p=pw)], sc[rng.choice(n, e, p=pw)]])
    pad = np.full((2, n_pad), n)
    return np.concatenate([coo, pad], 1).astype(np.int32)


def _rect(n_src, n_dst, e, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n_src, e),
                     rng.integers(0, n_dst, e)]).astype(np.int32)


# name -> (coo, (n_src, n_dst)); the rectangular graph's first dst block
# row is empty
GRAPHS = {
    'clustered': lambda: (_clustered(600, 6000, seed=0), (600, 600)),
    'powerlaw-relabel-padded': lambda: (_powerlaw(3000, 6000, seed=1,
                                                  n_pad=40), (3000, 3000)),
    'rectangular': lambda: (_rect(300, 450, 4000, seed=2), (300, 450)),
}


def _case(name, f=12):
    coo, size = GRAPHS[name]()
    if name == 'rectangular':
        coo = coo[:, coo[1] >= 128]
    rng = np.random.default_rng(len(name))
    w = rng.random(coo.shape[1]).astype(np.float32)
    return coo, size, w, rng


def _both(coo, size, w):
    j = JEdgeIndex(coo, size).fill_cache(dense_weight=w, block_sparse=True)
    t = EdgeIndex(coo, size, device='cpu').fill_cache(dense_weight=w,
                                                      block_sparse=True)
    return j, t


def _same_blocks(t, j):
    """Port layout == JAX layout without its spliced zero blocks."""
    j_rows = np.asarray(j.rows)
    t_rows = tbsr.block_rows(t).numpy()
    keep = np.isin(j_rows, t_rows)
    np.testing.assert_array_equal(t_rows, j_rows[keep])
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols)[keep])
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals)[keep])
    # each nonempty row starts where the JAX layout flags its first block
    starts = t.row_ptr.numpy()[np.unique(t_rows)]
    np.testing.assert_array_equal(
        starts, np.flatnonzero(np.asarray(j.first)[keep]))
    # the rows the JAX layout padded with a zero block are the empty ones
    np.testing.assert_array_equal(np.asarray(j.vals)[~keep], 0.0)
    empty = np.flatnonzero(np.diff(t.row_ptr.numpy()) == 0)
    np.testing.assert_array_equal(np.sort(j_rows[~keep]), empty)


@pytest.mark.parametrize('name', sorted(GRAPHS))
def test_fill_cache_layout_matches_jax(name):
    coo, size, w, _ = _case(name)
    j, t = _both(coo, size, w)
    assert t.bsr is not None and t.weight is None
    _same_blocks(t.bsr, j.bsr)
    _same_blocks(t.bsr_t, j.bsr_t)
    if name == 'powerlaw-relabel-padded':
        assert j.bsr_perm is not None
        np.testing.assert_array_equal(t.bsr_perm.numpy(),
                                      np.asarray(j.bsr_perm))
        np.testing.assert_array_equal(t.bsr_inv.numpy(),
                                      np.asarray(j.bsr_inv))
    else:
        assert j.bsr_perm is None and t.bsr_perm is None
    if j.bsr_res is None:
        assert t.bsr_res is None
    else:
        r_src, r_dst, r_w = (np.asarray(a) for a in j.bsr_res)
        np.testing.assert_array_equal(t.bsr_res.coo.numpy(),
                                      np.stack([r_src, r_dst]))
        np.testing.assert_array_equal(t.bsr_res.weight.numpy(), r_w)
    assert name != 'clustered' or t.bsr_res is not None


def test_build_bsr_pair_matches_jax():
    """The pair and residual straight from ``build_bsr_pair``, on a
    rectangular graph with padded edges and a block-fill split."""
    coo = np.concatenate([_rect(300, 700, 5000, seed=3),
                          np.stack([np.full(9, 300), np.full(9, 700)])],
                         1).astype(np.int32)
    w = np.random.default_rng(3).random(coo.shape[1]).astype(np.float32)
    jf, jb, jres = jbsr.build_bsr_pair(coo, w, 300, 700)
    tf, tb, tres = tbsr.build_bsr_pair(coo, w, 300, 700)
    _same_blocks(tf, jf)
    _same_blocks(tb, jb)
    assert (jres is None) == (tres is None)
    if jres is not None:
        for a, b in zip(tres, jres):
            np.testing.assert_array_equal(a, np.asarray(b))


def _gate_graphs():
    rng = np.random.default_rng(4)
    base = rng.integers(0, 4, 8000) * 128
    clustered = np.stack([base + rng.integers(0, 128, 8000),
                          base + rng.integers(0, 128, 8000)])
    scattered = np.stack([rng.integers(0, 20_000, 3000),
                          rng.integers(0, 20_000, 3000)])
    big_clustered = np.concatenate(
        [clustered, rng.integers(0, 20_000, (2, 200))], 1)
    return {'clustered': (clustered.astype(np.int32), 512),
            'scattered': (scattered.astype(np.int32), 20_000),
            'big-clustered': (big_clustered.astype(np.int32), 20_000),
            'powerlaw': (_powerlaw(4000, 8000, seed=5), 4000)}


@pytest.mark.parametrize('name', ['clustered', 'scattered', 'big-clustered',
                                  'powerlaw'])
def test_profitability_gate_matches_jax(name):
    coo, n = _gate_graphs()[name]
    assert (tbsr.bsr_stats(coo, n, n)
            == jbsr.bsr_stats(coo, n, n))
    t_perm, t_inv, t_cap, t_mask = tbsr.choose_block_order(coo, n, n)
    j_perm, j_inv, j_cap, j_mask = jbsr.choose_block_order(coo, n, n)
    assert (t_perm is None) == (j_perm is None) and t_cap == j_cap
    np.testing.assert_array_equal(t_mask, j_mask)
    coo_b = coo if t_perm is None else t_inv[coo]
    decision = tbsr.bsr_profitable(coo_b, n, n, capture=t_cap, in_blk=t_mask)
    assert decision == jbsr.bsr_profitable(coo_b, n, n, capture=j_cap,
                                           in_blk=j_mask)
    assert tbsr.bsr_profitable(coo, n, n) == jbsr.bsr_profitable(coo, n, n)
    assert decision == (name != 'scattered')
    # the memory cap declines what the capture alone would take
    assert not tbsr.bsr_profitable(coo_b, n, n, max_entries=128 * 128 - 1)
    if n * n > 2.5e8:
        # no block_sparse: past the dense cap fill_cache bakes blocks only
        # where they pay, and carries the weights otherwise
        w = np.ones(coo.shape[1], np.float32)
        t = EdgeIndex(coo, (n, n), device='cpu').fill_cache(dense_weight=w)
        j = JEdgeIndex(coo, (n, n)).fill_cache(dense_weight=w)
        assert (t.bsr is not None) == (j.bsr is not None) == decision
        assert (t.weight is None) == decision


@pytest.mark.parametrize('op', ['sum', 'mean', 'flip', 'grad'])
@pytest.mark.parametrize('name', sorted(GRAPHS))
def test_spmm_bsr_matches_jax(name, op):
    coo, size, w, rng = _case(name)
    n_src, n_dst = size
    j, t = _both(coo, size, w)
    assert spmm_regime(t) == 'bsr'
    n_in = n_dst if op == 'flip' else n_src
    x = rng.standard_normal((n_in, 12)).astype(np.float32)
    if op == 'grad':
        c = rng.standard_normal((n_dst, 12)).astype(np.float32)
        ref = np.asarray(jax.grad(lambda xx: (jspmm(j, xx) * c).sum())(
            jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_()
        (spmm(t, xt) * torch.from_numpy(c)).sum().backward()
        got, tol = xt.grad.numpy(), GRAD_TOL
    else:
        kw = dict(reduce='mean') if op == 'mean' else {}
        jadj, tadj = (j.flip(), t.flip()) if op == 'flip' else (j, t)
        ref = np.asarray(jspmm(jadj, jnp.asarray(x), **kw))
        got, tol = spmm(tadj, torch.from_numpy(x), **kw).numpy(), FWD_TOL
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize('f', [1, 10, 16])
def test_bsr_spmm_plain_matches_pallas(f):
    """One pass of the plain version against ``_bsr_matmul_impl`` (the
    Pallas kernel, interpreted) on the same blocks, both layouts."""
    coo, size, w, rng = _case('clustered')
    n = size[0]
    jf, jb, _ = jbsr.build_bsr_pair(coo, w, n, n)
    tf, tb, _ = tbsr.build_bsr_pair(coo, w, n, n)
    x = rng.standard_normal((n, f)).astype(np.float32)
    for tl, jl in ((tf, jf), (tb, jb)):
        ref = np.asarray(jbsr._bsr_matmul_impl(jl, jnp.asarray(x), n, True))
        got = tbsr.bsr_matmul(tl, torch.from_numpy(x), n).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=FWD_TOL * np.abs(ref).max())


def test_bsr_wrapper_checks_its_inputs():
    coo, size, w, _ = _case('clustered')
    t = EdgeIndex(coo, size, device='cpu').fill_cache(dense_weight=w,
                                                      block_sparse=True)
    x = torch.ones(size[0], 4)
    with pytest.raises(TypeError, match='float32'):
        tbsr.bsr_matmul(t.bsr, x.double(), size[1])
    with pytest.raises(ValueError, match='row_ptr'):
        tbsr.bsr_matmul(t.bsr, x, size[1] + 128)
    with pytest.raises(ValueError, match='contiguous 2-D'):
        tbsr.bsr_matmul(t.bsr, x.t(), size[1])
    meta = tbsr.BSR(*(a.to('meta') for a in t.bsr))
    with pytest.raises(ValueError, match='cpu or cuda'):
        tbsr.bsr_matmul(meta, x.to('meta'), size[1])


def test_cache_gcn_norm_block_sparse_matches_carried(monkeypatch):
    """``cache_gcn_norm(block_sparse=True)`` bakes the same normalised
    adjacency that the carried-weight cache (past the dense cap, blocks
    declined) applies edge by edge."""
    from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import cache_gcn_norm
    coo, size, _, rng = _case('clustered')
    ei = EdgeIndex(coo, size, device='cpu')
    baked = cache_gcn_norm(ei, block_sparse=True)
    monkeypatch.setenv('PGT_DENSE_SPMM_ENTRIES', '0')
    carried = cache_gcn_norm(ei, block_sparse=False)
    assert baked.bsr is not None and baked.weight is None
    assert carried.bsr is None and carried.weight is not None
    x = torch.from_numpy(rng.standard_normal((size[0], 8)).astype(
        np.float32))
    ref = spmm(carried, x)
    torch.testing.assert_close(spmm(baked, x), ref, rtol=0,
                               atol=FWD_TOL * float(ref.abs().max()))
