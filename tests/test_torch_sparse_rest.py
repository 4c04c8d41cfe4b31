"""The rest of the port's sparse runtime against the JAX package, on the CPU,
from the same numpy inputs: ``scatter``'s ``mul`` and ``any``,
``scatter_argmax``, ``group_argsort``, ``segment`` and
``segment_logsumexp`` (``ops/scatter.py``, ``ops/segment.py``), the
``sampled_*`` ops (``ops/sampled.py``), ``EdgeIndex.sort_by``,
``to_dense_adj`` and ``from_numpy_coo``, and ``utils/reorder.py``'s
``reverse_cuthill_mckee``, ``apply_node_permutation`` and
``block_fill_stats``.

Integer results and permutations are equal bit for bit; float results within
1e-6 relative (sums in other orders), products within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.edge_index import from_numpy_coo as jfrom_numpy
from pytorch_geometric_tpu.ops import (group_argsort as jgroup_argsort,
                                       scatter as jscatter,
                                       scatter_argmax as jscatter_argmax,
                                       segment as jsegment,
                                       segment_logsumexp as jsegment_lse)
from pytorch_geometric_tpu.ops.sampled import sampled_op as jsampled_op
from pytorch_geometric_tpu.utils.reorder import (
    apply_node_permutation as japply_perm,
    block_fill_stats as jblock_fill_stats,
    reverse_cuthill_mckee as jrcm)
from pytorch_geometric_tpu_torch import EdgeIndex, from_numpy_coo
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.ops import (group_argsort, sampled_add,
                                             sampled_div, sampled_mul,
                                             sampled_op, sampled_sub,
                                             scatter, scatter_argmax,
                                             segment, segment_logsumexp)
from pytorch_geometric_tpu_torch.utils import (apply_node_permutation,
                                               block_fill_stats,
                                               reverse_cuthill_mckee)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _index(rng, e, n, empty=(3,)):
    """Segment ids in ``[0, n)`` with the ``empty`` segments left out."""
    idx = rng.integers(0, n, e)
    for k in empty:
        idx[idx == k] = (k + 1) % n
    return idx.astype(np.int32)


@pytest.mark.parametrize('width', [None, 5])
def test_scatter_mul_matches_jax(width):
    """``mul``: the product of each segment, 1 where empty."""
    rng = np.random.default_rng(0)
    shape = (60,) if width is None else (60, width)
    src = (rng.random(shape) + 0.5).astype(np.float32)
    idx = _index(rng, 60, 9)
    ref = np.asarray(jscatter(jnp.asarray(src), jnp.asarray(idx), 9,
                              reduce='mul'))
    got = scatter(_t(src), _t(idx), 9, reduce='mul').numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert np.all(got[3] == 1)


@pytest.mark.parametrize('dtype', [np.bool_, np.int32])
def test_scatter_any_matches_jax_on_nonempty_segments(dtype):
    """``any``: the JAX package's int32 segment max in ``src``'s dtype
    (for bool: whether any element is true), bit for bit on every segment
    that has elements; an empty segment is 0 in the port, where the JAX
    package gives its int32 identity (ROADMAP Queue 3)."""
    rng = np.random.default_rng(1)
    src = (rng.random(80) < 0.2) if dtype is np.bool_ else rng.integers(
        0, 4, 80).astype(np.int32)
    idx = _index(rng, 80, 11)
    ref = np.asarray(jscatter(jnp.asarray(src), jnp.asarray(idx), 11,
                              reduce='any'))
    got = scatter(_t(src), _t(idx), 11, reduce='any').numpy()
    nonempty = np.bincount(idx, minlength=11) > 0
    np.testing.assert_array_equal(got[nonempty], ref[nonempty])
    assert not got[~nonempty].any()
    assert got.dtype == np.dtype(dtype)


@pytest.mark.parametrize('ties', [False, True])
def test_scatter_argmax_matches_jax(ties):
    """The first position attaining each segment's max, the int32 identity
    for an empty segment, and out-of-range ids dropped, bit for bit."""
    rng = np.random.default_rng(2)
    src = (rng.integers(0, 3, 70) if ties else rng.standard_normal(70)
           ).astype(np.float32)
    idx = _index(rng, 70, 10)
    idx[:4] = 10            # out of range: dropped
    ref = np.asarray(jscatter_argmax(jnp.asarray(src), jnp.asarray(idx), 10))
    got = scatter_argmax(_t(src), _t(idx), 10).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('descending', [False, True])
@pytest.mark.parametrize('ties', [False, True])
def test_group_argsort_matches_jax(descending, ties):
    rng = np.random.default_rng(3)
    src = (rng.integers(0, 4, 90) if ties else rng.standard_normal(90)
           ).astype(np.float32)
    idx = _index(rng, 90, 12)
    ref = np.asarray(jgroup_argsort(jnp.asarray(src), jnp.asarray(idx), 12,
                                    descending=descending))
    got = group_argsort(_t(src), _t(idx), 12, descending=descending).numpy()
    np.testing.assert_array_equal(got, ref)


def _ptr(rng, e, n):
    """A row pointer over ``e`` elements into ``n`` runs, some empty."""
    cuts = np.sort(rng.integers(0, e + 1, n - 1))
    return np.concatenate([[0], cuts, [e]]).astype(np.int32)


@pytest.mark.parametrize('reduce', ['sum', 'mean', 'min', 'max', 'mul'])
def test_segment_matches_jax(reduce):
    rng = np.random.default_rng(4)
    src = (rng.standard_normal((50, 3)) + (2 if reduce == 'mul' else 0)
           ).astype(np.float32)
    ptr = _ptr(rng, 50, 14)
    ref = np.asarray(jsegment(jnp.asarray(src), jnp.asarray(ptr), 14,
                              reduce=reduce))
    got = segment(_t(src), _t(ptr), 14, reduce=reduce).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('width', [None, 4])
def test_segment_logsumexp_matches_jax(width):
    """The shifted log-sum-exp of each run; ``-inf`` for an empty run in
    both (the JAX package's 1e-38 floor flushes to zero in float32)."""
    rng = np.random.default_rng(5)
    shape = (40,) if width is None else (40, width)
    src = (3 * rng.standard_normal(shape)).astype(np.float32)
    ptr = _ptr(rng, 40, 12)
    ptr[3] = ptr[2]             # an empty run
    ref = np.asarray(jsegment_lse(jnp.asarray(src), jnp.asarray(ptr), 11))
    got = segment_logsumexp(_t(src), _t(ptr), 11).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert np.isneginf(got[2]).all() and np.isneginf(ref[2]).all()


@pytest.mark.parametrize('op', ['add', 'sub', 'mul', 'div'])
@pytest.mark.parametrize('indexed', ['both', 'left', 'none'])
def test_sampled_ops_match_jax(op, indexed):
    """``left[li] (op) right[ri]``; an out-of-range index row is the op's
    identity."""
    rng = np.random.default_rng(6)
    left = (rng.random((20, 3)) + 0.5).astype(np.float32)
    right = (rng.random((30, 3)) + 0.5).astype(np.float32)
    li = rng.integers(0, 21, 30).astype(np.int32)      # 20: out of range
    ri = rng.integers(0, 31, 30).astype(np.int32)
    if indexed == 'left':
        right, ri = right[:30], None
    if indexed == 'none':
        left, li, ri = left[:20], None, None
        right = right[:20]
    ref = np.asarray(jsampled_op(
        jnp.asarray(left), jnp.asarray(right),
        None if li is None else jnp.asarray(li),
        None if ri is None else jnp.asarray(ri), op=op))
    args = (_t(left), _t(right), None if li is None else _t(li),
            None if ri is None else _t(ri))
    got = sampled_op(*args, op=op).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    named = {'add': sampled_add, 'sub': sampled_sub, 'mul': sampled_mul,
             'div': sampled_div}[op]
    np.testing.assert_array_equal(named(*args).numpy(), got)
    with pytest.raises(ValueError, match='unknown op'):
        sampled_op(*args, op='pow')


def _coo(rng, n, e, n_pad=4):
    coo = rng.integers(0, n, (2, e))
    pad = np.full((2, n_pad), n)
    return np.concatenate([coo, pad], 1).astype(np.int32)


@pytest.mark.parametrize('order', ['row', 'col'])
def test_sort_by_matches_jax(order):
    rng = np.random.default_rng(7)
    coo = _coo(rng, 30, 200)
    got, perm = EdgeIndex(coo, (30, 30), device='cpu').sort_by(order)
    ref, jperm = JEdgeIndex(coo, (30, 30)).sort_by(order)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(got.coo.numpy(), np.asarray(ref.coo))
    assert got.sparse_size == (30, 30) and got.csc is None


@pytest.mark.parametrize('weighted', [False, True])
def test_to_dense_adj_matches_jax(weighted):
    """``[n_src, n_dst]``, duplicate edges summed, padded edges dropped;
    rectangular too."""
    rng = np.random.default_rng(8)
    coo = np.stack([rng.integers(0, 12, 90), rng.integers(0, 17, 90)])
    coo = np.concatenate([coo, [[12, 12], [17, 17]]], 1).astype(np.int32)
    w = rng.random(92).astype(np.float32) if weighted else None
    got = EdgeIndex(coo, (12, 17), device='cpu').to_dense_adj(
        None if w is None else _t(w)).numpy()
    ref = np.asarray(JEdgeIndex(coo, (12, 17)).to_dense_adj(
        None if w is None else jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got.shape == (12, 17)


def test_from_numpy_coo_matches_jax():
    rng = np.random.default_rng(9)
    row, col = rng.integers(0, 25, 60), rng.integers(0, 25, 60)
    got = from_numpy_coo(row, col, 25, device='cpu')
    ref = jfrom_numpy(row, col, 25)
    assert got.coo.dtype == torch.int32 and got.sparse_size == (25, 25)
    np.testing.assert_array_equal(got.coo.numpy(), np.asarray(ref.coo))


@pytest.mark.parametrize('n,e', [(200, 600), (150, 100), (64, 2000)])
def test_reverse_cuthill_mckee_matches_jax(n, e):
    """The same permutation, bit for bit: several components, isolated
    nodes, self loops and padded endpoints."""
    rng = np.random.default_rng(n)
    coo = _coo(rng, n, e)
    coo[:, :5] = np.arange(5)             # self loops
    got = reverse_cuthill_mckee(coo, n)
    np.testing.assert_array_equal(got, jrcm(coo, n))
    assert np.array_equal(np.sort(got), np.arange(n))


def test_apply_node_permutation_matches_jax():
    """Every node-dim value permuted, edge endpoints relabelled (padded
    ones kept), edge values untouched, ``inv`` returned."""
    rng = np.random.default_rng(11)
    n, e = 40, 40               # num_edges == num_nodes: edge_* not moved
    coo = _coo(rng, n, e - 4)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    y = rng.integers(0, 5, n).astype(np.int32)
    ea = rng.standard_normal((e, 2)).astype(np.float32)
    perm = rng.permutation(n)
    got, inv = apply_node_permutation(
        Data(x=_t(x), y=_t(y), edge_index=_t(coo), edge_attr=_t(ea)), perm)
    ref, jinv = japply_perm(JData(x=jnp.asarray(x), y=jnp.asarray(y),
                                  edge_index=jnp.asarray(coo),
                                  edge_attr=jnp.asarray(ea)), perm)
    np.testing.assert_array_equal(inv, jinv)
    for key in ('x', 'y', 'edge_index', 'edge_attr'):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(ref[key]), err_msg=key)
    assert isinstance(got.edge_index, torch.Tensor)


@pytest.mark.parametrize('block', [8, 128])
def test_block_fill_stats_matches_jax(block):
    rng = np.random.default_rng(12)
    n = 300
    base = np.repeat(np.arange(0, n - 30, 30), 40)
    coo = np.concatenate([
        np.stack([base + rng.integers(0, 30, base.size),
                  base + rng.integers(0, 30, base.size)]),
        _coo(rng, n, 200)], 1).astype(np.int32)
    assert block_fill_stats(coo, n, block) == jblock_fill_stats(coo, n,
                                                                block)
    assert block_fill_stats(np.zeros((2, 0), np.int32), n) == (0.0, 0.0, 0)
