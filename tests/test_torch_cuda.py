"""The hand-written CUDA kernels of the PyTorch port against their plain
PyTorch versions, on the card: the segment-sum kernel forward and backward,
the block-sparse (BSR) kernel on both layouts (rows longer than its ring,
one-block and empty rows, unaligned x views, two launches bitwise equal,
refused launches), training steps through both against the CPU, the
multi-head GAT mix kernel forward and backward, the segment-max kernel
(bitwise), the fused GATConv / GAT model on the card against the CPU, and
the precision ladder: the bf16 arms of the BSR, segment-sum and mix
kernels, the dense float32 / bf16 / int8 caches, and bf16 calls that raise
instead of falling back. Every test here needs a CUDA card, carries the
``cuda`` marker and skips without one; the card's machine has no JAX, so
this file imports none (run it there with ``--noconftest``, see the
README).

Tolerance: f32 sums in another order: 1e-5 plus 1e-5 of the row's sum of
|w * x| terms per kernel pass (the bf16 BSR arm too: its products are exact
in float32; the float32 BSR arm's 3xTF32 split keeps about 22 bits of each
product, well inside it); a bf16 output adds one bf16 ulp of the
reference, for a sum on a rounding boundary; 1e-4 of the largest magnitude
for gradients and training losses."""

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu_torch import EdgeIndex, backend
from pytorch_geometric_tpu_torch.nn.conv import GATConv, GATv2Conv
from pytorch_geometric_tpu_torch.nn.models import GAT, GCN, GIN, GraphSAGE
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import cache_gcn_norm
from pytorch_geometric_tpu_torch.ops import (segment_spmm,
                                             segment_spmm_plain, spmm,
                                             spmm_regime)
import pytorch_geometric_tpu_torch.ops.bsr_spmm as bsr_spmm_module
from pytorch_geometric_tpu_torch.ops.bsr_spmm import (MAX_STAGES,
                                                      SMEM_BYTES, BSR,
                                                      bsr_matmul, bsr_plan,
                                                      bsr_spmm_plain,
                                                      build_bsr_pair)
from pytorch_geometric_tpu_torch.ops.dense_spmm import dense_spmm
from pytorch_geometric_tpu_torch.ops.gat_fused import (gat_aggregate,
                                                       gat_mix,
                                                       gat_mix_plain)
from pytorch_geometric_tpu_torch.ops.segment_max import (
    segment_max_blocked, segment_max_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _case(n_src, n_dst, e, f, seed, n_pad=8):
    rng = np.random.default_rng(seed)
    rows = rng.choice(n_dst, max(1, n_dst // 2), replace=False)  # empties
    coo = np.stack([np.concatenate([rng.integers(0, n_src, e),
                                    np.full(n_pad, n_src)]),
                    np.concatenate([rows[rng.integers(0, len(rows), e)],
                                    np.full(n_pad, n_dst)])]).astype(
        np.int32)
    w = rng.random(e + n_pad).astype(np.float32)
    x = rng.standard_normal((n_src, f)).astype(np.float32)
    return coo, w, x


def _close(out, ref, scale):
    err = (out - ref).abs()
    assert bool((err <= 1e-5 + 1e-5 * scale).all()), float(err.max())


@pytest.mark.parametrize('f', [1, 10, 16, 24, 128, 130])
@pytest.mark.parametrize('weighted', [True, False])
@pytest.mark.parametrize('n_src,n_dst', [(500, 500), (300, 800)])
def test_kernel_matches_plain(dev, f, weighted, n_src, n_dst):
    coo, w, x = _case(n_src, n_dst, 6000, f, seed=f + n_dst)
    csc = EdgeIndex(coo, (n_src, n_dst), device=dev).fill_cache().csc
    wt = torch.as_tensor(w, device=dev)[csc.perm].contiguous() \
        if weighted else None
    xt = torch.as_tensor(x, device=dev)
    before = segment_spmm.launches
    out = segment_spmm(csc.indptr, csc.indices, wt, xt)
    torch.cuda.synchronize()
    assert segment_spmm.launches == before + 1
    ref = segment_spmm_plain(csc.indptr, csc.indices, wt, xt)
    scale = segment_spmm_plain(csc.indptr, csc.indices,
                               None if wt is None else wt.abs(), xt.abs())
    _close(out, ref, scale)


def test_kernel_unaligned_view_and_empty_graph(dev):
    coo, w, x = _case(200, 200, 1500, 16, seed=3)
    csc = EdgeIndex(coo, (200, 200), device=dev).fill_cache().csc
    base = torch.as_tensor(x, device=dev).flatten()
    # a contiguous x whose data pointer is 4 bytes past a 16-byte boundary:
    # F is a multiple of 4, but the kernel must take its scalar loads
    xt = torch.cat([base.new_zeros(1), base])[1:].view(200, 16)
    assert xt.is_contiguous() and xt.data_ptr() % 16 != 0
    out = segment_spmm(csc.indptr, csc.indices, None, xt)
    ref = segment_spmm_plain(csc.indptr, csc.indices, None, xt)
    _close(out, ref, segment_spmm_plain(csc.indptr, csc.indices, None,
                                        xt.abs()))
    empty = EdgeIndex(np.zeros((2, 0), np.int32), (5, 7),
                      device=dev).fill_cache().csc
    out = segment_spmm(empty.indptr, empty.indices, None,
                       torch.ones(5, 4, device=dev))
    torch.cuda.synchronize()
    assert out.shape == (7, 4) and not out.any()


def test_kernel_refuses_what_it_does_not_take(dev):
    coo, w, x = _case(100, 100, 500, 8, seed=4)
    csc = EdgeIndex(coo, (100, 100), device=dev).fill_cache().csc
    xt = torch.as_tensor(x, device=dev)
    with pytest.raises(TypeError, match='float32'):
        segment_spmm(csc.indptr, csc.indices, None, xt.half())
    with pytest.raises(ValueError, match='is on cpu'):
        segment_spmm(csc.indptr.cpu(), csc.indices, None, xt)
    # a gradient of x needs the matrix in source-major order as well
    with pytest.raises(ValueError, match='transpose'):
        segment_spmm(csc.indptr, csc.indices, None,
                     xt.clone().requires_grad_())


@pytest.mark.parametrize('reduce', ['sum', 'mean', 'max'])
def test_spmm_on_card_matches_cpu(dev, reduce):
    coo, w, x = _case(400, 400, 5000, 32, seed=5)
    ei = EdgeIndex(coo, (400, 400), device=dev).fill_cache()
    assert spmm_regime(ei, reduce=reduce) == (
        'plain' if reduce == 'max' else 'kernel')
    before = segment_spmm.launches
    out = spmm(ei, torch.as_tensor(x, device=dev),
               torch.as_tensor(w, device=dev), reduce=reduce)
    assert segment_spmm.launches == before + (reduce != 'max')
    ref = spmm(EdgeIndex(coo, (400, 400), device='cpu').fill_cache(),
               torch.from_numpy(x), torch.from_numpy(w), reduce=reduce)
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('cls', [GCN, GraphSAGE, GIN])
def test_model_on_card_matches_cpu(dev, cls):
    coo, w, x = _case(600, 600, 8000, 32, seed=6, n_pad=0)
    # GCN as served: weights normalised ahead, carried by the caller
    ckw = {'conv_kwargs': {'normalize': False}} if cls is GCN else {}
    models = [cls(32, 32, 3, 8, **ckw, device=d,
                  generator=torch.Generator().manual_seed(0)).eval()
              for d in (dev, 'cpu')]
    outs = []
    for model, d in zip(models, (dev, 'cpu')):
        ei = EdgeIndex(coo, (600, 600), device=d).fill_cache()
        kw = ({'edge_weight': torch.as_tensor(w, device=d)}
              if cls is GCN else {})
        before = segment_spmm.launches
        with torch.inference_mode():
            outs.append(model(torch.as_tensor(x, device=d), ei, **kw).cpu())
        launched = segment_spmm.launches - before
        assert launched == (3 if d == dev else 0)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


def test_plain_knob_runs_no_kernel(dev, monkeypatch):
    # with the knob off a CUDA sum/mean raises: the plain version never
    # stands in for the kernel on the card
    coo, w, x = _case(100, 100, 600, 16, seed=7)
    ei = EdgeIndex(coo, (100, 100), device=dev).fill_cache()
    xt = torch.as_tensor(x, device=dev)
    monkeypatch.setattr(backend, 'use_kernel_spmm', False)
    before = segment_spmm.launches
    for reduce in ('sum', 'mean'):
        with pytest.raises(RuntimeError, match='use_kernel_spmm'):
            spmm(ei, xt, reduce=reduce)
    assert segment_spmm.launches == before
    assert spmm_regime(ei, reduce='max') == 'plain'
    spmm(ei, xt, reduce='max')


# -- the segment-sum kernel's backward ----------------------------------------
@pytest.mark.parametrize('f', [1, 10, 64])
@pytest.mark.parametrize('n_src,n_dst', [(500, 500), (300, 800)])
def test_kernel_backward_matches_plain_autograd(dev, f, n_src, n_dst):
    """grad_x (the kernel over the CSR) and grad_w against autograd through
    the plain version on the same card."""
    coo, w, x = _case(n_src, n_dst, 6000, f, seed=f + n_src)
    ei = EdgeIndex(coo, (n_src, n_dst), device=dev).fill_cache()
    c = torch.randn(n_dst, f, device=dev,
                    generator=torch.Generator(dev).manual_seed(f))
    xt = torch.as_tensor(x, device=dev).requires_grad_()
    wt = torch.as_tensor(w, device=dev).requires_grad_()
    before = segment_spmm.launches
    (spmm(ei, xt, wt) * c).sum().backward()
    assert segment_spmm.launches == before + 2     # forward, grad_x
    xr = xt.detach().clone().requires_grad_()
    wr = wt.detach().clone().requires_grad_()
    csc = ei.csc
    ref = segment_spmm_plain(csc.indptr, csc.indices,
                             wr[csc.perm].contiguous(), xr)
    (ref * c).sum().backward()
    for got, want in ((xt.grad, xr.grad), (wt.grad, wr.grad)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


# -- the block-sparse kernel --------------------------------------------------
def _bsr_case(n_src, n_dst, e, seed):
    """Edges clustered in 128-blocks along the diagonal, some dst block rows
    left empty, plus a scattered tail; padded edges."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, max(n_dst, n_src) // 128 + 1, e)
    src = np.clip(c * 128 + rng.integers(0, 128, e), 0, n_src - 1)
    dst = np.clip(c * 128 + rng.integers(0, 128, e), 0, n_dst - 1)
    tail = np.stack([rng.integers(0, n_src, 200),
                     rng.integers(0, n_dst, 200)])
    coo = np.concatenate([np.stack([src, dst]), tail], 1)
    coo = coo[:, (coo[1] // 128) % 3 != 1]      # empty dst block rows
    pad = np.stack([np.full(5, n_src), np.full(5, n_dst)])
    coo = np.concatenate([coo, pad], 1).astype(np.int32)
    return coo, rng.random(coo.shape[1]).astype(np.float32), rng


def _bsr_close(layout, x, num_out):
    before = bsr_matmul.launches
    out = bsr_matmul(layout, x, num_out)
    torch.cuda.synchronize()
    assert bsr_matmul.launches == before + 1
    ref = bsr_spmm_plain(layout, x, num_out)
    scale = bsr_spmm_plain(layout._replace(vals=layout.vals.abs()),
                           x.abs(), num_out)
    _close(out, ref, scale)
    return out


BSR_WIDTHS = [1, 8, 10, 16, 17, 33, 64, 65, 128, 130]


@pytest.mark.parametrize('f', BSR_WIDTHS)
@pytest.mark.parametrize('n_src,n_dst', [(600, 600), (300, 700)])
def test_bsr_kernel_matches_plain(dev, f, n_src, n_dst):
    coo, w, rng = _bsr_case(n_src, n_dst, 20_000, seed=f + n_dst)
    fwd, bwd, _ = build_bsr_pair(coo, w, n_src, n_dst, device=dev)
    assert (torch.diff(fwd.row_ptr) == 0).any()    # an empty block row
    x = torch.as_tensor(rng.standard_normal((n_src, f)).astype(np.float32),
                        device=dev)
    out = _bsr_close(fwd, x, n_dst)
    g = torch.as_tensor(rng.standard_normal((n_dst, f)).astype(np.float32),
                        device=dev)
    _bsr_close(bwd, g, n_src)
    empty_rows = torch.nonzero(torch.diff(fwd.row_ptr) == 0).flatten()
    for r in empty_rows.tolist():
        assert not out[r * 128:(r + 1) * 128].any()


def test_bsr_kernel_unaligned_x_and_no_blocks(dev):
    coo, w, rng = _bsr_case(500, 500, 8000, seed=3)
    fwd, _, _ = build_bsr_pair(coo, w, 500, 500, device=dev)
    base = torch.as_tensor(rng.standard_normal(500 * 16).astype(np.float32),
                           device=dev)
    xt = torch.cat([base.new_zeros(1), base])[1:].view(500, 16)
    assert xt.is_contiguous() and xt.data_ptr() % 16 != 0
    _bsr_close(fwd, xt, 500)
    none = BSR(vals=torch.zeros(0, 128, 128, device=dev),
               cols=torch.zeros(0, dtype=torch.int32, device=dev),
               row_ptr=torch.zeros(5, dtype=torch.int32, device=dev))
    out = bsr_matmul(none, torch.ones(300, 8, device=dev), 500)
    torch.cuda.synchronize()
    assert out.shape == (500, 8) and not out.any()


def _deep_ring(monkeypatch):
    """Plans whose ring is deeper than shared memory holds: a launch the
    card refuses."""
    plan = bsr_spmm_module.bsr_plan
    assert plan(64, False).stage_bytes * MAX_STAGES > SMEM_BYTES
    monkeypatch.setattr(bsr_spmm_module, 'bsr_plan', lambda f, bf16: plan(
        f, bf16)._replace(stages=MAX_STAGES))


def test_bsr_kernel_raises_on_a_failed_launch(dev, monkeypatch):
    """A launch the card refuses (a ring deeper than shared memory holds)
    raises instead of returning an unwritten output."""
    coo, w, _ = _bsr_case(128, 128, 2000, seed=4)
    fwd, _, _ = build_bsr_pair(coo, w, 128, 128, device=dev)
    x = torch.zeros(128, 64, device=dev)
    before = bsr_matmul.launches
    with monkeypatch.context() as m:
        _deep_ring(m)
        with pytest.raises(RuntimeError, match='launch failed'):
            bsr_matmul(fwd, x, 128)
    assert bsr_matmul.launches == before
    # the refusal is reported once: the next launch runs
    bsr_matmul(fwd, x, 128)
    torch.cuda.synchronize()
    assert bsr_matmul.launches == before + 1


def _long_rows_case(n, seed):
    """Dst block rows with many blocks (more than the ring has stages),
    rows with one block, empty rows, and padded edges."""
    rng = np.random.default_rng(seed)
    nb_rows = -(-n // 128)
    parts = []
    for r in range(nb_rows):
        kind = r % 3
        dst = r * 128 + rng.integers(0, 128, 3000)
        if kind == 0:                      # blocks in every source tile
            src = rng.integers(0, n, 3000)
        elif kind == 1:                    # one block
            c = rng.integers(0, nb_rows)
            src = c * 128 + rng.integers(0, 128, 3000)
        else:                              # empty
            continue
        parts.append(np.stack([src, dst]))
    coo = np.concatenate(parts, 1)
    coo = np.minimum(coo, n - 1)
    pad = np.stack([np.full(7, n), np.full(7, n)])
    coo = np.concatenate([coo, pad], 1).astype(np.int32)
    return coo, rng.random(coo.shape[1]).astype(np.float32), rng


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('f', BSR_WIDTHS)
def test_bsr_kernel_long_short_and_empty_rows(dev, bf16, f):
    """Both arms, both layouts: rows of 11 blocks (the ring holds 3-5
    chunks), one-block rows and empty rows; two launches bitwise equal (each
    output row is written once, with no atomics)."""
    n = 1400
    coo, w, rng = _long_rows_case(n, seed=f)
    fwd, bwd, _ = build_bsr_pair(coo, w, n, n, device=dev)
    counts = torch.diff(fwd.row_ptr)
    stages = bsr_plan(f, bf16).stages
    assert int(counts.max()) * (1 if bf16 else 2) > stages
    assert (counts == 1).any() and (counts == 0).any()
    for lay in (fwd, bwd):
        if bf16:
            lay = lay._replace(vals=lay.vals.to(torch.bfloat16))
        x = torch.as_tensor(rng.standard_normal((n, f)).astype(np.float32),
                            device=dev)
        before = (bsr_matmul.launches, bsr_matmul.launches_bf16)
        out = bsr_matmul(lay, x, n)
        again = bsr_matmul(lay, x, n)
        torch.cuda.synchronize()
        assert (bsr_matmul.launches, bsr_matmul.launches_bf16) == (
            (before[0], before[1] + 2) if bf16 else
            (before[0] + 2, before[1]))
        assert torch.equal(out, again)
        ref = bsr_spmm_plain(lay, x, n)
        scale = bsr_spmm_plain(lay._replace(vals=lay.vals.abs()), x.abs(),
                               n)
        _close(out, ref, scale)
        for r in torch.nonzero(torch.diff(lay.row_ptr) == 0).flatten(
                ).tolist():
            assert not out[r * 128:(r + 1) * 128].any()


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('offset', [1, 2, 3])
def test_bsr_kernel_unaligned_x_views(dev, bf16, offset):
    """x views 4, 8 and 12 bytes past a 16-byte boundary, at F = 10 (rows
    of 40 bytes) and 64; a layout without a row order."""
    coo, w, rng = _long_rows_case(700, seed=11)
    fwd, _, _ = build_bsr_pair(coo, w, 700, 700, device=dev)
    lay = BSR(vals=fwd.vals.to(torch.bfloat16) if bf16 else fwd.vals,
              cols=fwd.cols, row_ptr=fwd.row_ptr)
    for f in (10, 64):
        base = torch.as_tensor(rng.standard_normal(700 * f + 4).astype(
            np.float32), device=dev)
        xt = base[offset:offset + 700 * f].view(700, f)
        assert xt.data_ptr() % 16 != 0
        out = bsr_matmul(lay, xt, 700)
        torch.cuda.synchronize()
        ref = bsr_spmm_plain(lay, xt, 700)
        scale = bsr_spmm_plain(lay._replace(vals=lay.vals.abs()), xt.abs(),
                               700)
        _close(out, ref, scale)


def _powerlaw_case(n, e, seed, n_pad=40):
    """Scrambled power-law graph: its natural order scatters the hubs, so
    fill_cache bakes a hubs-first relabel; padded edges."""
    rng = np.random.default_rng(seed)
    pw = np.arange(1, n + 1) ** -0.9
    pw /= pw.sum()
    sc = rng.permutation(n)
    coo = np.stack([sc[rng.choice(n, e, p=pw)], sc[rng.choice(n, e, p=pw)]])
    coo = np.concatenate([coo, np.full((2, n_pad), n)], 1).astype(np.int32)
    return coo, rng.random(coo.shape[1]).astype(np.float32), rng


@pytest.mark.parametrize('graph', ['clustered', 'powerlaw-relabel'])
@pytest.mark.parametrize('reduce', ['sum', 'mean'])
@pytest.mark.parametrize('transpose', [False, True])
def test_spmm_bsr_on_card_matches_cpu(dev, reduce, transpose, graph):
    """The 'bsr' arm (blocks + residual) with its backward, on the card
    against the CPU's plain versions; on the power-law graph also the
    relabel (``x[bsr_perm]`` before the blocks, ``out[bsr_inv]`` after)."""
    n = 900 if graph == 'clustered' else 3000
    coo, w, rng = (_bsr_case(n, n, 30_000, seed=5) if graph == 'clustered'
                   else _powerlaw_case(n, 6000, seed=1))
    outs, grads = [], []
    x = rng.standard_normal((n, 24)).astype(np.float32)
    c = rng.standard_normal((n, 24)).astype(np.float32)
    for d in (dev, 'cpu'):
        ei = EdgeIndex(coo, (n, n), device=d).fill_cache(
            dense_weight=w, block_sparse=True)
        assert spmm_regime(ei) == 'bsr' and ei.bsr_res is not None
        assert (ei.bsr_perm is None) == (graph == 'clustered')
        xt = torch.as_tensor(x, device=d).requires_grad_()
        before = (bsr_matmul.launches, segment_spmm.launches)
        out = spmm(ei, xt, reduce=reduce, transpose=transpose)
        (out * torch.as_tensor(c, device=d)).sum().backward()
        launched = (bsr_matmul.launches - before[0],
                    segment_spmm.launches - before[1])
        assert launched == ((2, 2) if d == dev else (0, 0))
        outs.append(out.detach().cpu())
        grads.append(xt.grad.cpu())
    for got, ref in zip((outs[0], grads[0]), (outs[1], grads[1])):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize('block_sparse', [True, False])
def test_gcn_training_steps_on_card_match_cpu(dev, block_sparse,
                                              monkeypatch):
    """Three Adam steps of a 3-layer GCN over cache_gcn_norm, through the
    BSR arm or (past the dense cap, blocks declined, weights carried) the
    segment-sum arm, on the card against the CPU."""
    coo, _, rng = _bsr_case(1000, 1000, 30_000, seed=6)
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    y = rng.integers(0, 5, 1000)
    if not block_sparse:
        monkeypatch.setenv('PGT_DENSE_SPMM_ENTRIES', '0')
    losses = []
    for d in (dev, 'cpu'):
        ei = cache_gcn_norm(EdgeIndex(coo, (1000, 1000), device=d),
                            block_sparse=block_sparse)
        assert spmm_regime(ei) == ('bsr' if block_sparse else (
            'kernel' if d == dev else 'plain'))
        model = GCN(16, 16, 3, 5, device=d,
                    generator=torch.Generator().manual_seed(0),
                    conv_kwargs={'normalize': False,
                                 'add_self_loops': False})
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        xt = torch.as_tensor(x, device=d)
        yt = torch.as_tensor(y, device=d)
        run = []
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(model(xt, ei), yt)
            loss.backward()
            opt.step()
            run.append(loss.item())
        losses.append(run)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)


# -- the GAT mix kernel -------------------------------------------------------
def _slots(n_src, n_dst, e, dev, seed, n_pad=8):
    coo, _, _ = _case(n_src, n_dst, e, 1, seed, n_pad)
    return EdgeIndex(coo, (n_src, n_dst), device=dev).fill_cache(
        blocked=True)


@pytest.mark.parametrize('h', [1, 4, 8])
@pytest.mark.parametrize('f', [0, 1, 10, 16, 64])
@pytest.mark.parametrize('n_src,n_dst', [(500, 500), (300, 800)])
def test_gat_mix_kernel_matches_plain(dev, h, f, n_src, n_dst):
    """``(s, u)`` with p_s != p_u over empty rows and padded slots; f = 0
    is the stabiliser pass (v absent, s only). Tolerance: 1e-5 + 1e-5 of
    the row's sum of |p * v| terms."""
    ei = _slots(n_src, n_dst, 6000, dev, seed=h + f + n_dst)
    blk = ei.blocked
    g = torch.Generator(dev).manual_seed(h * 100 + f)
    e = blk.src.shape[0]
    p_s = torch.rand(e, h, device=dev, generator=g)
    p_u = torch.rand(e, h, device=dev, generator=g)
    v = (torch.randn(n_src, h * f, device=dev, generator=g) if f else None)
    before = gat_mix.launches
    s, u = gat_mix(blk.indptr, blk.src, p_s, p_u if f else None, v, f)
    torch.cuda.synchronize()
    assert gat_mix.launches == before + 1
    rs, ru = gat_mix_plain(blk.indptr, blk.src, p_s, p_u, v, f)
    _close(s, rs, rs)                      # p_s >= 0: its sum is its scale
    if f:
        _, scale = gat_mix_plain(blk.indptr, blk.src, None, p_u, v.abs(), f)
        _close(u, ru, scale)
    else:
        assert u is None
    empty = torch.diff(blk.indptr) == 0
    assert empty.any() and not s[empty].any()


def test_gat_mix_kernel_unaligned_and_refusals(dev):
    ei = _slots(200, 200, 1500, dev, seed=9)
    blk = ei.blocked
    e = blk.src.shape[0]
    p = torch.rand(e, 2, device=dev)
    base = torch.randn(200 * 2 * 8 + 1, device=dev)
    v = base[1:].view(200, 16)           # 4 bytes past a 16-byte boundary
    assert v.is_contiguous() and v.data_ptr() % 16 != 0
    _, u = gat_mix(blk.indptr, blk.src, None, p, v, 8)
    _, ru = gat_mix_plain(blk.indptr, blk.src, None, p, v, 8)
    _, scale = gat_mix_plain(blk.indptr, blk.src, None, p, v.abs(), 8)
    _close(u, ru, scale)
    with pytest.raises(TypeError, match='float32'):
        gat_mix(blk.indptr, blk.src, p.half(), None, None)
    with pytest.raises(ValueError, match='is on cpu'):
        gat_mix(blk.indptr, blk.src, p.cpu(), None, None)
    with pytest.raises(ValueError, match='heads of'):
        gat_mix(blk.indptr, blk.src, None, p, v, 5)


@pytest.mark.parametrize('h,f', [(1, 8), (4, 16), (4, 10)])
def test_gat_aggregate_on_card_matches_cpu(dev, h, f):
    """The fused aggregation's forward (2 launches) and backward (grad_v,
    1 launch) on the card against the plain versions on the CPU, with an
    edge mask and a numerator scale."""
    rng = np.random.default_rng(h + f)
    coo, _, _ = _case(300, 400, 5000, 1, seed=h * f)
    e = coo.shape[1]
    logits = (rng.standard_normal((e, h)) * 3).astype(np.float32)
    v = rng.standard_normal((300, h, f)).astype(np.float32)
    c = rng.standard_normal((400, h, f)).astype(np.float32)
    mask = rng.random(e) < 0.8
    scale = (rng.random((e, h)) < 0.7).astype(np.float32) / 0.7
    res = []
    for d in (dev, 'cpu'):
        ei = EdgeIndex(coo, (300, 400), device=d).fill_cache(blocked=True)
        lt = torch.as_tensor(logits, device=d).requires_grad_()
        vt = torch.as_tensor(v, device=d).requires_grad_()
        before = gat_mix.launches
        out = gat_aggregate(ei, lt, vt, edge_mask=torch.as_tensor(
            mask, device=d), numerator_scale=torch.as_tensor(scale, device=d))
        assert gat_mix.launches - before == (2 if d == dev else 0)
        (out * torch.as_tensor(c, device=d)).sum().backward()
        assert gat_mix.launches - before == (3 if d == dev else 0)
        res.append([t.detach().cpu() for t in (out, lt.grad, vt.grad)])
    for got, ref in zip(*res):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))


# -- the segment-max kernel ---------------------------------------------------
@pytest.mark.parametrize('h', [1, 3, 4, 8, 32, 40])
@pytest.mark.parametrize('n_src,n_dst', [(500, 500), (300, 800)])
def test_segment_max_kernel_bitwise(dev, h, n_src, n_dst):
    """Bitwise equal to its plain version: -inf entries, masked (all -inf)
    edges, empty rows, padded slots."""
    ei = _slots(n_src, n_dst, 6000, dev, seed=h + n_dst)
    blk = ei.blocked
    g = torch.Generator(dev).manual_seed(h)
    e = blk.src.shape[0]
    vals = torch.randn(e, h, device=dev, generator=g) * 10
    vals[torch.rand(e, h, device=dev, generator=g) < 0.2] = float('-inf')
    vals[torch.rand(e, device=dev, generator=g) < 0.3] = float('-inf')
    before = segment_max_blocked.launches
    out = segment_max_blocked(vals, blk, n_dst)
    torch.cuda.synchronize()
    assert segment_max_blocked.launches == before + 1
    ref = segment_max_plain(blk.indptr, vals)
    assert torch.equal(out, ref)
    empty = torch.diff(blk.indptr) == 0
    assert empty.any() and torch.isneginf(out[empty]).all()


# -- GAT on the card ----------------------------------------------------------
@pytest.mark.parametrize('cls', [GATConv, GATv2Conv])
def test_fused_gatconv_on_card(dev, cls, monkeypatch):
    """A fused conv on the card launches the mix kernel twice per forward
    (stabiliser and mix) and agrees with the CPU; with the kernel knob off
    it raises instead of running the plain branch on the card."""
    coo, _, x = _case(400, 400, 5000, 12, seed=13, n_pad=0)
    outs = []
    for d in (dev, 'cpu'):
        conv = cls(12, 8, heads=4, add_self_loops=False, device=d,
                   generator=torch.Generator().manual_seed(0))
        ei = EdgeIndex(coo, (400, 400), device=d).fill_cache(blocked=True)
        before = gat_mix.launches
        with torch.inference_mode():
            outs.append(conv(torch.as_tensor(x, device=d), ei).cpu())
        assert gat_mix.launches - before == (2 if d == dev else 0)
    torch.testing.assert_close(outs[0], outs[1], rtol=0,
                               atol=1e-4 * float(outs[1].abs().max()))
    monkeypatch.setattr(backend, 'use_kernel_spmm', False)
    with pytest.raises(RuntimeError, match='use_kernel_spmm'):
        conv.to(dev)(torch.as_tensor(x, device=dev),
                     EdgeIndex(coo, (400, 400), device=dev).fill_cache())


def test_gat_training_steps_on_card_match_cpu(dev):
    """Three Adam steps of a 3-layer GAT on the fused branch: 9 mix
    launches per step (stabiliser, mix and grad_v per layer); losses
    against the CPU."""
    coo, _, x = _case(800, 800, 12_000, 16, seed=14, n_pad=0)
    y = np.random.default_rng(0).integers(0, 5, 800)
    losses = []
    for d in (dev, 'cpu'):
        ei = EdgeIndex(coo, (800, 800), device=d).fill_cache(blocked=True)
        model = GAT(16, 32, 3, 5, heads=4, device=d,
                    generator=torch.Generator().manual_seed(0),
                    conv_kwargs={'add_self_loops': False})
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        xt, yt = torch.as_tensor(x, device=d), torch.as_tensor(y, device=d)
        run = []
        before = gat_mix.launches
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(model(xt, ei), yt)
            loss.backward()
            opt.step()
            run.append(loss.item())
        assert gat_mix.launches - before == (27 if d == dev else 0)
        losses.append(run)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)


# -- the precision ladder -----------------------------------------------------
def _bf16_close(out, ref, scale):
    """Within one bf16 ulp of ``ref`` plus the row-scaled float32 limit."""
    out, ref = out.float(), ref.float()
    _, e = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), e - 8)
    err = (out - ref).abs()
    assert bool((err <= ulp + 1e-5 + 1e-5 * scale.float()).all()), \
        float(err.max())


@pytest.mark.parametrize('f', BSR_WIDTHS)
@pytest.mark.parametrize('n_src,n_dst', [(600, 600), (300, 700)])
def test_bsr_bf16_kernel_matches_plain(dev, f, n_src, n_dst):
    """The tensor-core arm over bf16 blocks, both layouts, empty block
    rows; float32 and bf16 x."""
    coo, w, rng = _bsr_case(n_src, n_dst, 20_000, seed=f + n_dst)
    fwd, bwd, _ = build_bsr_pair(coo, w, n_src, n_dst, device=dev)
    for lay, n_in, n_out in ((fwd, n_src, n_dst), (bwd, n_dst, n_src)):
        lay = lay._replace(vals=lay.vals.to(torch.bfloat16))
        x = torch.as_tensor(rng.standard_normal((n_in, f)).astype(
            np.float32), device=dev)
        for xt in (x, x.bfloat16()):
            before = (bsr_matmul.launches, bsr_matmul.launches_bf16)
            out = bsr_matmul(lay, xt, n_out)
            torch.cuda.synchronize()
            assert (bsr_matmul.launches, bsr_matmul.launches_bf16) == (
                before[0], before[1] + 1)
            assert out.dtype == xt.dtype
            ref = bsr_spmm_plain(lay, xt, n_out)
            scale = bsr_spmm_plain(lay._replace(vals=lay.vals.abs()),
                                   xt.abs(), n_out)
            if xt.dtype == torch.float32:
                _close(out, ref, scale)
            else:
                _bf16_close(out, ref, scale)
        empty = torch.nonzero(torch.diff(lay.row_ptr) == 0).flatten()
        for r in empty.tolist():
            assert not out[r * 128:(r + 1) * 128].any()


def test_bsr_bf16_kernel_refusals(dev, monkeypatch):
    """A bf16 call the kernel cannot take raises; nothing falls back."""
    coo, w, _ = _bsr_case(128, 128, 2000, seed=4)
    fwd, _, _ = build_bsr_pair(coo, w, 128, 128, device=dev)
    lay = fwd._replace(vals=fwd.vals.to(torch.bfloat16))
    before = bsr_matmul.launches_bf16
    # a ring deeper than shared memory holds is a launch the card refuses
    with monkeypatch.context() as m:
        _deep_ring(m)
        with pytest.raises(RuntimeError, match='launch failed'):
            bsr_matmul(lay, torch.zeros(128, 64, device=dev), 128)
    # values 2 bytes past a 16-byte boundary cannot take the bulk copies
    flat = torch.zeros(lay.vals.numel() + 8, dtype=torch.bfloat16,
                       device=dev)
    odd = flat[1:lay.vals.numel() + 1].view_as(lay.vals)
    with pytest.raises(ValueError, match='16-byte'):
        bsr_matmul(lay._replace(vals=odd), torch.ones(128, 8, device=dev),
                   128)
    assert bsr_matmul.launches_bf16 == before


@pytest.mark.parametrize('f', [1, 10, 16, 24, 128, 130])
@pytest.mark.parametrize('weighted', [True, False])
@pytest.mark.parametrize('n_src,n_dst', [(500, 500), (300, 800)])
def test_kernel_bf16_matches_plain(dev, f, weighted, n_src, n_dst):
    """The segment-sum kernel's bf16 arm, forward and grad_x: bf16(w * x)
    messages, float32 sums, bf16 out."""
    coo, w, x = _case(n_src, n_dst, 6000, f, seed=f + n_dst)
    ei = EdgeIndex(coo, (n_src, n_dst), device=dev).fill_cache()
    csc, csr = ei.csc, ei.csr
    wt = torch.as_tensor(w, device=dev).bfloat16()
    w_csc = wt[csc.perm].contiguous() if weighted else None
    w_csr = wt[csr.perm].contiguous() if weighted else None
    xt = torch.as_tensor(x, device=dev).bfloat16().requires_grad_()
    g = torch.randn(n_dst, f, device=dev,
                    generator=torch.Generator(dev).manual_seed(f)).bfloat16()
    before = segment_spmm.launches, segment_spmm.launches_bf16
    out = segment_spmm(csc.indptr, csc.indices, w_csc, xt,
                       (csr.indptr, csr.indices, w_csr))
    out.backward(g)
    torch.cuda.synchronize()
    assert (segment_spmm.launches, segment_spmm.launches_bf16) == (
        before[0], before[1] + 2)
    assert out.dtype == xt.grad.dtype == torch.bfloat16
    xr = xt.detach()
    ref = segment_spmm_plain(csc.indptr, csc.indices, w_csc, xr)
    gref = segment_spmm_plain(csr.indptr, csr.indices, w_csr, g)
    abs_w = (None, None) if not weighted else (w_csc.abs(), w_csr.abs())
    _bf16_close(out, ref, segment_spmm_plain(csc.indptr, csc.indices,
                                             abs_w[0], xr.abs()))
    _bf16_close(xt.grad, gref, segment_spmm_plain(csr.indptr, csr.indices,
                                                  abs_w[1], g.abs()))


def test_kernel_bf16_unaligned_and_refusals(dev, monkeypatch):
    coo, w, x = _case(200, 200, 1500, 16, seed=3)
    csc = EdgeIndex(coo, (200, 200), device=dev).fill_cache().csc
    base = torch.as_tensor(x, device=dev).bfloat16().flatten()
    # 2 bytes past a 16-byte boundary: F % 8 == 0, but scalar loads
    xt = torch.cat([base.new_zeros(1), base])[1:].view(200, 16)
    assert xt.data_ptr() % 16 != 0
    out = segment_spmm(csc.indptr, csc.indices, None, xt)
    _bf16_close(out, segment_spmm_plain(csc.indptr, csc.indices, None, xt),
                segment_spmm_plain(csc.indptr, csc.indices, None, xt.abs()))
    # bf16 x takes bf16 weights only; spmm promotes float32 weights instead
    with pytest.raises(ValueError, match='w'):
        segment_spmm(csc.indptr, csc.indices,
                     torch.ones(csc.indices.shape[0], device=dev), xt)
    ei = EdgeIndex(coo, (200, 200), device=dev).fill_cache()
    wt = torch.as_tensor(w, device=dev)
    before = segment_spmm.launches, segment_spmm.launches_bf16
    assert spmm(ei, xt, wt).dtype == torch.float32
    assert spmm(ei, xt).dtype == torch.bfloat16
    assert (segment_spmm.launches, segment_spmm.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    monkeypatch.setattr(backend, 'use_kernel_spmm', False)
    with pytest.raises(RuntimeError, match='use_kernel_spmm'):
        spmm(ei, xt)


@pytest.mark.parametrize('h', [1, 4])
@pytest.mark.parametrize('f', [0, 1, 10, 16, 64])
def test_gat_mix_bf16_kernel_matches_plain(dev, h, f):
    """The per-head form's bf16 arm: p_s, p_u and v all bf16."""
    ei = _slots(300, 800, 6000, dev, seed=h + f)
    blk = ei.blocked
    g = torch.Generator(dev).manual_seed(h * 100 + f)
    e = blk.src.shape[0]
    p_s = torch.rand(e, h, device=dev, generator=g).bfloat16()
    p_u = torch.rand(e, h, device=dev, generator=g).bfloat16()
    v = (torch.randn(300, h * f, device=dev, generator=g).bfloat16()
         if f else None)
    before = gat_mix.launches, gat_mix.launches_bf16
    s, u = gat_mix(blk.indptr, blk.src, p_s, p_u if f else None, v, f)
    torch.cuda.synchronize()
    assert (gat_mix.launches, gat_mix.launches_bf16) == (before[0],
                                                         before[1] + 1)
    rs, ru = gat_mix_plain(blk.indptr, blk.src, p_s, p_u, v, f)
    assert s.dtype == torch.bfloat16
    _bf16_close(s, rs, rs)
    if f:
        _, scale = gat_mix_plain(blk.indptr, blk.src, None, p_u, v.abs(), f)
        _bf16_close(u, ru, scale)


@pytest.mark.parametrize('cache', ['f32', 'bf16', 'int8'])
@pytest.mark.parametrize('reduce,transpose', [('sum', False),
                                              ('mean', False),
                                              ('sum', True)])
def test_dense_cache_on_card_matches_cpu(dev, cache, reduce, transpose):
    """The dense arms launch no kernel of the port and agree with the CPU:
    float32 and bf16 (exact products, float32 sums in another order) within
    1e-5 of the largest magnitude, int8 (exact int32 products) within 1e-6;
    the bf16 grad_x within one bf16 ulp."""
    dt = {'f32': None, 'bf16': torch.bfloat16, 'int8': torch.int8}[cache]
    coo, w, x = _case(300, 500, 6000, 24, seed=21, n_pad=0)
    x = np.random.default_rng(0).standard_normal(
        (500 if transpose else 300, 24)).astype(np.float32)
    res = []
    for d in (dev, 'cpu'):
        ei = EdgeIndex(coo, (300, 500), device=d).fill_cache(
            dense_weight=w, cache_dtype=dt)
        assert spmm_regime(ei) == 'dense-cached'
        xt = torch.as_tensor(x, device=d).requires_grad_(cache != 'int8')
        before = (segment_spmm.launches, bsr_matmul.launches,
                  bsr_matmul.launches_bf16, segment_spmm.launches_bf16)
        out = spmm(ei, xt, reduce=reduce, transpose=transpose)
        if cache != 'int8':
            out.sum().backward()
        assert (segment_spmm.launches, bsr_matmul.launches,
                bsr_matmul.launches_bf16,
                segment_spmm.launches_bf16) == before
        res.append((out.detach().cpu(),
                    None if xt.grad is None else xt.grad.cpu()))
    (out, gx), (ref, gref) = res
    tol = 1e-6 if cache == 'int8' else 1e-5
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=tol * float(ref.abs().max()))
    if cache == 'bf16':
        _bf16_close(gx, gref, torch.zeros_like(gref))
    elif cache == 'f32':
        torch.testing.assert_close(gx, gref, rtol=0,
                                   atol=1e-5 * float(gref.abs().max()))


def test_dense_int8_odd_sizes_on_card(dev):
    """The card's int8 matmul takes K and N in multiples of 8 and more than
    16 rows: the wrapper pads with zeros, which adds nothing."""
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.integers(-127, 128, (13, 37)).astype(np.int8),
                        device=dev)
    r = torch.rand(13, device=dev)
    c = torch.rand(37, device=dev)
    x = torch.as_tensor(rng.standard_normal((37, 5)).astype(np.float32),
                        device=dev)
    out = dense_spmm(q, (r, c), x)
    ref = dense_spmm(q.cpu(), (r.cpu(), c.cpu()), x.cpu())
    torch.testing.assert_close(out.cpu(), ref, rtol=0,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize('cls', [GraphSAGE, GIN])
def test_bf16_features_on_card_match_cpu(dev, cls):
    """bf16 features: layer 1 launches the segment-sum kernel's bf16 arm,
    layers 2 and 3 its float32 arm; the float32 output agrees with the CPU
    within 1e-2 of its largest magnitude (a flipped bf16 rounding in layer
    1 moves a feature by up to 2^-8)."""
    coo, _, x = _case(600, 600, 8000, 32, seed=22, n_pad=0)
    outs = []
    for d in (dev, 'cpu'):
        model = cls(32, 32, 3, 8, device=d,
                    generator=torch.Generator().manual_seed(0)).eval()
        ei = EdgeIndex(coo, (600, 600), device=d).fill_cache()
        before = segment_spmm.launches, segment_spmm.launches_bf16
        with torch.inference_mode():
            outs.append(model(torch.as_tensor(x, device=d).bfloat16(),
                              ei).cpu())
        launched = (segment_spmm.launches - before[0],
                    segment_spmm.launches_bf16 - before[1])
        assert launched == ((2, 1) if d == dev else (0, 0))
    assert outs[0].dtype == torch.float32
    torch.testing.assert_close(outs[0], outs[1], rtol=0,
                               atol=1e-2 * float(outs[1].abs().max()))


@pytest.mark.parametrize('block_sparse', [True, False])
def test_gcn_training_over_bf16_caches_on_card(dev, block_sparse):
    """Three Adam steps of GCN over the bf16 block cache (5 bf16 block
    launches per step) or the dense bf16 cache (no kernel launch), on the
    card against the CPU; losses within 1e-3 relative (bf16 roundings of
    layer inputs can flip where the float32 sums differ in the last bit)."""
    coo, _, rng = _bsr_case(1000, 1000, 30_000, seed=6)
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    y = rng.integers(0, 5, 1000)
    losses = []
    for d in (dev, 'cpu'):
        ei = cache_gcn_norm(EdgeIndex(coo, (1000, 1000), device=d),
                            block_sparse=block_sparse,
                            cache_dtype=torch.bfloat16)
        assert spmm_regime(ei) == ('bsr' if block_sparse else
                                   'dense-cached')
        model = GCN(16, 16, 3, 5, device=d,
                    generator=torch.Generator().manual_seed(0),
                    conv_kwargs={'normalize': False,
                                 'add_self_loops': False})
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        xt, yt = torch.as_tensor(x, device=d), torch.as_tensor(y, device=d)
        before = bsr_matmul.launches_bf16
        run = []
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(model(xt, ei), yt)
            loss.backward()
            opt.step()
            run.append(loss.item())
        assert bsr_matmul.launches_bf16 - before == (
            15 if d == dev and block_sparse else 0)
        losses.append(run)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-3)


# -- the redesigned mix and segment-max kernels -------------------------------
def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def _mix_inputs(dev, dtype, h, f, layout, seed, offset=0):
    """A slot order of a bipartite graph (300 -> 800, empty rows, padded
    slots) with p_s, p_u and v of ``dtype``: the forward layout (s and u
    over the CSC, v over the sources) or the backward one (u only over the
    CSR, v over the destinations, as ``grad_v`` runs it). ``offset``
    elements in front of v leave it that far past a 16-byte boundary."""
    ei = _slots(300, 800, 6000, dev, seed=seed)
    blk = ei.blocked if layout == 'forward' else ei.blocked_t
    n_rows = 300 if layout == 'forward' else 800
    g = torch.Generator(dev).manual_seed(seed)
    e = blk.src.shape[0]
    p_s = (torch.rand(e, h, device=dev, generator=g).to(dtype)
           if layout == 'forward' else None)
    p_u = torch.rand(e, h, device=dev, generator=g).to(dtype)
    base = torch.randn(n_rows * h * f + offset, device=dev,
                       generator=g).to(dtype)
    return blk, p_s, p_u, base[offset:].view(n_rows, h * f)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('h', [1, 4, 8])
@pytest.mark.parametrize('f', [1, 10, 16, 33, 64])
@pytest.mark.parametrize('layout', ['forward', 'backward'])
def test_gat_mix_bitwise_across_slice_widths(dev, dtype, h, f, layout):
    """Every slice width that tiles H*F gives the same bits (each output
    element is the same sum in the same order, whatever the slice and the
    vector width), and one slice agrees with the plain version: 1e-5 +
    1e-5 of the row's sum of |p * v| terms, plus one bf16 ulp in bf16."""
    blk, p_s, p_u, v = _mix_inputs(dev, dtype, h, f, layout,
                                   seed=h * 100 + f)
    ref = gat_mix(blk.indptr, blk.src, p_s, p_u, v, f, slice_cols=h * f)
    for w in _divisors(h * f):
        before = gat_mix.launches + gat_mix.launches_bf16
        out = gat_mix(blk.indptr, blk.src, p_s, p_u, v, f, slice_cols=w)
        assert gat_mix.launches + gat_mix.launches_bf16 == before + 1
        for a, b in zip(out, ref):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b), f'slice width {w}'
    torch.cuda.synchronize()
    close = _close if dtype == torch.float32 else _bf16_close
    rs, ru = gat_mix_plain(blk.indptr, blk.src, p_s, p_u, v, f)
    _, scale = gat_mix_plain(blk.indptr, blk.src, None, p_u, v.abs(), f)
    close(ref[1], ru, scale)
    if p_s is not None:
        close(ref[0], rs, rs)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('offset', [1, 2])
def test_gat_mix_slices_of_an_unaligned_v(dev, dtype, offset):
    """A v 1 or 2 elements past a 16-byte boundary takes narrower vectors
    (which then also straddle heads at F = 10): the same bits as an
    aligned copy, at every slice width."""
    h, f = 4, 10
    blk, p_s, p_u, v = _mix_inputs(dev, dtype, h, f, 'forward', seed=7,
                                   offset=offset)
    assert v.is_contiguous() and v.data_ptr() % 16 != 0
    ref = gat_mix(blk.indptr, blk.src, p_s, p_u, v.clone(), f)
    for w in _divisors(h * f):
        out = gat_mix(blk.indptr, blk.src, p_s, p_u, v, f, slice_cols=w)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_gat_mix_refuses_a_slice_width_that_does_not_tile(dev):
    blk, p_s, p_u, v = _mix_inputs(dev, torch.float32, 4, 10, 'forward', 3)
    for w in (0, 3, 80):
        with pytest.raises(ValueError, match='slice_cols'):
            gat_mix(blk.indptr, blk.src, p_s, p_u, v, 10, slice_cols=w)


@pytest.mark.parametrize('lanes', [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize('h', [1, 3, 4, 8, 12, 40])
def test_segment_max_long_rows_at_every_width(dev, lanes, h):
    """Rows longer than 32 * lanes slots beside short and empty ones, at
    every lanes-per-row width, with H a multiple of 4 (16-byte loads, a
    shuffle tree over the copies, or units walked per lane for H = 40) and
    not (scalars): bitwise equal to the plain version."""
    from types import SimpleNamespace
    rng = np.random.default_rng(lanes * 100 + h)
    n_dst = 40
    lens = rng.integers(0, 9, n_dst)
    lens[::7] = 64 * lanes + rng.integers(1, 50, len(lens[::7]))
    lens[3] = 0
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    vals = rng.standard_normal((int(indptr[-1]) + 5, h)) * 10  # 5 padded
    vals[rng.random(vals.shape) < 0.2] = -np.inf
    vals[rng.random(vals.shape[0]) < 0.3] = -np.inf            # masked slots
    lay = SimpleNamespace(indptr=torch.as_tensor(indptr, device=dev))
    vt = torch.as_tensor(vals.astype(np.float32), device=dev)
    out = segment_max_blocked(vt, lay, n_dst, lanes=lanes)
    torch.cuda.synchronize()
    assert torch.equal(out, segment_max_plain(lay.indptr, vt))
    assert torch.isneginf(out[3]).all()


def test_segment_max_unaligned_values_and_refusals(dev):
    """Values 4 bytes past a 16-byte boundary read as scalars, bitwise
    equal; a lanes width that is not a power of two in [1, 32] raises."""
    ei = _slots(300, 800, 6000, dev, seed=5)
    blk = ei.blocked
    e = blk.src.shape[0]
    base = torch.randn(e * 4 + 1, device=dev)
    vals = base[1:].view(e, 4)
    assert vals.data_ptr() % 16 != 0
    ref = segment_max_plain(blk.indptr, vals)
    for lanes in (None, 1, 8, 32):
        assert torch.equal(segment_max_blocked(vals, blk, 800, lanes=lanes),
                           ref)
    for lanes in (0, 3, 64):
        with pytest.raises(ValueError, match='power of two'):
            segment_max_blocked(vals, blk, 800, lanes=lanes)


# -- the segment-sum kernel's launch plans, base operand and refusals --------
def _hub_csc(n_src, n_dst, e, f, seed, hub=5000, n_pad=24, n_bad=20):
    """A destination-sorted CSC built in numpy: a third of the rows empty,
    a ``hub``-edge row, padded edges past ``indptr[-1]`` and sources outside
    ``[0, n_src)``; ``(indptr, src, w, x)`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(n_dst, max(1, 2 * n_dst // 3), replace=False)
    dst = np.concatenate([rows[rng.integers(0, len(rows), e)],
                          np.full(hub, rows[0])])
    src = rng.integers(0, n_src, len(dst))
    order = np.argsort(dst, kind='stable')
    dst, src = dst[order], src[order]
    bad = rng.choice(len(src), n_bad, replace=False)
    src[bad] = np.where(np.arange(n_bad) % 2, -1, n_src + 3)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(dst,
                                                        minlength=n_dst))])
    src = np.concatenate([src, rng.integers(0, n_src, n_pad)])
    return (indptr.astype(np.int32), src.astype(np.int32),
            rng.random(len(src)).astype(np.float32),
            rng.standard_normal((n_src, f)).astype(np.float32))


def _plans(f, itemsize):
    """Every plan the kernel takes for F = f at aligned pointers: each load
    width of the arm that divides F, each lanes count from the one that
    covers the row down to a quarter of it (more column passes), each lane
    group count the team allows."""
    from pytorch_geometric_tpu_torch.ops.segment_spmm import VEC_WIDTHS
    plans = []
    for vec in VEC_WIDTHS[itemsize]:
        if f % vec:
            continue
        need = 1
        while need < min(-(-f // vec), 32):
            need *= 2
        for lanes in sorted({need, max(need // 4, 1)}):
            g = 1
            while lanes * g <= 32:
                plans.append((vec, lanes, g, 32 // (lanes * g)))
                g *= 2
    return plans


PLAN_CASES = [(f, p) for f in (1, 10, 16, 24, 64, 128, 130)
              for p in _plans(f, 4)]


@pytest.mark.parametrize('f,plan', PLAN_CASES)
def test_segment_kernel_every_plan_matches_plain(dev, f, plan):
    """Every plan branch of the float32 arm, with and without base, over a
    5,000-edge hub row, empty rows, padded edges and sources out of range;
    two launches bitwise equal, and the staged and direct modes bitwise
    equal (the same sums in the same order)."""
    indptr, src, w, x = _hub_csc(300, 400, 6000, f, seed=f)
    t = {k: torch.as_tensor(v, device=dev) for k, v in
         (('indptr', indptr), ('src', src), ('w', w), ('x', x))}
    base = torch.randn(400, f, device=dev)
    for weighted in (True, False):
        wt = t['w'] if weighted else None
        scale = segment_spmm_plain(t['indptr'], t['src'],
                                   None if wt is None else wt.abs(),
                                   t['x'].abs())
        for b in (None, base):
            before = segment_spmm.launches
            out = segment_spmm(t['indptr'], t['src'], wt, t['x'], base=b,
                               plan=plan + (1,))
            again = segment_spmm(t['indptr'], t['src'], wt, t['x'], base=b,
                                 plan=plan + (1,))
            direct = segment_spmm(t['indptr'], t['src'], wt, t['x'], base=b,
                                  plan=plan + (0,))
            torch.cuda.synchronize()
            assert segment_spmm.launches == before + 3
            assert torch.equal(out, again) and torch.equal(out, direct)
            _close(out, segment_spmm_plain(t['indptr'], t['src'], wt, t['x'],
                                           b), scale)


BF16_PLAN_CASES = [(f, p) for f in (1, 10, 16, 24, 128)
                   for p in _plans(f, 2)]


@pytest.mark.parametrize('f,plan', BF16_PLAN_CASES)
def test_segment_bf16_kernel_every_plan_matches_plain(dev, f, plan):
    """Every plan branch of the bf16 arm, both modes, with and without a
    bf16 base."""
    indptr, src, w, x = _hub_csc(300, 400, 6000, f, seed=f + 1)
    ip, sp = (torch.as_tensor(a, device=dev) for a in (indptr, src))
    xb = torch.as_tensor(x, device=dev).bfloat16()
    base = torch.randn(400, f, device=dev).bfloat16()
    for wt in (torch.as_tensor(w, device=dev).bfloat16(), None):
        scale = segment_spmm_plain(ip, sp, None if wt is None else
                                   wt.float().abs(), xb.float().abs())
        for b in (None, base):
            before = segment_spmm.launches_bf16
            out = segment_spmm(ip, sp, wt, xb, base=b, plan=plan + (1,))
            again = segment_spmm(ip, sp, wt, xb, base=b, plan=plan + (1,))
            direct = segment_spmm(ip, sp, wt, xb, base=b, plan=plan + (0,))
            torch.cuda.synchronize()
            assert segment_spmm.launches_bf16 == before + 3
            assert out.dtype == torch.bfloat16 and torch.equal(out, again)
            assert torch.equal(out, direct)
            _bf16_close(out, segment_spmm_plain(ip, sp, wt, xb, b), scale)


def test_segment_kernel_f10_x_8_byte_aligned(dev):
    """F = 10 with x 8 bytes but not 16 bytes past an aligned address: the
    plan takes 8-byte loads (and 4-byte ones past a 4-byte offset)."""
    from pytorch_geometric_tpu_torch.ops.segment_spmm import segment_plan
    indptr, src, w, x = _hub_csc(300, 400, 6000, 10, seed=5)
    ip, sp, wt = (torch.as_tensor(a, device=dev) for a in (indptr, src, w))
    flat = torch.as_tensor(x, device=dev).flatten()
    for pad, vec in ((2, 2), (1, 1)):
        xt = torch.cat([flat.new_zeros(pad), flat])[pad:].view(300, 10)
        assert xt.is_contiguous() and xt.data_ptr() % 16 == 4 * pad
        plan = segment_plan(10, 4, 400, len(src), xt.data_ptr(), 0)
        assert plan.vec == vec
        out = segment_spmm(ip, sp, wt, xt)
        _close(out, segment_spmm_plain(ip, sp, wt, xt),
               segment_spmm_plain(ip, sp, wt.abs(), xt.abs()))


def test_segment_kernel_refuses_a_plan_that_does_not_tile(dev):
    """The C entry points return an error for a plan that does not tile
    and launch nothing; the wrapper raises before calling them; the next
    launch runs."""
    from pytorch_geometric_tpu_torch.ops.segment_spmm import _kernel
    indptr, src, w, x = _hub_csc(64, 80, 500, 16, seed=6, hub=50)
    ip, sp, xt = (torch.as_tensor(a, device=dev) for a in (indptr, src, x))
    before = segment_spmm.launches, segment_spmm.launches_bf16
    with pytest.raises(ValueError, match='does not tile'):
        segment_spmm(ip, sp, None, xt, plan=(4, 4, 4, 4))
    out = torch.full((80, 16), 7.0, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for plan in ((4, 4, 4, 4, 1), (4, 12, 1, 2, 1), (8, 4, 1, 8, 1),
                 (4, 4, 1, 4, 0), (4, 4, 1, 8, 2)):
        err = _kernel('f32')(ip.data_ptr(), sp.data_ptr(), None,
                             xt.data_ptr(), None, out.data_ptr(), 80, 64, 16,
                             len(src), *plan, stream)
        assert err != 0, plan
    xb, ob = xt.bfloat16(), out.bfloat16()
    assert _kernel('bf16')(ip.data_ptr(), sp.data_ptr(), None, xb.data_ptr(),
                           None, ob.data_ptr(), 80, 64, 16, len(src), 2, 8,
                           1, 4, 1, stream) != 0
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and bool((ob == 7.0).all())
    assert (segment_spmm.launches, segment_spmm.launches_bf16) == before
    out = segment_spmm(ip, sp, None, xt)
    torch.cuda.synchronize()
    assert segment_spmm.launches == before[0] + 1
    _close(out, segment_spmm_plain(ip, sp, None, xt),
           segment_spmm_plain(ip, sp, None, xt.abs()))


def test_segment_kernel_base_gradient_and_bsr_fusion(dev):
    """``base``'s gradient is ``g``; the block arm runs the block kernel
    and one segment-sum pass each way, and no separate add."""
    indptr, src, w, x = _hub_csc(200, 200, 3000, 24, seed=7, hub=300)
    ip, sp, wt = (torch.as_tensor(a, device=dev) for a in (indptr, src, w))
    xt = torch.as_tensor(x, device=dev)
    base = torch.randn(200, 24, device=dev, requires_grad=True)
    out = segment_spmm(ip, sp, wt, xt, base=base)
    g = torch.randn(200, 24, device=dev)
    out.backward(g)
    assert torch.equal(base.grad, g)
    _close(out.detach(), segment_spmm_plain(ip, sp, wt, xt) + base.detach(),
           segment_spmm_plain(ip, sp, wt.abs(), xt.abs()))
    coo, wb, rng = _bsr_case(900, 900, 30_000, seed=5)
    ei = EdgeIndex(coo, (900, 900), device=dev).fill_cache(
        dense_weight=wb, block_sparse=True)
    assert spmm_regime(ei) == 'bsr' and ei.bsr_res is not None
    xg = torch.randn(900, 24, device=dev, requires_grad=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spmm(ei, xg).sum().backward()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == 'CUDA']
    assert sum('segment_spmm_kernel' in n for n in names) == 2
    assert not any('CUDAFunctor_add' in n for n in names), names


# -- compat.compile: captured CUDA graphs -------------------------------------
def _compiled_gcn_steps(dev, ei, x, y, compiled, calls):
    """``calls`` Adam steps of a 3-layer GCN from seed-0 weights, eager or
    through ``compat.compile``: the losses, the parameters after, and the
    step callable."""
    from pytorch_geometric_tpu_torch import compat
    model = GCN(x.shape[1], 16, 3, 5, device=dev,
                generator=torch.Generator().manual_seed(0),
                conv_kwargs={'normalize': False, 'add_self_loops': False})
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, capturable=True)

    def step(x, ei, y):
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(x, ei), y)
        loss.backward()
        opt.step()
        return loss.detach()

    if compiled:
        step = compat.compile(step)
    losses = torch.stack([step(x, ei, y) for _ in range(calls)])
    return losses, [p.detach().clone() for p in model.parameters()], step


def _gcn_case(dev, n, e, f, seed, block_sparse=None):
    coo, _, rng = _bsr_case(n, n, e, seed=seed)
    ei = cache_gcn_norm(EdgeIndex(coo, (n, n), device=dev),
                        block_sparse=block_sparse)
    x = torch.as_tensor(rng.standard_normal((n, f)).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.integers(0, 5, n), device=dev)
    return ei, x, y


@pytest.mark.parametrize('block_sparse', [True, False])
def test_captured_gcn_step_equals_eager_bitwise(dev, block_sparse,
                                                monkeypatch):
    """Five compiled GCN steps (two eager warm-ups, a capture replayed once,
    two replays) take the eager steps bit for bit, through the block arm or
    the segment-sum arm."""
    if not block_sparse:
        monkeypatch.setenv('PGT_DENSE_SPMM_ENTRIES', '0')
    ei, x, y = _gcn_case(dev, 1000, 30_000, 16, seed=6,
                         block_sparse=block_sparse)
    assert spmm_regime(ei) == ('bsr' if block_sparse else 'kernel')
    l_eager, p_eager, _ = _compiled_gcn_steps(dev, ei, x, y, False, 5)
    l_cap, p_cap, step = _compiled_gcn_steps(dev, ei, x, y, True, 5)
    assert step.captures == 1 and step.replays == 3
    assert torch.equal(l_cap, l_eager), (l_cap, l_eager)
    for a, b in zip(p_cap, p_eager):
        assert torch.equal(a, b)


def test_compiled_forward_captures_again_per_shape(dev):
    """A second feature width is a second capture; each key replays its
    own graph, results are fresh tensors that a later call leaves alone."""
    from pytorch_geometric_tpu_torch import compat
    ei, x, _ = _gcn_case(dev, 800, 20_000, 24, seed=8, block_sparse=False)
    fwd = compat.compile(lambda x, ei: spmm(ei, x))
    outs = []
    with torch.inference_mode():
        for f in (24, 8, 24, 8, 24, 8, 24, 8):
            outs.append((f, fwd(x[:, :f].contiguous(), ei)))
        ref = {f: spmm(ei, x[:, :f].contiguous()) for f in (24, 8)}
    assert fwd.captures == 2 and fwd.replays == 4
    for f, out in outs:
        assert torch.equal(out, ref[f])
    assert outs[-2][1].data_ptr() != outs[-4][1].data_ptr()


def test_launches_per_replay_times_replays_is_the_eager_count(dev):
    """The wrappers count host calls: the warm-ups count, the capture and
    the replays do not; ``launches_per_replay`` times the replays makes up
    the rest, and equals the eager per-step count."""
    from pytorch_geometric_tpu_torch import compat
    ei, x, y = _gcn_case(dev, 1000, 30_000, 16, seed=6, block_sparse=True)

    def zero():
        for _, fn, attr in compat.launch_counters():
            setattr(fn, attr, 0)

    zero()
    _compiled_gcn_steps(dev, ei, x, y, False, 1)
    per_step = compat.launch_counts()
    assert per_step['bsr_spmm'] == 5 and per_step['segment_spmm'] == 5
    zero()
    _, _, step = _compiled_gcn_steps(dev, ei, x, y, True, 7)
    torch.cuda.synchronize()
    per_step = {k: v for k, v in per_step.items() if v}
    assert step.launches_per_replay == per_step
    assert step.replays == 5
    host = compat.launch_counts()
    for k, n in per_step.items():
        assert host[k] == 2 * n                    # the eager warm-ups
        assert step.replay_launches()[k] == 5 * n
        assert host[k] + step.replay_launches()[k] == 7 * n


def test_bsr_layout_without_order_raises_under_capture(dev):
    """A hand-built layout (no ``order``) runs eagerly, reading its row
    pointer on the host; under a capture it raises, naming fill_cache."""
    from pytorch_geometric_tpu_torch import compat
    coo, w, rng = _bsr_case(600, 600, 20_000, seed=9)
    fwd, _, _ = build_bsr_pair(coo, w, 600, 600, device=dev)
    bare = BSR(fwd.vals, fwd.cols, fwd.row_ptr)
    x = torch.as_tensor(rng.standard_normal((600, 16)).astype(np.float32),
                        device=dev)
    f = compat.compile(lambda x: bsr_matmul(bare, x, 600), warmup=1)
    assert torch.equal(f(x), bsr_matmul(fwd, x, 600))
    with pytest.raises(RuntimeError, match='fill_cache'):
        f(x)
    assert f.captures == 0
    # the card and the current stream are fine after the refused capture
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.equal(bsr_matmul(fwd, x, 600), bsr_matmul(fwd, x, 600))


def test_host_sync_inside_a_compiled_function_raises(dev):
    """``.item()`` waits for the card, which a capture forbids: the call
    raises, and nothing runs the function eagerly in its place."""
    from pytorch_geometric_tpu_torch import compat
    calls = []

    def f(x):
        calls.append(1)
        return x * x.sum().item()

    g = compat.compile(f, warmup=0)
    x = torch.ones(4, device=dev)
    with pytest.raises(RuntimeError):
        g(x)
    assert len(calls) == 1 and g.captures == 0 and g.replays == 0
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.ones(3, device=dev).sum().item() == 3.0


def test_gather_path_gradient_matches_plain_on_a_padded_batch(dev):
    """The gather path (a raw COO with an edge mask) on the card against
    the CPU plain path, on one padded batch of ``products_bench.py``'s
    loader (``chip_smoke.py``'s copy of its graph at 0.2 % of its size,
    sampled by the port's ``NeighborLoader``; batch 64, fan-outs [15, 10]).
    The card gathers messages with ``index_select``, whose backward adds
    with atomics, so the sums may come in another order on every run: loss
    within 1e-5 relative, each gradient within 1e-5 of its largest
    magnitude, on two runs."""
    import importlib.util
    from pathlib import Path
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.loader import NeighborLoader
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parent.parent / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    n, e = 4898, 247_436
    loader = NeighborLoader(Data(edge_index=smoke.products_graph(n, e, 0),
                                 num_nodes=n), [15, 10], batch_size=64,
                            shuffle=True, filter_features=False)
    b = next(iter(loader))
    node_mask, edge_mask = b.node_mask.numpy(), b.edge_mask.numpy()
    batch_size = int(b.batch_size)
    assert 0 < node_mask.mean() < 1 and 0 < edge_mask.mean() < 1
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((b.num_nodes, 32)).astype(np.float32)
         * node_mask[:, None])
    y = rng.integers(0, 7, batch_size)
    runs = []
    for d in ('cpu', dev, dev):
        model = GraphSAGE(32, 16, 2, 7, device=d,
                          generator=torch.Generator().manual_seed(0))
        out = model(torch.as_tensor(x, device=d),
                    b.edge_index.to(d, torch.int64),
                    edge_mask=torch.as_tensor(edge_mask, device=d))
        loss = torch.nn.functional.cross_entropy(
            out[:batch_size], torch.as_tensor(y, device=d))
        loss.backward()
        runs.append((loss.item(), [p.grad.cpu() for p in model.parameters()]))
    (ref_loss, ref), cards = runs[0], runs[1:]
    for got_loss, got in cards:
        assert abs(got_loss - ref_loss) <= 1e-5 * abs(ref_loss)
        for a, r in zip(got, ref):
            assert float((a - r).abs().max()) <= 1e-5 * float(
                r.abs().max()), (a - r).abs().max()


# -- the per-edge dot kernel (csrc/sddmm.cu) ----------------------------------
def _dot_case(dev, na, nb, e, h, f, seed, dtype=torch.float32):
    """Tables, indices with out-of-range entries on both sides (negative and
    past the end), and a mask."""
    g = torch.Generator(dev).manual_seed(seed)
    a = torch.randn(na, h, f, device=dev, generator=g).to(dtype)
    b = torch.randn(nb, h, f, device=dev, generator=g).to(dtype)
    ia = torch.randint(-2, na + 3, (e,), device=dev, generator=g)
    ib = torch.randint(-2, nb + 3, (e,), device=dev, generator=g)
    mask = torch.rand(e, device=dev, generator=g) < 0.85
    return a, b, ia, ib, mask


def _dot_close(out, a, b, ia, ib, mask, bf16=False):
    """Against the plain version on the same card tensors: 1e-5 + 1e-5 of
    the edge's sum of |a * b| terms (float32 sums in another order), one
    bf16 ulp more for the bf16 arm."""
    from pytorch_geometric_tpu_torch.ops.edge_dot import edge_dot_plain
    ref = edge_dot_plain(a, b, ia, ib, mask)
    scale = edge_dot_plain(a.float().abs(), b.float().abs(), ia, ib, mask)
    if bf16:
        _bf16_close(out, ref, scale)
    else:
        _close(out, ref, scale)
    return float((out.float() - ref.float()).abs().max()) if out.numel() \
        else 0.0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('h,f', [(4, 64), (4, 10), (1, 8), (1, 33), (8, 16),
                                 (2, 3), (1, 256)])
@pytest.mark.parametrize('index', [torch.int32, torch.int64])
def test_edge_dot_kernel_matches_plain(dev, dtype, h, f, index):
    """Every width the paths use (H*F = 256, 40, one head as 2-D tables) and
    odd ones; out-of-range indices and a mask give 0; one launch each."""
    from pytorch_geometric_tpu_torch.ops.edge_dot import edge_dot
    a, b, ia, ib, mask = _dot_case(dev, 700, 500, 9000, h, f, seed=h * f,
                                   dtype=dtype)
    ia, ib = ia.to(index), ib.to(index)
    bf16 = dtype == torch.bfloat16
    attr = 'launches_bf16' if bf16 else 'launches'
    before = getattr(edge_dot, attr)
    out = edge_dot(a, b, ia, ib, mask)
    torch.cuda.synchronize()
    assert getattr(edge_dot, attr) == before + 1
    assert out.shape == (9000, h) and out.dtype == dtype
    _dot_close(out, a, b, ia, ib, mask, bf16)
    bad = (ia < 0) | (ia >= 700) | (ib < 0) | (ib >= 500) | ~mask
    assert bad.any() and not out[bad].any()
    if h == 1:
        flat = edge_dot(a[:, 0], b[:, 0], ia, ib, mask)
        assert torch.equal(flat, out[:, 0])
    # the same bits on a second launch
    assert torch.equal(edge_dot(a, b, ia, ib, mask), out)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_edge_dot_strided_unaligned_and_refusals(dev, dtype):
    """Rows with their own stride (a column half of a wider table), a
    table 4 bytes past a 16-byte boundary, an empty edge list (no launch);
    a half tensor, mixed dtypes and a table on another device raise."""
    from pytorch_geometric_tpu_torch.ops.edge_dot import edge_dot
    a, b, ia, ib, mask = _dot_case(dev, 300, 300, 4000, 4, 16, seed=3,
                                   dtype=dtype)
    wide = torch.cat([b.view(300, 64), b.view(300, 64)], 1)
    out = edge_dot(a, wide[:, 64:].view(300, 4, 16), ia, ib, mask)
    _dot_close(out, a, b, ia, ib, mask, dtype == torch.bfloat16)
    flat = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(300, 4, 16)
    assert flat.data_ptr() % 16 != 0
    out = edge_dot(flat, b, ia, ib)
    _dot_close(out, flat, b, ia, ib, None, dtype == torch.bfloat16)
    before = edge_dot.launches + edge_dot.launches_bf16
    empty = edge_dot(a, b, ia[:0], ib[:0])
    assert empty.shape == (0, 4)
    assert edge_dot.launches + edge_dot.launches_bf16 == before
    with pytest.raises(TypeError, match='float32'):
        edge_dot(a.half(), b.half(), ia, ib)
    with pytest.raises(TypeError, match='float32'):
        edge_dot(a.float(), b.bfloat16(), ia, ib)
    with pytest.raises(ValueError, match='is on cpu'):
        edge_dot(a, b.cpu(), ia, ib)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('h,f', [(4, 64), (4, 10), (6, 16), (1, 256),
                                 (2, 33)])
@pytest.mark.parametrize('order', ['edge', 'slot'])
def test_edge_dot_bitwise_across_slice_widths(dev, dtype, h, f, order):
    """Every slice shape the tree arm takes (``dot_slice_widths``: whole
    heads, a divisor of H, then one head in 2, 4, ... column slices, whose
    partials a second pass sums) gives the same bits as one slice of every
    head, in edge order (both sides random) and slot order (``ib`` sorted);
    each call counts one launch, and one combine pass where it is cut into
    column slices; the runs arm (``runs=True``) at every width of whole
    heads, bitwise equal among them and within the limits; the wrapper's
    own choice (the runs arm for heads of at most 16 elements) one of the
    two; a width that does not tile the heads, or a shape the kernel does
    not take, raises."""
    from pytorch_geometric_tpu_torch.ops.edge_dot import (dot_slice_widths,
                                                          dot_vec, edge_dot)
    a, b, ia, ib, mask = _dot_case(dev, 900, 700, 20_000, h, f, seed=h + f,
                                   dtype=dtype)
    if order == 'slot':
        ib = torch.sort(ib).values
    ref = edge_dot(a, b, ia, ib, mask, slice_heads=h, runs=False)
    _dot_close(ref, a, b, ia, ib, mask, dtype == torch.bfloat16)
    widths = dot_slice_widths(h, f, dot_vec(a, b, f, h * f, h * f))
    assert any(cs > 1 for _, cs in widths)
    arm = 'launches_bf16' if dtype == torch.bfloat16 else 'launches'
    for hs, cs in widths:
        n, nc = getattr(edge_dot, arm), edge_dot.launches_combine
        assert torch.equal(edge_dot(a, b, ia, ib, mask, slice_heads=hs,
                                    col_slices=cs, runs=False), ref), (hs, cs)
        assert getattr(edge_dot, arm) == n + 1
        assert edge_dot.launches_combine == nc + (cs > 1), (hs, cs)
    runs = edge_dot(a, b, ia, ib, mask, slice_heads=h, runs=True)
    _dot_close(runs, a, b, ia, ib, mask, dtype == torch.bfloat16)
    for hs in range(1, h + 1):
        if h % hs == 0:
            assert torch.equal(edge_dot(a, b, ia, ib, mask, slice_heads=hs,
                                        runs=True), runs), hs
    assert torch.equal(edge_dot(a, b, ia, ib, mask, runs=True), runs)
    assert torch.equal(edge_dot(a, b, ia, ib, mask),
                       runs if f <= 16 else ref)
    with pytest.raises(ValueError, match='does not tile'):
        edge_dot(a, b, ia, ib, slice_heads=h + 1)
    with pytest.raises(ValueError, match='is not one of|whole'):
        edge_dot(a, b, ia, ib, slice_heads=1, col_slices=3)


@pytest.mark.parametrize('f,na,e', [(1024, 300_000, 700_000),
                                    (40_000, 60, 3000)])
def test_edge_dot_wide_heads_launch(dev, f, na, e):
    """A head too wide for the L2 at any slice the tree arm takes (one head
    of 1,024 floats over two 300,000-row tables read by 700,000 edges) runs
    at the narrowest shape the kernel takes, 64 column slices; a head too
    wide for the tree arm at all (40,000 floats) takes the runs arm, which
    reads it in chunks; both within the limits of the plain version."""
    from pytorch_geometric_tpu_torch.ops.edge_dot import (
        MAX_COL_SLICES, dot_plan, dot_slice_widths, dot_vec, edge_dot)
    a, b, ia, ib, mask = _dot_case(dev, na, na, e, 1, f, seed=f % 97)
    vec = dot_vec(a, b, f, f, f)
    l2 = torch.cuda.get_device_properties(a.device).L2_cache_size
    plan = dot_plan(na, na, e, 1, f, vec, 4, l2)
    widths = dot_slice_widths(1, f, vec)
    if f == 1024:
        assert plan == widths[-1] == (1, MAX_COL_SLICES)
    else:
        assert plan is None and widths == []
    n, nc = edge_dot.launches, edge_dot.launches_combine
    out = edge_dot(a, b, ia, ib, mask)
    assert edge_dot.launches == n + 1
    assert edge_dot.launches_combine == nc + (f == 1024)
    _dot_close(out, a, b, ia, ib, mask)
    del a, b
    torch.cuda.empty_cache()


def test_gat_mix_grad_p_u_on_the_dot_kernel(dev):
    """``_GatMix``'s backward: ``grad_p_u`` is one launch of the dot kernel
    over the slot order and agrees with the plain dot ``<v[src], gu[dst]>``
    (0 on padded slots)."""
    from pytorch_geometric_tpu_torch.ops.gat_fused import _GatMix
    from pytorch_geometric_tpu_torch.ops.edge_dot import (edge_dot,
                                                          edge_dot_plain)
    ei = _slots(300, 400, 5000, dev, seed=21)
    blk, blk_t = ei.blocked, ei.blocked_t
    g = torch.Generator(dev).manual_seed(0)
    e = blk.src.shape[0]
    p = torch.rand(e, 4, device=dev, generator=g).requires_grad_()
    v = torch.randn(300, 4, 16, device=dev, generator=g)
    gu = torch.randn(400, 4, 16, device=dev, generator=g)
    s, u = _GatMix.apply(p, p, v, blk, blk_t, 400)
    before = edge_dot.launches
    (u * gu).sum().backward()
    torch.cuda.synchronize()
    assert edge_dot.launches == before + 1
    ref = edge_dot_plain(v, gu, blk.src, blk.dst)
    scale = edge_dot_plain(v.abs(), gu.abs(), blk.src, blk.dst)
    _close(p.grad, ref, scale)
    assert not p.grad[blk.dst >= 400].any()


def test_softmax_edge_index_route_on_card(dev, monkeypatch):
    """``ops.softmax(edge_index=...)`` over cached slot orders on the card
    runs ``edge_softmax`` (the mix kernel's ``s``-only passes) and agrees
    with the plain route on the CPU; with the kernel knob off it raises,
    as the convs' fused branch does, and launches nothing."""
    from pytorch_geometric_tpu_torch.ops import softmax
    coo, _, _ = _case(400, 400, 6000, 1, seed=24)
    ei = EdgeIndex(coo, (400, 400), device=dev).fill_cache(blocked=True)
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(coo.shape[1], 4, generator=g)
    index = torch.as_tensor(coo[1]).long().clamp(max=399)
    valid = torch.as_tensor(coo[1] < 400)
    ref = softmax(logits, index, 400, mask=valid)
    before = gat_mix.launches
    out = softmax(logits.to(dev), index.to(dev), 400, mask=valid.to(dev),
                  edge_index=ei)
    assert gat_mix.launches > before
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-5)
    monkeypatch.setattr(backend, 'use_kernel_spmm', False)
    before = gat_mix.launches
    with pytest.raises(RuntimeError, match='use_kernel_spmm'):
        softmax(logits.to(dev), index.to(dev), 400, mask=valid.to(dev),
                edge_index=ei)
    assert gat_mix.launches == before


def _transformer(dev, seed=0):
    from pytorch_geometric_tpu_torch.nn.conv import TransformerConv
    gen = torch.Generator().manual_seed(seed)
    return torch.nn.ModuleList([
        TransformerConv(16, 8, heads=4, beta=True, device=dev, generator=gen),
        TransformerConv(32, 10, heads=4, concat=False, beta=True, device=dev,
                        generator=gen)])


def _transformer_fwd(convs, x, ei):
    return convs[1](torch.relu(convs[0](x, ei)), ei)


def _named_results(out, x, module):
    res = {'out': out.detach().cpu(), 'grad x': x.grad.cpu()}
    res.update({k: p.grad.cpu() for k, p in module.named_parameters()})
    return res


def _results_close(got, ref):
    """Each tensor within 1e-4 of its largest magnitude; a key bias's
    gradient, which the softmax cancels exactly (it shifts every score of a
    destination alike) and is rounding noise on both devices, within 1e-4
    of the largest gradient."""
    largest = max(float(r.abs().max()) for k, r in ref.items() if k != 'out')
    for k, r in ref.items():
        scale = largest if k.endswith('lin_key.bias') else float(
            r.abs().max())
        torch.testing.assert_close(got[k], r, rtol=0, atol=1e-4 * scale,
                                   msg=k)


def test_transformer_conv_on_card_matches_cpu(dev):
    """Two fused TransformerConv layers (H*F = 32, then 40) on the card
    against the CPU: the output and every gradient; per forward one dot
    launch and two mix launches a layer, per backward two mix launches
    (``sddmm``'s) and one dot launch (``grad_p_u``) a layer and ``grad_v``;
    with the kernel knob off the card raises."""
    from pytorch_geometric_tpu_torch.ops.edge_dot import edge_dot
    coo, _, x = _case(600, 600, 9000, 16, seed=22, n_pad=6)
    res = []
    for d in (dev, 'cpu'):
        convs = _transformer(d)
        ei = EdgeIndex(coo, (600, 600), device=d).fill_cache(blocked=True)
        xt = torch.as_tensor(x, device=d).requires_grad_()
        b_dot, b_mix = edge_dot.launches, gat_mix.launches
        out = _transformer_fwd(convs, xt, ei)
        if d == dev:
            assert (edge_dot.launches - b_dot, gat_mix.launches - b_mix) == \
                (2, 4)
        out.square().sum().backward()
        if d == dev:
            assert (edge_dot.launches - b_dot, gat_mix.launches - b_mix) == \
                (4, 10)
        res.append(_named_results(out, xt, convs))
    _results_close(*res)
    import pytorch_geometric_tpu_torch.backend as be
    be.use_kernel_spmm = False
    try:
        with pytest.raises(RuntimeError, match='use_kernel_spmm'):
            _transformer_fwd(_transformer(dev), torch.as_tensor(x, device=dev),
                             EdgeIndex(coo, (600, 600),
                                       device=dev).fill_cache(blocked=True))
    finally:
        be.use_kernel_spmm = True


@pytest.mark.parametrize('conv', ['transformer-wide', 'supergat-MX',
                                  'supergat-SD-fused'])
def test_attention_convs_on_card_match_cpu(dev, conv):
    """TransformerConv's wide branch (no slot orders) and SuperGATConv (MX
    with self loops; SD fused) on the card against the CPU, output and
    gradients at 1e-4 of the largest."""
    from pytorch_geometric_tpu_torch.nn.conv import (SuperGATConv,
                                                     TransformerConv)
    coo, _, x = _case(500, 500, 8000, 16, seed=23, n_pad=4)
    res = []
    for d in (dev, 'cpu'):
        gen = torch.Generator().manual_seed(1)
        if conv == 'transformer-wide':
            m = TransformerConv(16, 8, heads=4, beta=True, device=d,
                                generator=gen)
            ei = EdgeIndex(coo, (500, 500), device=d)
        else:
            att = conv.split('-')[1]
            loops = conv == 'supergat-MX'
            m = SuperGATConv(16, 8, heads=4, attention_type=att,
                             add_self_loops=loops, device=d, generator=gen)
            ei = EdgeIndex(coo, (500, 500), device=d).fill_cache(blocked=True)
        xt = torch.as_tensor(x, device=d).requires_grad_()
        out = m(xt, ei)
        out.square().sum().backward()
        res.append(_named_results(out, xt, m))
    _results_close(*res)


def test_captured_transformer_step_equals_eager_bitwise(dev):
    """Five training steps of the fused TransformerConv stack through
    ``compat.compile`` (two eager warm-ups, the capture, two replays) take
    the eager steps bit for bit; the graph holds the eager per-step
    launches of both kernels, dot and mix."""
    from pytorch_geometric_tpu_torch import compat
    coo, _, x = _case(800, 800, 12_000, 16, seed=24, n_pad=0)
    y = torch.as_tensor(np.random.default_rng(0).integers(0, 10, 800),
                        device=dev)
    ei = EdgeIndex(coo, (800, 800), device=dev).fill_cache(blocked=True)
    xt = torch.as_tensor(x, device=dev)
    runs = []
    for compiled in (False, True):
        convs = _transformer(dev)
        opt = torch.optim.Adam(convs.parameters(), lr=1e-2, capturable=True)

        def step(x, ei, y):
            opt.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(
                _transformer_fwd(convs, x, ei), y)
            loss.backward()
            opt.step()
            return loss.detach()

        if compiled:
            step = compat.compile(step)
        losses = torch.stack([step(xt, ei, y) for _ in range(5)])
        runs.append((losses, [p.detach().clone() for p in
                              convs.parameters()], step))
    (l_e, p_e, _), (l_c, p_c, comp) = runs
    assert comp.captures == 1 and comp.replays == 3
    assert torch.equal(l_c, l_e), (l_c, l_e)
    for a, b in zip(p_c, p_e):
        assert torch.equal(a, b)
    assert comp.launches_per_replay == {'edge_dot': 4, 'gat_mix': 10}
    assert comp.replay_launches() == {'edge_dot': 12, 'gat_mix': 30}


# -- the flash kernels (csrc/flash_softmax.cu) -----------------------------------
def _flash_case(dev, form, h, c, n_src=300, n_dst=200, e=6000, n_rel=2,
                seed=0):
    """A bipartite case: empty rows, one destination with a third of the
    edges (split into many pieces), invalid edges (``d = n_dst`` and
    ``n_dst + 3``); 2 relations for the dot form."""
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    rng = np.random.default_rng(seed)
    rows = rng.choice(n_dst, n_dst // 2, replace=False)
    d = rows[rng.integers(0, len(rows), e)]
    d[: e // 3] = rows[0]
    d[-20:-10], d[-10:] = n_dst, n_dst + 3
    s = rng.integers(0, n_src, e)
    sw = h if form == 'gat' else h * c
    g = torch.Generator(device=dev).manual_seed(seed)
    src_tab = torch.randn(n_src, sw, device=dev, generator=g)
    dst_tab = torch.randn(n_dst, sw, device=dev, generator=g)
    val = (src_tab if form == 'gatv2' else
           torch.randn(n_src, h * c, device=dev, generator=g))
    extra = rel = None
    if form == 'gatv2':
        extra = torch.randn(h * c, device=dev, generator=g)
    if form == 'dot':
        extra = torch.rand(n_rel, h, device=dev, generator=g) + 0.2
        rel = torch.as_tensor(rng.integers(0, n_rel, e), device=dev)
    ops = fs.FlashOperands(form, h, src_tab, dst_tab, val, extra, 0.2)
    return (ops, torch.as_tensor(s, device=dev),
            torch.as_tensor(d, device=dev), rel, n_dst)


FLASH_SHAPES = [(form, h, c) for form in ('gat', 'gatv2', 'dot')
                for h, c in ((1, 1), (4, 10), (8, 16), (1, 47), (4, 64))]


@pytest.mark.parametrize('form,h,c', FLASH_SHAPES)
def test_flash_kernels_match_plain(dev, form, h, c):
    """Kernels (a), (b) and (c) against the plain versions on the same card
    tensors (forward within 1e-5 of the largest output, gradients within
    1e-4 of each one's largest), and two launches bitwise equal."""
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    ops, s, d, rel, nd = _flash_case(dev, form, h, c)
    plan = fs.dst_plan(s, d, rel, nd, False, split=64)
    plan_t = fs.src_plan(s, d, rel, nd, ops.src_tab.shape[0], split=64)
    out, m, l = fs.flash_forward(ops, s, d, rel, nd, 1000, plan)
    ref = fs.flash_forward_plain(ops, s, d, rel, nd, 1000)
    torch.cuda.synchronize()
    scale = max(float(ref[0].abs().max()), 1.0)
    assert float((out - ref[0]).abs().max()) <= 1e-5 * scale
    assert torch.equal(torch.isinf(m), torch.isinf(ref[1]))
    assert torch.equal(out, fs.flash_forward(ops, s, d, rel, nd, 1000,
                                             plan)[0])
    gcot = torch.randn_like(out)
    got = fs.flash_backward(ops, s, d, rel, nd, 1000, m, l, out, gcot, plan,
                            plan_t)
    want = fs.flash_backward_plain(ops, s, d, rel, nd, 1000, ref[1], ref[2],
                                   ref[0], gcot)
    again = fs.flash_backward(ops, s, d, rel, nd, 1000, m, l, out, gcot,
                              plan, plan_t)
    for a, b, c2 in zip(got, want, again):
        assert (a is None) == (b is None)
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-4 * max(
                float(b.abs().max()), 1e-30)
            assert torch.equal(a, c2)


def _flash_f64(fs, ops, s, d, rel, nd, gcot):
    """The float64 plain backward and its terms' magnitudes, from the
    float64 plain forward of the same float32 inputs."""
    src64 = ops.src_tab.double()
    ops64 = ops._replace(
        src_tab=src64, dst_tab=ops.dst_tab.double(),
        val=src64 if ops.form == 'gatv2' else ops.val.double(),
        extra=None if ops.extra is None else ops.extra.double())
    ref = fs.flash_forward_plain(ops64, s, d, rel, nd, 10_000)
    args = (ops64, s, d, rel, nd, 10_000, ref[1], ref[2], ref[0],
            gcot.double())
    return ref, fs.flash_backward_plain(*args), fs.flash_backward_plain(
        *args, abs_terms=True)


# (H, C): the 16-byte arm where C % 4 = 0 (16, 48, 64, 512, 12, 40, 8,
# 32), floats elsewhere (47, 5, 6, 10, 33, 100 is 16-byte), all heads a
# warp and one head a warp (C > 128 on 16 bytes, > 32 on floats)
FLASH_ARMS = [(form, h, c) for form in ('gat', 'gatv2', 'dot')
              for h, c in ((4, 16), (1, 47), (1, 48), (4, 64), (1, 512),
                           (3, 12), (2, 40), (8, 8), (2, 32), (4, 5), (2, 6),
                           (4, 10), (1, 33), (2, 100), (1, 160), (8, 16),
                           (1, 1))]


@pytest.mark.parametrize('form,h,c', FLASH_ARMS)
def test_flash_backward_arms_match_float64(dev, form, h, c):
    """Kernels (a), (b) and (c) at their chosen team shapes: 16-byte loads
    where C % 4 = 0, floats elsewhere; a hub row of 2,000 edges (over 3 x
    FLASH_SPLIT_EDGES, 4 pieces), empty rows, invalid edges, 3 relations
    for the dot form. Held against the float64 plain versions within
    PERF.md's limits (the output 1e-5 of max(1, its largest); each gradient
    entry 1e-4 of the gradient's largest plus 1e-5 of its terms'
    magnitudes), the record (m, l, gdot, a_dst) against m, l, <g, out>
    (1e-5 plus 1e-5 of the sum of |g out|) and a_dst, and two launches of
    each bitwise equal."""
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    ops, s, d, rel, nd = _flash_case(dev, form, h, c, n_rel=3, seed=c + h)
    hub = int(torch.bincount(d.clamp(max=nd)).max())
    assert hub > 3 * fs.FLASH_SPLIT_EDGES
    plan = fs.dst_plan(s, d, rel, nd, False)
    plan_t = fs.src_plan(s, d, rel, nd, ops.src_tab.shape[0])
    out, m, l = fs.flash_forward(ops, s, d, rel, nd, 1000, plan)
    gcot = torch.randn_like(out)
    vec = 4 if c % 4 == 0 else 1
    for k, rows in (('fwd', (out,)), ('dst', (gcot, out)), ('src', (gcot,))):
        assert fs.kernel_shape(ops, k, *rows) == fs.team_shape(h, c, vec, k)
    runs = []
    for _ in range(2):
        fwd = fs.flash_forward(ops, s, d, rel, nd, 1000, plan)
        rec, d_dst, d_extra = fs.flash_backward_dst(ops, m, l, out, gcot,
                                                    plan)
        d_src, d_val = fs.flash_backward_src(ops, gcot, rec, plan_t)
        runs.append((*fwd, rec, d_src, d_dst, d_val, d_extra))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], out)
    for a, b in zip(*runs):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    rec, *got = runs[0][3:]
    ref, want, terms = _flash_f64(fs, ops, s, d, rel, nd, gcot)
    assert float((out.double() - ref[0]).abs().max()) <= 1e-5 * max(
        1.0, float(ref[0].abs().max()))
    assert torch.equal(torch.isinf(m), torch.isinf(ref[1]))
    assert torch.equal(rec[..., 0], m) and torch.equal(rec[..., 1], l)
    prod = (gcot.double() * out.double()).view(nd, h, c)
    assert bool(((rec[..., 2].double() - prod.sum(-1)).abs()
                 <= 1e-5 * (1 + prod.abs().sum(-1))).all())
    assert torch.equal(rec[..., 3], ops.dst_tab if form == 'gat'
                       else torch.zeros_like(rec[..., 3]))
    for name, a, b, t in zip(('d_src', 'd_dst', 'd_val', 'd_extra'), got,
                             want, terms):
        assert (a is None) == (b is None), name
        if a is not None:
            lim = 1e-4 * max(float(b.abs().max()), 1e-30) + 1e-5 * t
            assert float(((a.double() - b).abs() / lim).max()) <= 1.0, name


@pytest.mark.parametrize('form', ['gat', 'gatv2', 'dot'])
@pytest.mark.parametrize('c', [16, 5, 47])
def test_flash_route_pads_heads_to_16_bytes(dev, form, c):
    """The public flash route on the card: heads of C % 4 != 0 columns reach
    kernels (a), (b) and (c) padded to a multiple of 4, on the 16-byte arm
    (as C % 4 = 0 does unpadded), and the output and every input's
    gradient, sliced back to C, match the float64 plain versions on the
    unpadded tables within the kernels' limits; two calls bitwise equal."""
    from pytorch_geometric_tpu_torch.ops import edge_attention as ea
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    ops, s, d, rel, nd = _flash_case(dev, form, 2, c, n_rel=1, seed=c)
    rel = None if rel is None else torch.zeros_like(rel)
    gcot = torch.randn(nd, 2 * c, device=dev,
                       generator=torch.Generator(dev).manual_seed(2))
    seen, orig = [], fs.kernel_shape

    def spy(o, kernel, *rows):
        shape = orig(o, kernel, *rows)
        seen.append((kernel, o.columns, shape.vec))
        return shape

    fs.kernel_shape = spy
    try:
        runs = [_route(ea, ops, s, d, nd, gcot) for _ in range(2)]
    finally:
        fs.kernel_shape = orig
    cp = -(-c // 4) * 4
    assert sorted(set(seen)) == [(k, cp, 4) for k in ('dst', 'fwd', 'src')]
    (out, grads), (out2, grads2) = runs
    assert torch.equal(out, out2)
    ref, want, terms = _flash_f64(fs, ops, s, d, None if rel is None else
                                  rel, nd, gcot)
    assert float((out.double() - ref[0]).abs().max()) <= 1e-5 * max(
        1.0, float(ref[0].abs().max()))
    for name, a, a2, b, t in zip(('d_src', 'd_dst', 'd_val', 'd_extra'),
                                 grads, grads2, want, terms):
        if b is None:
            continue
        assert torch.equal(a, a2), name
        a = a.double().reshape(b.shape)
        lim = 1e-4 * max(float(b.abs().max()), 1e-30) + 1e-5 * t
        assert float(((a - b).abs() / lim).max()) <= 1.0, name


def _route(ea, ops, s, d, nd, gcot):
    """The public flash route of ``ops``' form under autograd on leaf
    copies of its tables: the output ``[nd, H C]`` and the gradients in
    ``flash_backward``'s order (None where the form has no such table)."""
    h, c = ops.heads, ops.columns

    def leaf(t):
        return t.detach().clone().requires_grad_()

    src, dst = leaf(ops.src_tab), leaf(ops.dst_tab)
    if ops.form == 'gat':
        val = leaf(ops.val)
        out = ea.gat_flash_attention(src, dst, val.view(-1, h, c), s, d, nd,
                                     ops.slope)
        leaves = (src, dst, val, None)
    elif ops.form == 'gatv2':
        att = leaf(ops.extra)
        out = ea.gatv2_flash_attention(src.view(-1, h, c), dst.view(-1, h, c),
                                       att.view(h, c), s, d, nd, ops.slope)
        leaves = (src, dst, None, att)
    else:
        val, p = leaf(ops.val), leaf(ops.extra[0])
        out = ea.hetero_edge_attention_multi(
            [src.view(-1, h, c)], [val.view(-1, h, c)], dst.view(-1, h, c),
            [p], [s], [d], nd, layout=ea.build_union_flash_layout(
                [s.cpu().numpy()], [d.cpu().numpy()], [src.shape[0]], nd,
                device=s.device))
        leaves = (src, dst, val, p)
    out.backward(gcot.view(out.shape))
    return (out.detach().reshape(nd, -1),
            [None if t is None else t.grad.reshape(
                t.shape[0], -1) if t.dim() > 1 else t.grad for t in leaves])


@pytest.mark.parametrize('form', ['gat', 'gatv2', 'dot'])
def test_flash_backward_picks_float_loads_for_unaligned_rows(dev, form):
    """Tables whose rows are 37 floats apart (C = 16 columns read in place)
    take the float arm, and match the 16-byte arm on a contiguous copy
    within the float64 limits; a 16-byte shape forced on them is refused
    by the kernel, never run."""
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    ops, s, d, rel, nd = _flash_case(dev, form, 2, 16, n_rel=3, seed=7)

    def strided(t):
        if t.dim() != 2 or t.shape[1] < 4:
            return t
        wide = torch.zeros(t.shape[0], 37, device=dev)
        wide[:, :t.shape[1]] = t
        return wide[:, :t.shape[1]]

    src = strided(ops.src_tab)
    ops_s = ops._replace(src_tab=src, dst_tab=strided(ops.dst_tab),
                         val=src if form == 'gatv2' else strided(ops.val))
    plan = fs.dst_plan(s, d, rel, nd, False)
    plan_t = fs.src_plan(s, d, rel, nd, ops.src_tab.shape[0])
    out, m, l = fs.flash_forward(ops, s, d, rel, nd, 1000, plan)
    gcot = torch.randn_like(out)
    assert fs.kernel_shape(ops_s, 'dst', gcot, out).vec == 1
    assert fs.kernel_shape(ops_s, 'fwd', out).vec == 1
    assert fs.kernel_shape(ops, 'dst', gcot, out).vec == 4
    _, want, terms = _flash_f64(fs, ops, s, d, rel, nd, gcot)
    got = fs.flash_backward(ops_s, s, d, rel, nd, 1000, m, l, out, gcot,
                            plan, plan_t)
    for name, a, b, t in zip(('d_src', 'd_dst', 'd_val', 'd_extra'), got,
                             want, terms):
        if b is not None:
            lim = 1e-4 * max(float(b.abs().max()), 1e-30) + 1e-5 * t
            assert float(((a.double() - b).abs() / lim).max()) <= 1.0, name
    out_s = fs.flash_forward(ops_s, s, d, rel, nd, 1000, plan)[0]
    assert float((out_s - out).abs().max()) <= 1e-5 * max(
        1.0, float(out.abs().max()))
    # a 16-byte shape forced on them is refused by each kernel, never run
    for kernel, symbol, rows in (
            ('fwd', 'pgt_flash_fwd', dict(m=m, l=l, out=torch.empty_like(
                out))),
            ('dst', 'pgt_flash_bwd_dst', dict(
                m=m, l=l, out=out, g=gcot, rec=torch.empty(nd, 2, 4,
                                                           device=dev),
                d_row=torch.empty_like(ops_s.dst_tab.contiguous()),
                d_glob=torch.empty(1000, 64, device=dev))),
            ('src', 'pgt_flash_bwd_src', dict(
                g=gcot, rec=torch.empty(nd, 2, 4, device=dev),
                d_row=torch.empty(ops.src_tab.shape, device=dev),
                d_val=torch.empty(ops.val.shape, device=dev)))):
        p = plan_t if kernel == 'src' else plan
        (ps, ps2, pv, pv2), tickets = fs._scratch(p, 2, 32, out, 2)
        args = fs._args(ops_s, p, fs.team_shape(2, 16, 4, kernel),
                        tickets=tickets, part_s=ps, part_s2=ps2, part_v=pv,
                        part_v2=pv2, **rows)
        with pytest.raises(RuntimeError, match='launch failed'):
            fs._launch(symbol, args, dev, kernel)


def test_flash_kernels_refuse_bf16(dev):
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    ops, s, d, rel, nd = _flash_case(dev, 'gat', 2, 8)
    ops = ops._replace(val=ops.val.bfloat16())
    plan = fs.dst_plan(s, d, rel, nd, False)
    with pytest.raises(NotImplementedError, match='Queue 1'):
        fs.flash_forward(ops, s, d, rel, nd, 1000, plan)


@pytest.mark.parametrize('conv', ['gat', 'gatv2', 'transformer'])
def test_flash_convs_on_card_match_cpu(dev, conv, monkeypatch):
    """Each conv's flash branch (forced with ``PGT_ATTN_WIDE_BYTES = 0``,
    default self loops) on the card against the CPU from the same weights:
    output and parameter gradients within 1e-4 of their largest."""
    from pytorch_geometric_tpu_torch.nn.conv import TransformerConv
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', '0')
    coo, _, x = _case(500, 500, 8000, 12, seed=31, n_pad=0)
    cls = {'gat': GATConv, 'gatv2': GATv2Conv,
           'transformer': TransformerConv}[conv]
    mods = [cls(12, 16, heads=4, device=d,
                generator=torch.Generator().manual_seed(0))
            for d in ('cpu', dev)]
    res = []
    fs.flash_forward.launches = 0
    for mod, d in zip(mods, ('cpu', dev)):
        out = mod(torch.as_tensor(x, device=d), torch.as_tensor(coo,
                                                                device=d))
        out.square().sum().backward()
        res.append((out.detach().cpu(), {k: p.grad.cpu()
                                         for k, p in mod.named_parameters()}))
    assert fs.flash_forward.launches == 1
    (o_cpu, g_cpu), (o_card, g_card) = res
    assert float((o_card - o_cpu).abs().max()) <= 1e-4 * float(
        o_cpu.abs().max())
    largest = max(float(g.abs().max()) for g in g_cpu.values())
    for k, g in g_cpu.items():
        scale = largest if k == 'lin_key.bias' else float(g.abs().max())
        assert float((g_card[k] - g).abs().max()) <= 1e-4 * scale, k


# -- the sampled path: loaders, the kernel route, layer-wise inference -------
def _sampled_case(seed, n=3000, e=30000, f=100, classes=7):
    """A random graph, features and labels, and a NeighborLoader's first
    batches (batch 64, fan-outs [5, 3], structure only)."""
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.loader import NeighborLoader
    rng = np.random.default_rng(seed)
    coo = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, classes, n)
    loader = NeighborLoader(Data(edge_index=coo, num_nodes=n), [5, 3],
                            batch_size=64, shuffle=True, seed=seed,
                            filter_features=False)
    it = iter(loader)
    return x, y, [next(it) for _ in range(4)]


def _sage(dev, f=100, classes=7):
    return GraphSAGE(f, 32, 2, classes, device=dev,
                     generator=torch.Generator().manual_seed(0))


def test_batch_edge_index_builds_inside_a_capture(dev):
    """The kernel route's step body (the batch's EdgeIndex: a where, two
    sorts, two searchsorteds) captures into a CUDA graph, its replays
    launch kernel 1 three times, and they follow the eager steps bit for
    bit (kernel 1 adds without atomics)."""
    from pytorch_geometric_tpu_torch.loader import (make_device_train_step,
                                                    stack_batches)
    x, y, batches = _sampled_case(1)
    X, Y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    stacked = stack_batches(batches, device=dev)
    rows = [{k: v[i] for k, v in stacked.items()} for i in range(4)]
    losses, states = [], []
    for compiled in (False, True):
        model = _sage(dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2, capturable=True)
        step_fn, _ = make_device_train_step(model, opt)
        step = step_fn if compiled else step_fn.__wrapped__
        losses.append(torch.stack([step(X, Y, rows[i % 4])
                                   for i in range(6)]))
        states.append([p.detach().clone() for p in model.parameters()])
    assert step_fn.captures == 1 and step_fn.replays == 4
    assert step_fn.launches_per_replay == {'segment_spmm': 3}
    assert torch.equal(losses[0], losses[1])
    assert all(torch.equal(a, b) for a, b in zip(*states))


def test_segment_kernel_at_sampled_width_100(dev):
    """Kernel 1 at F = 100 (25 vectors of 4 over 32 lanes) on a sampled
    batch's CSC, padded slots included, against its plain version."""
    from pytorch_geometric_tpu_torch.loader.scan_train import \
        batch_edge_index
    x, _, batches = _sampled_case(2)
    b = batches[0]
    ei = batch_edge_index(b.edge_index.to(dev), b.edge_mask.to(dev),
                          b.num_nodes)
    rows = torch.as_tensor(x, device=dev)[b.n_id.to(dev).long()]
    csc = ei.csc
    out = segment_spmm(csc.indptr, csc.indices, None, rows)
    ref = segment_spmm_plain(csc.indptr.cpu(), csc.indices.cpu(), None,
                             rows.cpu())
    scale = segment_spmm_plain(csc.indptr.cpu(), csc.indices.cpu(), None,
                               rows.cpu().abs())
    assert bool(((out.cpu() - ref).abs() <= 1e-5 + 1e-5 * scale).all())


def test_kernel_route_matches_gather_route_on_card(dev):
    """From the same weights, one step per batch on each route, on the
    card: losses within 1e-5 relative, gradients within 1e-4 of each
    tensor's largest (the gather route adds with atomics)."""
    from pytorch_geometric_tpu_torch.loader import (make_device_train_step,
                                                    stack_batches)
    from pytorch_geometric_tpu_torch.loader.scan_train import \
        gather_cross_entropy

    x, y, batches = _sampled_case(3)
    X, Y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    stacked = stack_batches(batches, device=dev)
    for i in range(4):
        b = {k: v[i] for k, v in stacked.items()}
        runs = []
        for loss_fn in (None, gather_cross_entropy):
            model = _sage(dev)
            opt = torch.optim.Adam(model.parameters(), lr=1e-2)
            step_fn, _ = make_device_train_step(model, opt, loss_fn)
            loss = step_fn.__wrapped__(X, Y, b)
            runs.append((float(loss), {k: p.grad.clone()
                                       for k, p in model.named_parameters()}))
        (lk, gk), (lg, gg) = runs
        assert abs(lk - lg) <= 1e-5 * abs(lg)
        for k in gg:
            assert float((gk[k] - gg[k]).abs().max()) <= 1e-4 * float(
                gg[k].abs().max()), k


def test_prefetch_upload_intact_under_a_running_replay(dev):
    """PrefetchLoader uploads through pinned buffers on its copy stream
    while captured work runs on the consumer's stream: every batch arrives
    equal to its host copy, in order, plain and threaded, and a replay fed
    by it reads the uploaded values."""
    from pytorch_geometric_tpu_torch import compat
    from pytorch_geometric_tpu_torch.loader import PrefetchLoader
    rng = np.random.default_rng(4)
    host = [{'a': torch.from_numpy(rng.standard_normal((512, 256)).astype(
        np.float32)), 'b': torch.from_numpy(rng.integers(0, 9, 70000)),
        'm': torch.from_numpy(rng.random(333) < 0.5)} for _ in range(12)]
    w = torch.randn(256, 256, device=dev)

    @compat.compile
    def busy(a):
        for _ in range(40):
            a = torch.tanh(a @ w)
        return a.sum()

    for threads in (0, 1):
        seen = 0
        for got, ref in zip(PrefetchLoader(host, device=dev,
                                           num_threads=threads), host):
            assert got['a'].is_cuda and got['a'].dtype == torch.float32
            out = busy(got['a'])
            expect = busy.__wrapped__(ref['a'].to(dev))
            assert torch.equal(out, expect)
            for k in ref:
                assert torch.equal(got[k].cpu(), ref[k]), k
            seen += 1
        assert seen == len(host)
    assert busy.replays > 0


def test_layerwise_inference_on_card_matches_cpu(dev):
    """``basic_gnn_inference`` on the card (kernel 1 twice a batch) against
    the same model on the CPU, on a cut graph: within 1e-4 of the largest
    magnitude."""
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.nn.models import basic_gnn_inference
    from pytorch_geometric_tpu_torch.ops.segment_spmm import segment_spmm \
        as seg
    rng = np.random.default_rng(5)
    n = 2000
    coo = np.stack([rng.integers(0, n, 20000), rng.integers(0, n, 20000)])
    x = rng.standard_normal((n, 100)).astype(np.float32)
    outs = []
    seg.launches = 0
    for d in ('cpu', dev):
        model = _sage(d)
        outs.append(basic_gnn_inference(
            model, Data(x=x, edge_index=coo, num_nodes=n), batch_size=256,
            num_neighbors_per_layer=8).cpu())
    assert seg.launches == 2 * -(-n // 256)
    ref = outs[0]
    assert float((outs[1] - ref).abs().max()) <= 1e-4 * float(
        ref.abs().max())


# -- heterogeneous graphs --------------------------------------------------------
HETERO_NODES = {'paper': 300, 'author': 420, 'institution': 20, 'field': 60}
HETERO_RELS = {('author', 'writes', 'paper'): 2500,
               ('paper', 'cites', 'paper'): 2000,
               ('paper', 'has_topic', 'field'): 1800,
               ('author', 'affiliated_with', 'institution'): 500}


def _hetero_graph(seed, f=32):
    """The MAG schema, small, with reverse relations."""
    rng = np.random.default_rng(seed)
    ei = {}
    for (s, r, d), e in HETERO_RELS.items():
        coo = np.stack([rng.integers(0, HETERO_NODES[s], e),
                        rng.integers(0, HETERO_NODES[d], e)]).astype(np.int32)
        ei[(s, r, d)] = coo
        if s != d:
            ei[(d, f'rev_{r}', s)] = coo[::-1].copy()
    x = {t: rng.standard_normal((n, f)).astype(np.float32)
         for t, n in HETERO_NODES.items()}
    return x, ei, (tuple(HETERO_NODES), tuple(ei))


def _within(out, ref, share=1e-4):
    """Within ``share`` of the reference's largest magnitude."""
    err = float((out.detach().cpu() - ref.detach().cpu()).abs().max())
    assert err <= share * max(float(ref.abs().max()), 1e-30), err


def _zero_counts():
    from pytorch_geometric_tpu_torch import compat
    for _, fn, attr in compat.launch_counters():
        setattr(fn, attr, 0)


def _hgt_pair(meta, dev, attn_path=None, f=32):
    from pytorch_geometric_tpu_torch.nn import HGTConv
    cpu = HGTConv(f, 32, meta, heads=4, attn_path=attn_path, device='cpu')
    card = HGTConv(f, 32, meta, heads=4, attn_path=attn_path, device=dev)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _hgt_run(model, x, ei, dev, layouts=None):
    """Outputs and the gradients of every parameter and input under a fixed
    cotangent."""
    xs = {t: torch.as_tensor(v, device=dev).requires_grad_()
          for t, v in x.items()}
    out = model(xs, ei, layouts)
    gen = torch.Generator().manual_seed(5)
    loss = sum((v * torch.randn(v.shape, generator=gen).to(dev)).sum()
               for _, v in sorted(out.items()))
    loss.backward()
    return out, {k: p.grad for k, p in model.named_parameters()}, \
        {t: v.grad for t, v in xs.items()}


@pytest.mark.parametrize('route', ['wide_and_flash', 'layouts'])
def test_hgt_fused_route_on_card_matches_cpu(dev, route, monkeypatch):
    """HGT's fused route on the card (the dot kernel on the wide op, the
    three flash kernels past the cap; with layouts every type on flash
    over presorted edges) against the same weights on the CPU: outputs and
    every gradient within 1e-4 of their largest."""
    from pytorch_geometric_tpu_torch import compat
    from pytorch_geometric_tpu_torch.ops import build_hgt_flash_layouts
    x, ei, meta = _hetero_graph(1)
    # 'paper' (6,300 union edges) past the cap, the other types under it
    monkeypatch.setenv('PGT_ATTN_WIDE_BYTES', str(4000 * 4 * 2 * 8 * 4))
    cpu, card = _hgt_pair(meta, dev)
    lay = {}
    if route == 'layouts':
        lay = {d: build_hgt_flash_layouts(meta, ei, HETERO_NODES,
                                          device=d) for d in ('cpu', dev)}
    _zero_counts()
    outs = [_hgt_run(m, x, {k: torch.as_tensor(v, device=d)
                            for k, v in ei.items()}, d, lay.get(d))
            for m, d in ((cpu, 'cpu'), (card, dev))]
    counts = compat.launch_counts()
    if route == 'layouts':
        assert counts['flash_fwd'] == len(HETERO_NODES)
    else:
        assert counts['flash_fwd'] == 1 and counts['edge_dot'] > 0
    assert counts['flash_bwd_dst'] == counts['flash_bwd_src'] == \
        counts['flash_fwd']
    (ro, rg, rx), (co, cg, cx) = outs
    for t in ro:
        _within(co[t], ro[t])
    for k in rg:
        _within(cg[k], rg[k])
    for t in rx:
        _within(cx[t], rx[t])


def test_rectangular_slot_orders_and_blocked_hgt_on_card(dev):
    """Slot orders of rectangular relations (``author -> paper``, ...) built
    on the card equal the CPU's, and HGT's blocked route (the mix kernel
    through ``multi_relation_softmax_aggregate``) matches the CPU."""
    from pytorch_geometric_tpu_torch import compat
    x, ei, meta = _hetero_graph(2)
    eis = {}
    for d in ('cpu', dev):
        eis[d] = {et: EdgeIndex(coo, (HETERO_NODES[et[0]],
                                      HETERO_NODES[et[2]]),
                                device=d).fill_cache(blocked=True)
                  for et, coo in ei.items()}
    for et in ei:
        for side in ('blocked', 'blocked_t'):
            a, b = getattr(eis['cpu'][et], side), getattr(eis[dev][et], side)
            for k in a._fields:
                assert torch.equal(getattr(a, k).cpu().long(),
                                   getattr(b, k).cpu().long()), (et, side, k)
    cpu, card = _hgt_pair(meta, dev, attn_path='blocked')
    _zero_counts()
    (ro, rg, rx), (co, cg, cx) = [_hgt_run(m, x, eis[d], d) for m, d in
                                  ((cpu, 'cpu'), (card, dev))]
    assert compat.launch_counts()['gat_mix'] > 0
    for t in ro:
        _within(co[t], ro[t])
    for k in rg:
        _within(cg[k], rg[k])
    for t in rx:
        _within(cx[t], rx[t])


def test_hetero_batch_relations_build_inside_a_capture(dev):
    """A hetero loader batch (its relations padded with the sampler's -1,
    mapped by the loader to the source budget) becomes EdgeIndexes with
    the padding past both ends inside a captured forward of a to_hetero
    GraphSAGE: the replays launch kernel 1 once per relation and layer,
    equal the eager forward bit for bit and the CPU within 1e-4."""
    from pytorch_geometric_tpu_torch import compat
    from pytorch_geometric_tpu_torch.data import HeteroData
    from pytorch_geometric_tpu_torch.loader import HeteroNeighborLoader
    from pytorch_geometric_tpu_torch.loader.scan_train import \
        batch_edge_index
    from pytorch_geometric_tpu_torch.nn import SAGEConv, to_hetero
    x, ei, meta = _hetero_graph(3)
    data = HeteroData()
    for t, v in x.items():
        data[t].x = v
    for et, coo in ei.items():
        data[et].edge_index = coo
    batch = next(iter(HeteroNeighborLoader(data, [4, 3], ('paper', None),
                                           batch_size=64)))
    ets = list(ei)
    assert any(not bool(batch[et].edge_mask.all()) for et in ets)
    sizes = {t: int(batch[t].n_id.shape[0]) for t in x}
    models = {}
    for d in ('cpu', dev):
        models[d] = to_hetero([SAGEConv(32, 32, device=d), torch.relu,
                               SAGEConv(32, 32, device=d)], meta)
    models[dev].load_state_dict(models['cpu'].state_dict())

    def forward(model, xs, coos, masks):
        eis = {et: batch_edge_index(c, m, sizes[et[0]], sizes[et[2]])
               for et, c, m in zip(ets, coos, masks)}
        out = model(dict(zip(x, xs)), eis)
        return [out[t] for t in sorted(out)]

    def inputs(d):
        return ([batch[t].x.to(d) for t in x],
                [batch[et].edge_index.to(d) for et in ets],
                [batch[et].edge_mask.to(d) for et in ets])

    ref = forward(models['cpu'], *inputs('cpu'))
    compiled = compat.compile(lambda *a: forward(models[dev], *a))
    eager = forward(models[dev], *inputs(dev))
    for _ in range(4):
        got = compiled(*inputs(dev))
    assert compiled.replays >= 1
    assert compiled.launches_per_replay == {'segment_spmm': 2 * len(ets)}
    for g, e, r in zip(got, eager, ref):
        assert torch.equal(g, e)
        _within(g, r)


@pytest.mark.parametrize('rows', [[5000, 0, 37, 12000], [1, 1, 1, 1]])
def test_typed_matmul_arms_agree_on_card(dev, rows):
    """``typed_matmul``'s dense einsum, sort-and-batch and per-type-run
    arms agree on the card and with the CPU (float32 matmuls, TF32 off):
    outputs and gradients within 1e-5 of their largest."""
    from pytorch_geometric_tpu_torch.ops import (build_ragged_layout,
                                                 build_typed_layout,
                                                 typed_matmul)
    rng = np.random.default_rng(6)
    types = np.concatenate([np.full(n, i) for i, n in enumerate(rows)])
    rng.shuffle(types)
    x = rng.standard_normal((len(types), 64)).astype(np.float32)
    w = rng.standard_normal((4, 64, 48)).astype(np.float32)
    g = rng.standard_normal((len(types), 48)).astype(np.float32)
    res = []
    for d in ('cpu', dev):
        for layout in (None, build_typed_layout(types, 4, device=d),
                       build_ragged_layout(types, 4, device=d)):
            tx = torch.as_tensor(x, device=d).requires_grad_()
            tw = torch.as_tensor(w, device=d).requires_grad_()
            out = typed_matmul(tx, torch.as_tensor(types, device=d), tw,
                               layout)
            (out * torch.as_tensor(g, device=d)).sum().backward()
            res.append((out, tx.grad, tw.grad))
    for other in res[1:]:
        for a, b in zip(other, res[0]):
            _within(a, b, 1e-5)


# -- the SpMM regimes (ops/chunked_spmm.py, ops/dense_spmm.py, ops/spmm.py) ---
_ARM_KNOBS = {'windowed': {'PGT_WIN_EDGES': '8192'},
              'chunked': {'PGT_SPMM_CHUNK_TRIGGER': '0',
                          'PGT_SPMM_CHUNK_BUF': str(8192 * 24 * 4)},
              'dense': {'PGT_FORCE_DENSE_SPMM': '1'}}


def _arm_adj(monkeypatch, arm, coo, n, dev):
    for k, v in _ARM_KNOBS[arm].items():
        monkeypatch.setenv(k, v)
    ei = EdgeIndex(coo, (n, n), device=dev)
    return ei.fill_cache(blocked=False, windowed=True) \
        if arm == 'windowed' else ei


@pytest.mark.parametrize('arm', ['windowed', 'chunked', 'dense'])
@pytest.mark.parametrize('reduce', ['sum', 'mean'])
@pytest.mark.parametrize('transpose', [False, True])
def test_regime_arms_match_plain(dev, monkeypatch, arm, reduce, transpose):
    """The windowed, chunked and uncached dense regimes on the card, each
    forced by its knob over several windows or chunks with padded edges,
    against the float64 plain gather / ``index_add_`` and its autograd:
    the output within 1e-5 of max(1, its largest), ``grad_x`` and
    ``grad_w`` within 1e-4 of their largest; the kernels each arm must
    launch are counted."""
    from pytorch_geometric_tpu_torch.compat import launch_counts
    n, f = 3000, 24
    coo, w, x = _case(n, n, 40_000, f, seed=31)
    ei = _arm_adj(monkeypatch, arm, coo, n, dev)
    assert spmm_regime(ei.flip() if transpose else ei, f, reduce,
                       True) == arm
    tx = torch.as_tensor(x, device=dev).requires_grad_()
    tw = torch.as_tensor(w, device=dev).requires_grad_()
    before = launch_counts()
    out = spmm(ei, tx, tw, reduce=reduce, transpose=transpose)
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after['edge_dot'] - before['edge_dot'] >= 1
    assert (after['segment_spmm'] - before['segment_spmm'] >= 2) == (
        arm != 'dense')
    c = torch.as_tensor(coo, device=dev).long()
    s, d = (c[1], c[0]) if transpose else (c[0], c[1])
    x64 = tx.detach().double().requires_grad_()
    w64 = tw.detach().double().requires_grad_()
    ok = (s < n) & (d < n)
    ref = x64.new_zeros((n, f)).index_add_(0, d[ok],
                                           x64[s[ok]] * w64[ok][:, None])
    if reduce == 'mean':
        ref = ref / torch.bincount(d[ok], minlength=n).clamp(
            min=1).double()[:, None]
    ref.backward(g.double())
    assert float((out.detach().double() - ref).abs().max()) <= 1e-5 * max(
        1.0, float(ref.abs().max()))
    for got, want in ((tx.grad, x64.grad), (tw.grad, w64.grad)):
        assert float((got.double() - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


@pytest.mark.parametrize('arm', ['windowed', 'chunked', 'dense'])
def test_regime_arms_raise_without_kernels(dev, monkeypatch, arm):
    """With ``backend.use_kernel_spmm = False`` every new arm raises on the
    card: none runs its plain version there."""
    n = 500
    coo, w, x = _case(n, n, 4000, 8, seed=32)
    ei = _arm_adj(monkeypatch, arm, coo, n, dev)
    monkeypatch.setattr(backend, 'use_kernel_spmm', False)
    with pytest.raises(RuntimeError, match='use_kernel_spmm'):
        spmm(ei, torch.as_tensor(x, device=dev),
             torch.as_tensor(w, device=dev))


def test_auto_policy_on_card(dev, monkeypatch):
    """``fill_cache(auto=True)`` on the card, with the card's defaults
    (``ops/spmm.py``): a bf16 dense cache up to ``AUTO_DENSE_MAX_ENTRIES``
    entries, no block cache (even on a block-dense graph past the dense
    cap, unless asked for), no windowed layouts unless
    ``PGT_AUTO_WIN_MIN_EDGES`` asks (the CSC then a view of them), the
    kernel regime past the cache; no chunking unasked."""
    import importlib
    sm = importlib.import_module('pytorch_geometric_tpu_torch.ops.spmm')
    rng = np.random.default_rng(33)
    small = rng.integers(0, 1000, (2, 8000)).astype(np.int32)
    ei = EdgeIndex(small, (1000, 1000), device=dev).fill_cache(auto=True)
    assert spmm_regime(ei) == 'dense-cached'
    assert ei.dense_adj.dtype == sm.AUTO_CACHE_DTYPE == torch.bfloat16
    x = torch.as_tensor(rng.standard_normal((1000, 16)).astype(np.float32),
                        device=dev)
    ref = spmm(EdgeIndex(small, (1000, 1000), device=dev), x)
    # bf16 operands (x rounded, unit weights exact), a float32 sum
    _within(spmm(ei, x), ref, 2e-2)
    assert spmm(ei, x).dtype == torch.float32
    mid = rng.integers(0, 20_000, (2, 200_000)).astype(np.int32)
    ei = EdgeIndex(mid, (20_000, 20_000), device=dev).fill_cache(auto=True)
    assert ei.dense_adj is None and ei.bsr is None and ei.win is None
    assert spmm_regime(ei, 128) == 'kernel'
    big = rng.integers(0, 100_000, (2, 3_000_000)).astype(np.int32)
    ei = EdgeIndex(big, (100_000, 100_000), device=dev).fill_cache(
        auto=True)
    assert ei.win is None and spmm_regime(ei, 128) == 'kernel'
    monkeypatch.setenv('PGT_AUTO_WIN_MIN_EDGES', '3e6')
    ei = EdgeIndex(big, (100_000, 100_000), device=dev).fill_cache(
        auto=True)
    assert spmm_regime(ei, 128) == 'windowed'
    assert ei.csc.indices.data_ptr() == ei.win.src.data_ptr()
    monkeypatch.delenv('PGT_AUTO_WIN_MIN_EDGES')
    base = np.repeat(np.arange(24) * 128, 260)
    blocks = np.stack([base + rng.integers(0, 128, base.size),
                       base + rng.integers(0, 128, base.size)]).astype(
        np.int32)
    monkeypatch.setenv('PGT_DENSE_SPMM_ENTRIES', '100000')
    n = 24 * 128
    assert EdgeIndex(blocks, (n, n), device=dev).fill_cache(
        auto=True).bsr is None
    assert EdgeIndex(blocks, (n, n), device=dev).fill_cache(
        auto=True, block_sparse=True).bsr is not None
