"""What surrounds the block-sparse kernel (``csrc/bsr_spmm.cu``), on the CPU:
the TF32 split, the pre-pass's layout of x, the fragments a thread loads
against the ``wgmma`` operands they stand for, the 3xTF32 sum against the
float64 product, and the launch plan and row order.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
these tests hold its host-side pieces and a numpy emulation of its
arithmetic, written from the kernel's own index formulas. Tolerance: the
3xTF32 sum within ``chip_smoke.py``'s float32 limit, 1e-5 + 1e-5 of the
row's sum of |a*x|."""

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu_torch.ops.bsr_spmm import (
    BS, BSR, F_TILES, HEAD_BYTES, MAX_STAGES, ROW_BYTES, SMEM_BYTES,
    bsr_matmul, bsr_plan, bsr_prep_plain, bsr_spmm_plain,
    build_bsr_pair, chunk_perm, row_order, tf32_round, tf32_split)


def _bits(v):
    return v.contiguous().view(torch.int32).numpy().astype(np.int64) \
        & 0xFFFFFFFF


def _rna_reference(v: np.ndarray) -> np.ndarray:
    """Round-to-nearest-ties-away to 10 mantissa bits, in float64."""
    v64 = v.astype(np.float64)
    m, e = np.frexp(np.abs(v64))            # |v| = m * 2^e, m in [0.5, 1)
    q = np.floor(m * 2.0 ** 11 + 0.5)       # 11 significant bits
    return (np.sign(v64) * np.ldexp(q, e - 11)).astype(np.float32)


def test_tf32_split_is_exact_and_rounds_as_cvt_rna():
    rng = np.random.default_rng(0)
    v = np.concatenate([
        rng.standard_normal(20_000).astype(np.float32),
        (rng.standard_normal(2000) * 1e-30).astype(np.float32),
        (rng.standard_normal(2000) * 1e30).astype(np.float32),
        np.array([0.0, -0.0, 1.0, -1.0], np.float32)])
    t = torch.from_numpy(v)
    hi, lo = tf32_split(t)
    # at most 10 stored mantissa bits in each part
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    # the remainder is exact: hi + (v - hi) == v bit for bit, and lo is
    # that remainder rounded to TF32
    rem = t - hi
    nz = v != 0                   # -0 - (-0) is +0
    np.testing.assert_array_equal(_bits(hi + rem)[nz], _bits(t)[nz])
    assert ((hi + rem) == t).all()
    np.testing.assert_array_equal(lo.numpy(), tf32_round(rem).numpy())
    np.testing.assert_array_equal(hi.numpy(), _rna_reference(v))
    # hi + lo keeps about 22 bits
    err = np.abs((hi.double() + lo.double()).numpy() - v.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(v)).all()


@pytest.mark.parametrize('sign', [1, -1])
def test_tf32_ties_round_away_from_zero(sign):
    # low 13 bits exactly half an ulp: cvt.rna rounds the magnitude up
    for base in (0x3F800000, 0x3F802000, 0x40490000, 0x00800000):
        tie = torch.tensor([base | 0x1000], dtype=torch.int32).view(
            torch.float32) * sign
        below = torch.tensor([base | 0x0FFF], dtype=torch.int32).view(
            torch.float32) * sign
        assert _bits(tf32_round(tie).abs())[0] == base + 0x2000
        assert _bits(tf32_round(below).abs())[0] == base
    nan = torch.tensor([float('nan'), float('inf'), -float('inf')])
    r = tf32_round(nan)
    assert torch.isnan(r[0]) and torch.equal(r[1:], nan[1:])


def _prep_reference(x: np.ndarray, f_tile: int, bf16: bool) -> np.ndarray:
    """The pre-pass as ``prep_kernel`` indexes it: one 16-byte unit a
    thread, unit u -> (chunk, hi/lo, k group, n), each k through ``perm``."""
    n_src, f = x.shape
    kc, cpb, hl_n, epu = (128, 1, 1, 8) if bf16 else (64, 2, 2, 4)
    kg_n = kc // epu
    n_ft = -(-f // f_tile)
    per_chunk = hl_n * kg_n * f_tile
    tiles = max(-(-n_src // BS), 1)
    u = np.arange(tiles * n_ft * cpb * per_chunk)
    chunk, w = u // per_chunk, u % per_chunk
    hl, kg, nn = w // (kg_n * f_tile), (w // f_tile) % kg_n, w % f_tile
    part, ft = chunk % cpb, (chunk // cpb) % n_ft
    tile = chunk // (cpb * n_ft)
    n = ft * f_tile + nn
    perm = chunk_perm(bf16)
    out = np.zeros((len(u), epu), np.float32)
    for e in range(epu):
        s = tile * BS + part * kc + perm[kg * epu + e]
        ok = (s < n_src) & (n < f)
        a = np.where(ok, x[np.minimum(s, n_src - 1), np.minimum(n, f - 1)],
                     0).astype(np.float32)
        if not bf16:
            hi = _rna_reference(a)
            a = np.where(hl == 1, _rna_reference(a - hi), hi)
        out[:, e] = a
    return out.reshape(-1)


@pytest.mark.parametrize('f', [1, 10, 130])
@pytest.mark.parametrize('bf16', [False, True])
def test_prep_layout_matches_the_kernels_index_map(f, bf16):
    rng = np.random.default_rng(f)
    n_src = 300                   # a ragged last source tile
    x = rng.standard_normal((n_src, f)).astype(np.float32)
    plan = bsr_plan(f, bf16)
    got = bsr_prep_plain(torch.from_numpy(x), plan, bf16)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert got.numel() * got.element_size() == \
        3 * plan.n_ft * plan.chunks * plan.x_bytes
    want = _prep_reference(x, plan.ft, bf16)
    if bf16:
        want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got.float().reshape(-1).numpy(), want)


def _fragments(chunk: np.ndarray, bf16: bool):
    """The A registers the kernel's threads hold for one staged chunk
    (``load_rows`` and ``chunk_f32`` / ``chunk_bf16``), as the matrix
    ``wgmma`` reads them: A[row, logical k], from each thread's documented
    fragment positions (a0: row g, a1: row g + 8, a2 / a3: four k later for
    TF32, eight for bf16; bf16 registers hold two k each)."""
    kc = chunk.shape[1]
    epu = 8 if bf16 else 4                # values in one 16-byte load
    steps = 8
    k_step = kc // steps                  # 8 (TF32) or 16 (bf16)
    a = np.full((BS, kc), np.nan)
    for row0 in range(0, BS, 16):         # a warp's 16 rows
        for g in range(8):
            for t in range(4):
                for p in range(4):
                    base = (64 * p + 16 * t) // (16 // epu)
                    vec = [chunk[row0 + g, base:base + epu],
                           chunk[row0 + g + 8, base:base + epu]]
                    for sb in range(2):
                        s = 2 * p + sb
                        per = epu // 4    # values a word holds
                        # a0, a1, a2, a3: word 2sb of row g, of row g + 8,
                        # word 2sb + 1 of row g, of row g + 8
                        for reg, (h, wd) in enumerate(
                                ((0, 2 * sb), (1, 2 * sb), (0, 2 * sb + 1),
                                 (1, 2 * sb + 1))):
                            vals = vec[h][wd * per:(wd + 1) * per]
                            row = row0 + g + 8 * (reg & 1)
                            kk = ((t if not bf16 else 2 * t)
                                  + (reg >> 1) * (4 if not bf16 else 8))
                            for e, v in enumerate(vals):
                                a[row, s * k_step + kk + e] = v
    assert not np.isnan(a).any()
    return a


@pytest.mark.parametrize('bf16', [False, True])
def test_fragments_and_prepped_x_give_the_chunk_product(bf16):
    """The thread fragments, read as the wgmma's A, times the pre-pass's B
    is the staged chunk times its x rows: the K permutation cancels."""
    rng = np.random.default_rng(3)
    f = 24
    plan = bsr_plan(f, bf16)
    x = rng.standard_normal((BS, f))
    xs = bsr_prep_plain(torch.from_numpy(x.astype(np.float32)), plan, bf16)
    xs = xs.float().numpy()
    block = rng.standard_normal((BS, BS))
    for part in range(plan.chunks):
        chunk = block[:, part * plan.kc:(part + 1) * plan.kc]
        a = _fragments(chunk, bf16)
        # B [logical k, n] from [k group, n, k in group] (hi only: the
        # layout is what is checked, in float64)
        b_run = xs[0, 0, part] if bf16 else xs[0, 0, part, 0]
        b = b_run.transpose(0, 2, 1).reshape(plan.kc, plan.ft)[:, :f]
        x_part = x[part * plan.kc:(part + 1) * plan.kc]
        x_round = (torch.from_numpy(x_part.astype(np.float32))
                   .to(torch.bfloat16).float().numpy() if bf16 else
                   _rna_reference(x_part.astype(np.float32)))
        np.testing.assert_allclose(a @ b, chunk @ x_round, rtol=1e-12,
                                   atol=1e-12)


def _rz(v: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward zero (a tensor core's adder at
    its worst)."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def _gcn_blocks(n, e, seed):
    """A path-A-like graph: 90 % of the edges inside communities, with
    self loops and D^-1/2 (A+I) D^-1/2 weights, as ``cache_gcn_norm``."""
    rng = np.random.default_rng(seed)
    cs = 240
    comm = rng.integers(0, n // cs, e)
    intra = rng.random(e) < 0.9
    src = np.where(intra, comm * cs + rng.integers(0, cs, e),
                   rng.integers(0, n, e))
    dst = np.where(intra, comm * cs + rng.integers(0, cs, e),
                   rng.integers(0, n, e))
    src = np.concatenate([src, np.arange(n)])
    dst = np.concatenate([dst, np.arange(n)])
    deg = np.bincount(dst, minlength=n).astype(np.float64)
    w = (deg[src] ** -0.5 * deg[dst] ** -0.5).astype(np.float32)
    coo = np.stack([src, dst]).astype(np.int32)
    return build_bsr_pair(coo, w, n, n)[0], rng


def test_split_sum_meets_the_float32_limit():
    """Each chunk: hi*x_hi + hi*x_lo + lo*x_hi per TF32 k-step into a fresh
    accumulator, every update rounded toward zero, then the chunk added to
    the row's float32 sum; against the float64 product, within 1e-5 + 1e-5
    of the row's sum of |a*x|. One TF32 pass misses that limit."""
    n, f = 1024, 16
    bsr, rng = _gcn_blocks(n, 40_000, seed=5)
    x = rng.standard_normal((n, f)).astype(np.float32)
    vals = bsr.vals.numpy()
    rows = np.repeat(np.arange(bsr.row_ptr.shape[0] - 1),
                     np.diff(bsr.row_ptr.numpy()))
    cols = bsr.cols.numpy()
    a_hi, a_lo = (t.numpy().astype(np.float64)
                  for t in tf32_split(bsr.vals))
    x_hi, x_lo = (t.numpy().astype(np.float64)
                  for t in tf32_split(torch.from_numpy(x)))
    total = np.zeros((n // BS, BS, f), np.float32)
    one_pass = np.zeros((n // BS, BS, f), np.float64)
    for k in range(len(cols)):
        src = slice(cols[k] * BS, (cols[k] + 1) * BS)
        for part in range(2):              # two 64-column chunks
            acc = np.zeros((BS, f), np.float32)
            for s in range(8):             # k8 steps
                ks = slice(part * 64 + 8 * s, part * 64 + 8 * s + 8)
                xs_h, xs_l = x_hi[src][ks], x_lo[src][ks]
                for a_op, b_op in ((a_hi, xs_h), (a_hi, xs_l),
                                   (a_lo, xs_h)):
                    acc = _rz(acc + a_op[k][:, ks] @ b_op)
            total[rows[k]] = (total[rows[k]].astype(np.float32) + acc)
        one_pass[rows[k]] += a_hi[k] @ x_hi[src]
    exact = np.zeros((n // BS, BS, f))
    scale = np.zeros((n // BS, BS, f))
    for k in range(len(cols)):
        src = slice(cols[k] * BS, (cols[k] + 1) * BS)
        exact[rows[k]] += vals[k].astype(np.float64) @ x[src]
        scale[rows[k]] += np.abs(vals[k].astype(np.float64)) @ np.abs(x[src])
    limit = 1e-5 + 1e-5 * scale
    assert (np.abs(total - exact) <= limit).all()
    assert not (np.abs(one_pass - exact) <= limit).all()
    # and the plain version the kernel is held to agrees with float64
    plain = bsr_spmm_plain(bsr, torch.from_numpy(x), n).numpy()
    assert (np.abs(plain - exact.reshape(n, f)) <= limit.reshape(n, f)).all()


@pytest.mark.parametrize('bf16', [False, True])
def test_launch_plan(bf16):
    prev_stages = None
    for f in (1, 8, 10, 16, 17, 33, 64, 65, 128, 130, 1000):
        plan = bsr_plan(f, bf16)
        assert plan.ft in F_TILES and plan.n_ft * plan.ft >= f
        assert plan.ft == next((t for t in F_TILES if f <= t), 64)
        assert (plan.n_ft - 1) * plan.ft < f
        assert plan.kc * (2 if bf16 else 4) == ROW_BYTES
        assert plan.chunks * plan.kc == BS
        assert plan.x_bytes == (1 if bf16 else 2) * plan.kc * plan.ft * (
            2 if bf16 else 4)
        assert plan.stage_bytes == BS * ROW_BYTES + plan.x_bytes
        # the swizzled TMA boxes need 1024-byte aligned stages
        assert plan.stage_bytes % 1024 == 0
        assert 3 <= plan.stages <= MAX_STAGES
        assert plan.smem_bytes == HEAD_BYTES + plan.stages * plan.stage_bytes
        assert plan.smem_bytes <= SMEM_BYTES
        # one stage more would not fit (or would pass the barrier arrays)
        assert (plan.stages == MAX_STAGES or plan.smem_bytes
                + plan.stage_bytes > SMEM_BYTES)
        if prev_stages is not None and plan.ft >= 64:
            assert plan.stages <= prev_stages
        prev_stages = plan.stages
    # the paths' shapes: f32 F = 64 takes three stages of 64 KB
    assert bsr_plan(64, False).stages == 3 and bsr_plan(64, True).stages == 4


def test_row_order_is_a_descending_permutation():
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 40, 500)
    counts[::7] = 0                        # empty rows
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    order = row_order(row_ptr)
    assert order.dtype == np.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(500))
    c = counts[order]
    assert (np.diff(c) <= 0).all()
    for v in np.unique(c):                 # ties keep row order
        assert (np.diff(order[c == v]) > 0).all()


def test_layouts_carry_their_row_order():
    bsr, rng = _gcn_blocks(700, 9000, seed=1)
    fwd, bwd, _ = build_bsr_pair(
        np.stack([rng.integers(0, 700, 5000), rng.integers(0, 700, 5000)]
                 ).astype(np.int32), rng.random(5000).astype(np.float32),
        700, 700)
    for lay in (bsr, fwd, bwd):
        np.testing.assert_array_equal(lay.order.numpy(),
                                      row_order(lay.row_ptr.numpy()))
    x = torch.from_numpy(rng.standard_normal((700, 5)).astype(np.float32))
    ref = bsr_spmm_plain(bsr, x, 700)
    # a layout without an order is taken as it is; a malformed one raises
    bare = BSR(vals=bsr.vals, cols=bsr.cols, row_ptr=bsr.row_ptr)
    assert torch.equal(bsr_matmul(bare, x, 700), ref)
    with pytest.raises(ValueError, match='order'):
        bsr_matmul(bsr._replace(order=bsr.order[:-1]), x, 700)
    with pytest.raises(ValueError, match='order'):
        bsr_matmul(bsr._replace(order=bsr.order.long()), x, 700)
