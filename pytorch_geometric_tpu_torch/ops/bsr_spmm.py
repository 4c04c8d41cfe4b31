"""Block-sparse (BSR) cached-adjacency SpMM: the host layout build, the
hand-written Hopper kernel's wrapper and its plain PyTorch version.

Counterpart of ``pytorch_geometric_tpu/ops/bsr_spmm.py``. A cached,
weight-baked adjacency (``GCNConv(cached=True)`` through
``cache_gcn_norm(block_sparse=...)``) whose ``[N, N]`` does not fit is kept as
its nonempty 128x128 blocks, sorted by (dst block, src block); ``out = A @ x``
streams those blocks. Edges in blocks too sparse to pay for a 64 KB block
stay on the gather path as a residual (``fill_cache`` keeps it beside the
blocks).

The kernel (``csrc/bsr_spmm.cu``) replaces the TPU kernel ``_make_kernel``
(``ops/bsr_spmm.py:114``, launched at ``:184`` by ``_bsr_matmul_impl``). The
TPU kernel zero-initialises each dst row on its ``first`` block of a
sequential grid; Hopper blocks run in no order, so the port's layout carries
a block-row pointer ``row_ptr`` instead of ``first`` flags, and a dst row
with no blocks needs no spliced zero block.

The blocks are float32 or bfloat16 (``fill_cache(cache_dtype=bf16)``), as
the TPU kernel's two arms (``:129-146``); both run on Hopper's tensor cores
(``wgmma``). float32 blocks take three TF32 passes over a hi/lo split of
the blocks and of x (``hi*hi + hi*lo + lo*hi``, about 22 bits a product,
held to the float32 limit); bf16 blocks take one pass over x rounded to
bf16, as the TPU's one DEFAULT MXU pass does. Either way the result is
float32, cast to x's dtype.

The host-side pieces around the kernel are Python the CPU tests reach: the
launch plan (:func:`bsr_plan`: the F tile, the K-chunk, the ring's
stages), the order the rows are taken in (:func:`row_order`, kept in
``BSR.order``), and the plain versions of the kernel's pre-pass
(:func:`bsr_prep_plain`: x laid out per source tile as the kernel's
``wgmma`` B operand, K permuted as :func:`chunk_perm` says) and of the
TF32 rounding (:func:`tf32_round`).

Bound on the card: the block stream (``NB * 64 KB`` float32, ``NB * 32
KB`` bf16) plus x and out over 3.35 TB/s. The ``2 * nnz * F`` FLOPs the
function needs (nnz: nonzeros in the blocks) take far less; the kernel's
dense blocks do ``3 * 2 * NB * 128^2 * FT`` TF32 FLOPs (495 TFLOP/s) or a
third of that in bf16 (989 TFLOP/s). Measured times are in PERF.md.

The build is numpy on the host (block keys, the block-fill split, the
hubs-first relabel); the block values are summed on the EdgeIndex's device
in float64 and stored as float32 (then rounded to bf16 by ``fill_cache``
when asked), and the transposed layout (the backward's) is the forward's
blocks transposed on the device.
"""

import ctypes
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import compat
from .segment import ptr2index

BS = 128                  # block edge (nodes per block, both dims)
MIN_FILL = 16             # edges a block needs to be stored dense
MIN_CAPTURE = 0.5         # share of edges the blocks must capture
MAX_ENTRIES = 500_000_000  # block entries the profitability gate allows
SAMPLE_ABOVE = 32_000_000  # edges past which the relabel check samples


class BSR(NamedTuple):
    """Nonempty-block adjacency, sorted by (dst block, src block).

    vals:    [NB, BS, BS] float32 or bfloat16 block values (``vals[k,
             d_local, s_local]``)
    cols:    [NB] int32 src block of each block
    row_ptr: [num_row_blocks + 1] int32; dst block row ``r`` owns blocks
             ``row_ptr[r] .. row_ptr[r+1]-1`` (:func:`block_rows` expands
             it)
    order:   [num_row_blocks] int32, the dst block rows by descending block
             count (:func:`row_order`), the order the kernel takes them in.
             Every layout built here carries it (:func:`build_bsr`,
             :func:`transpose_bsr`); ``None`` (a layout built by hand) has
             the wrapper compute it on the host at each eager call, and
             raise under a capture
    """
    vals: torch.Tensor
    cols: torch.Tensor
    row_ptr: torch.Tensor
    order: Optional[torch.Tensor] = None


def num_blocks(n: int) -> int:
    """Block rows (or columns) that cover ``n`` nodes; at least one."""
    return max((n + BS - 1) // BS, 1)


def block_rows(bsr: BSR) -> torch.Tensor:
    """[NB] int64 dst block row of each block, from ``row_ptr``."""
    return ptr2index(bsr.row_ptr.long(), bsr.cols.shape[0])


def _valid_edges(coo: np.ndarray, num_src: int, num_dst: int):
    src = coo[0].astype(np.int64)
    dst = coo[1].astype(np.int64)
    return src, dst, (src < num_src) & (dst < num_dst)


def row_order(row_ptr) -> np.ndarray:
    """The dst block rows by descending block count, ties in row order: the
    longest rows start first and the short ones fill the tail."""
    counts = np.diff(np.asarray(row_ptr, np.int64))
    return np.argsort(-counts, kind='stable').astype(np.int32)


def _layout(rows: np.ndarray, cols: np.ndarray, vals: torch.Tensor,
            n_row_blocks: int) -> BSR:
    dev = vals.device
    row_ptr = np.searchsorted(rows, np.arange(n_row_blocks + 1))
    return BSR(vals=vals,
               cols=torch.as_tensor(cols.astype(np.int32), device=dev),
               row_ptr=torch.as_tensor(row_ptr.astype(np.int32),
                                       device=dev),
               order=torch.as_tensor(row_order(row_ptr), device=dev))


def build_bsr(coo: np.ndarray, weight: np.ndarray, num_src: int,
              num_dst: int, device='cpu') -> BSR:
    """Bucket the edges into BS x BS blocks and dense-fill the nonempty ones
    on ``device``. Padded edges (an endpoint >= its size) are dropped;
    duplicate edges add up."""
    src, dst, valid = _valid_edges(coo, num_src, num_dst)
    src, dst = src[valid], dst[valid]
    w = np.asarray(weight, np.float64)[valid]
    s_blocks = num_blocks(num_src)
    key = (dst // BS) * s_blocks + (src // BS)
    uniq, slot = np.unique(key, return_inverse=True)
    nb = len(uniq)
    flat = slot * (BS * BS) + (dst % BS) * BS + (src % BS)
    # float64 sums, then float32, as the JAX package's np.bincount build
    vals = torch.zeros(nb * BS * BS, dtype=torch.float64, device=device)
    vals.index_add_(0, torch.as_tensor(flat, device=device),
                    torch.as_tensor(w, device=device))
    vals = vals.to(torch.float32).view(nb, BS, BS)
    return _layout(uniq // s_blocks, uniq % s_blocks, vals,
                   num_blocks(num_dst))


def transpose_bsr(bsr: BSR, num_src: int) -> BSR:
    """The layout of ``A^T`` (aggregating onto the sources): the same blocks,
    each transposed, sorted by (src block, dst block)."""
    rows = block_rows(bsr).cpu().numpy()
    cols = bsr.cols.cpu().numpy()
    order = np.lexsort((rows, cols))
    vals = bsr.vals[torch.as_tensor(order, device=bsr.vals.device)]
    return _layout(cols[order], rows[order],
                   vals.transpose(1, 2).contiguous(), num_blocks(num_src))


def bsr_stats(coo: np.ndarray, num_src: int, num_dst: int):
    """(number of nonempty blocks, mean edges per nonempty block)."""
    src, dst, valid = _valid_edges(coo, num_src, num_dst)
    e = int(valid.sum())
    if e == 0:
        return 0, 0.0
    s_blocks = num_blocks(num_src)
    nb = len(np.unique((dst[valid] // BS) * s_blocks + (src[valid] // BS)))
    return nb, e / nb


def block_fill_mask(coo: np.ndarray, num_src: int,
                    num_dst: int) -> np.ndarray:
    """Boolean mask of the edges that land in blocks with >= ``MIN_FILL``
    edges (the ones worth storing as dense blocks)."""
    src, dst, valid = _valid_edges(coo, num_src, num_dst)
    s_blocks = num_blocks(num_src)
    key = np.where(valid, (dst // BS) * s_blocks + (src // BS), -1)
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    dense_blk = (counts >= MIN_FILL) & (uniq >= 0)
    return dense_blk[inv] & valid


def split_by_block_fill(coo: np.ndarray, weight: np.ndarray, num_src: int,
                        num_dst: int):
    """Split the edges into (dense-block part, residual part):
    ``(coo_blk, w_blk, coo_res, w_res, captured_fraction)``."""
    w = np.asarray(weight)
    _, _, valid = _valid_edges(coo, num_src, num_dst)
    in_blk = block_fill_mask(coo, num_src, num_dst)
    res = valid & ~in_blk
    frac = float(in_blk.sum()) / max(int(valid.sum()), 1)
    return coo[:, in_blk], w[in_blk], coo[:, res], w[res], frac


def build_bsr_pair(coo: np.ndarray, weight: np.ndarray, num_src: int,
                   num_dst: int, device='cpu',
                   in_blk: Optional[np.ndarray] = None
                   ) -> Tuple[BSR, BSR, Optional[Tuple[np.ndarray, ...]]]:
    """The forward (dst-major) and transposed (src-major) layouts of the
    edges in dense-enough blocks, and the residual ``(src, dst, w)`` numpy
    arrays of the edges left on the gather path (``None`` if every edge was
    captured). ``in_blk``: a block-fill mask computed already."""
    res = None
    w = np.asarray(weight)
    if in_blk is None:
        in_blk = block_fill_mask(coo, num_src, num_dst)
    _, _, valid = _valid_edges(coo, num_src, num_dst)
    res_m = valid & ~in_blk
    if res_m.any():
        res = (coo[0, res_m].astype(np.int32), coo[1, res_m].astype(np.int32),
               w[res_m].astype(np.float32))
        coo, w = coo[:, in_blk], w[in_blk]
    fwd = build_bsr(coo, w, num_src, num_dst, device)
    return fwd, transpose_bsr(fwd, num_src), res


def _sampled_capture(coo: np.ndarray, num_src: int, num_dst: int,
                     frac: float) -> float:
    """Capture estimate from an edge sample: the share of sampled edges in
    blocks whose sampled count reaches ``MIN_FILL * frac`` (at least 2)."""
    src, dst, valid = _valid_edges(coo, num_src, num_dst)
    if not valid.any():
        return 0.0
    s_blocks = num_blocks(num_src)
    key = (dst[valid] // BS) * s_blocks + (src[valid] // BS)
    _, counts = np.unique(key, return_counts=True)
    need = max(int(np.ceil(MIN_FILL * frac)), 2)
    return float(counts[counts >= need].sum() / counts.sum())


def choose_block_order(coo: np.ndarray, num_src: int, num_dst: int):
    """``(perm, inv, capture_frac, in_blk_mask)`` of a hubs-first relabel if
    it clearly improves block fill, else ``(None, None, cap, mask)``.

    Square adjacency only (the same permutation must apply to rows and
    columns); ``(None,) * 4`` otherwise. ``perm[new] = old``. Past
    ``SAMPLE_ABOVE`` edges both captures are first estimated from a sample,
    and the relabel is skipped when neither could pass the gate."""
    if num_src != num_dst:
        return None, None, None, None
    from ..utils.reorder import degree_order
    n = num_src
    e = coo.shape[1]
    if e > SAMPLE_ABOVE:
        frac = min(1.0, 16e6 / e)
        rng = np.random.default_rng(0)
        samp = coo[:, rng.integers(0, e, int(e * frac))]
        est0 = _sampled_capture(samp, n, n, frac)
        perm_s = degree_order(coo, n)
        inv_s = np.empty(n, np.int64)
        inv_s[perm_s] = np.arange(n)
        inv_ext = np.concatenate([inv_s, [n]])
        est1 = _sampled_capture(inv_ext[np.minimum(
            samp.astype(np.int64), n)], n, n, frac)
        if max(est0, est1) < 0.8 * MIN_CAPTURE:
            return None, None, max(est0, est1), None

    def capture_of(c):
        m = block_fill_mask(c, n, n)
        valid = (c[0] < n) & (c[1] < n)
        return float(m.sum()) / max(int(valid.sum()), 1), m

    cap0, mask0 = capture_of(coo)
    if cap0 >= 0.85:            # natural order already block-dense
        return None, None, cap0, mask0
    perm = degree_order(coo, n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    # padded endpoints (the == n sentinel) survive the relabel
    inv_ext = np.concatenate([inv, [n]])
    cap1, mask1 = capture_of(inv_ext[np.minimum(coo.astype(np.int64), n)])
    if cap1 > cap0 * 1.25 and cap1 - cap0 > 0.05:
        return perm, inv, cap1, mask1
    return None, None, cap0, mask0


def bsr_profitable(coo: np.ndarray, num_src: int, num_dst: int,
                   max_entries: int = MAX_ENTRIES,
                   capture: Optional[float] = None,
                   in_blk: Optional[np.ndarray] = None) -> bool:
    """Gate for the block cache: at least ``MIN_CAPTURE`` of the edges land
    in dense-enough blocks, and the captured blocks hold at most
    ``max_entries`` values; never under ``PGT_DISABLE_BSR_SPMM``, as in the
    JAX package. ``capture`` / ``in_blk`` (from :func:`choose_block_order`)
    skip the re-analysis."""
    if os.environ.get('PGT_DISABLE_BSR_SPMM'):
        return False
    if capture is not None and capture < MIN_CAPTURE:
        return False
    if capture is not None and in_blk is not None:
        coo_blk = coo[:, in_blk]
    else:
        coo_blk, _, _, _, frac = split_by_block_fill(
            coo, np.ones(coo.shape[1], np.float32), num_src, num_dst)
        if frac < MIN_CAPTURE:
            return False
    if coo_blk.shape[1] == 0:
        return False
    nb, _ = bsr_stats(coo_blk, num_src, num_dst)
    return nb * BS * BS <= max_entries


# -- the kernels and their plain version -------------------------------------
def bsr_spmm_plain(bsr: BSR, x: torch.Tensor, num_out: int) -> torch.Tensor:
    """The plain PyTorch version of one pass: gather each block's x tile,
    ``bmm``, ``index_add_`` into the block rows, all in float32; bf16
    blocks multiply x rounded to bf16 (the products of two bf16 values are
    exact in float32, as on the tensor cores). The result is in x's
    dtype."""
    n_src, f = x.shape
    s_blocks = num_blocks(n_src)
    d_blocks = bsr.row_ptr.shape[0] - 1
    bf16 = bsr.vals.dtype == torch.bfloat16
    xp = x.new_zeros((s_blocks * BS, f), dtype=torch.float32)
    xp[:n_src] = x.to(torch.bfloat16) if bf16 else x
    tiles = xp.view(s_blocks, BS, f)[bsr.cols.long()]
    prod = torch.bmm(bsr.vals.float(), tiles)
    out = xp.new_zeros((d_blocks, BS, f)).index_add_(0, block_rows(bsr),
                                                     prod)
    return out.view(d_blocks * BS, f)[:num_out].to(x.dtype)


def _check(bsr: BSR, x: torch.Tensor, num_out: int):
    for name, t in (('blocks', bsr.vals), ('x', x)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f'bsr_matmul takes float32 or bfloat16 {name}, '
                            f'got {t.dtype}')
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError('bsr_matmul takes a contiguous 2-D x, got shape '
                         f'{tuple(x.shape)} strides {x.stride()}')
    nb = bsr.vals.shape[0]
    if (bsr.vals.dim() != 3 or tuple(bsr.vals.shape[1:]) != (BS, BS)
            or not bsr.vals.is_contiguous()):
        raise ValueError(f'bsr_matmul takes contiguous [NB, {BS}, {BS}] '
                         f'blocks, got {tuple(bsr.vals.shape)}')
    for name, t, n in (('vals', bsr.vals, nb), ('cols', bsr.cols, nb),
                       ('row_ptr', bsr.row_ptr, num_blocks(num_out) + 1)):
        if t.device != x.device:
            raise ValueError(f'bsr_matmul: {name} is on {t.device}, x on '
                             f'{x.device}')
        if name != 'vals' and (t.dtype != torch.int32 or t.dim() != 1
                               or t.shape[0] != n or not t.is_contiguous()):
            raise ValueError(f'bsr_matmul takes a contiguous [{n}] int32 '
                             f'{name}, got {t.dtype} shape '
                             f'{tuple(t.shape)}')


# -- the kernel's launch plan and the plain versions of its pre-pass ----------
SMEM_BYTES = 232_448      # shared memory a CTA may use on Hopper
HEAD_BYTES = 1024         # the kernel's barriers and stage headers
ROW_BYTES = 256           # a staged run of one block row (a K-chunk)
MAX_STAGES = 8            # the ring's barrier arrays
F_TILES = (16, 32, 64)    # the kernel's FT instances (wgmma N)


class BsrPlan(NamedTuple):
    """How the kernel runs one call: ``ft`` output columns per work item
    (``n_ft`` tiles cover F), K-chunks of ``kc`` columns (``chunks`` per
    block), the pre-pass's run of ``x_bytes`` per (source tile, F tile,
    chunk), ``stages`` ring stages of ``stage_bytes``, ``smem_bytes`` of
    shared memory."""
    ft: int
    n_ft: int
    kc: int
    chunks: int
    x_bytes: int
    stage_bytes: int
    stages: int
    smem_bytes: int


def bsr_plan(f: int, bf16: bool) -> BsrPlan:
    """The launch plan for F = ``f`` columns: the narrowest F tile that
    covers a narrow F, else tiles of 64; a K-chunk is 256 bytes of a block
    row (64 float32 or 128 bf16 columns); as many stages as shared memory
    holds, at most ``MAX_STAGES``."""
    ft = next((t for t in F_TILES if f <= t), F_TILES[-1])
    kc = ROW_BYTES // (2 if bf16 else 4)
    # float32 x is staged twice, as TF32 hi and lo
    x_bytes = (1 if bf16 else 2) * kc * ft * (2 if bf16 else 4)
    stage = BS * ROW_BYTES + x_bytes
    stages = min(MAX_STAGES, (SMEM_BYTES - HEAD_BYTES) // stage)
    return BsrPlan(ft=ft, n_ft=-(-max(f, 1) // ft), kc=kc, chunks=BS // kc,
                   x_bytes=x_bytes, stage_bytes=stage, stages=stages,
                   smem_bytes=HEAD_BYTES + stages * stage)


def chunk_perm(bf16: bool) -> np.ndarray:
    """``perm[l]``: the chunk column that logical k ``l`` of the kernel's
    ``wgmma`` k-steps reads. A thread's A fragment holds, per k-step, two k
    values (TF32, 4 apart) or two pairs (bf16, 8 apart); the permutation
    puts what it needs for two k-steps in one 16-byte run of the row. The
    pre-pass lays x out in the same order, so the sum is the same."""
    if bf16:
        l = np.arange(128)
        step, j = l >> 4, l & 15
        return (32 * (step >> 1) + 8 * ((j & 7) >> 1) + 4 * (step & 1)
                + 2 * (j >> 3) + (j & 1))
    l = np.arange(64)
    step, j = l >> 3, l & 7
    return 16 * (step >> 1) + 4 * (j & 3) + 2 * (step & 1) + (j >> 2)


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to TF32 (10 stored mantissa bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``; NaN stays NaN."""
    bits = v.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(v), v, r)


def tf32_split(v: torch.Tensor):
    """``(hi, lo)``: ``hi`` = v rounded to TF32, ``lo`` = the remainder
    rounded to TF32, as the kernel splits both operands."""
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def bsr_prep_plain(x: torch.Tensor, plan: BsrPlan,
                   bf16: bool) -> torch.Tensor:
    """The plain version of the kernel's pre-pass: x ``[n_src, F]`` laid out
    as ``[source tile, F tile, chunk, hi/lo, k group, n, k in group]`` (bf16
    has no hi/lo axis; float32 x gives TF32 ``hi`` and ``lo``), k in the
    order :func:`chunk_perm` gives, F padded to the tiles and rows past
    ``n_src`` zero. Each ``[k group, n, k in group]`` run is the kernel's
    ``wgmma`` B operand: 8-row by 16-byte core matrices, K-major."""
    n_src, f = x.shape
    tiles = num_blocks(n_src)
    epu = 8 if bf16 else 4                 # k values in 16 bytes
    xp = x.new_zeros((tiles * BS, plan.n_ft * plan.ft), dtype=torch.float32)
    xp[:n_src, :f] = x
    # [tile, chunk, logical k, F tile, n]
    perm = torch.as_tensor(chunk_perm(bf16), device=x.device)
    v = xp.view(tiles, plan.chunks, plan.kc, plan.n_ft, plan.ft)[:, :, perm]
    v = v.view(tiles, plan.chunks, plan.kc // epu, epu, plan.n_ft, plan.ft)
    # -> [tile, F tile, chunk, k group, n, k in group]
    v = v.permute(0, 4, 1, 2, 5, 3)
    if bf16:
        return v.to(torch.bfloat16).contiguous()
    return torch.stack(tf32_split(v.contiguous()), 3)


def _kernel(arm: str):
    """The library's entry point of ``arm``, 'f32' or 'bf16'."""
    from .. import csrc
    v, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return csrc.function('bsr_spmm', f'pgt_bsr_spmm_{arm}',
                         [v] * 8 + [ll] * 5 + [i, i, v])


def bsr_matmul(bsr: BSR, x: torch.Tensor, num_out: int) -> torch.Tensor:
    """One pass ``out [num_out, F] = A @ x`` over the block layout, in x's
    dtype. A CPU tensor runs :func:`bsr_spmm_plain`; a CUDA tensor launches
    the pre-pass and the kernel of the blocks' dtype (built at first use;
    float32 blocks count in ``bsr_matmul.launches``, bf16 ones in
    ``bsr_matmul.launches_bf16``) or raises. The counts are host calls: a
    CUDA graph's replay counts nothing, and a capture's launches are kept
    by the compiled callable (``compat.Compiled.launches_per_replay``). Not
    differentiable: ``spmm``'s block arm (``ops/spmm.py``) runs it forward
    and, over the transposed layout, backward."""
    _check(bsr, x, num_out)
    if bsr.order is not None and (bsr.order.device != x.device
                                  or bsr.order.dtype != torch.int32
                                  or tuple(bsr.order.shape)
                                  != (bsr.row_ptr.shape[0] - 1,)):
        raise ValueError('bsr_matmul takes an int32 order of one entry per '
                         'block row, on x\'s device')
    if bsr.order is None and compat.is_compiling():
        raise RuntimeError(
            'bsr_matmul: the layout has no row order, and computing one reads '
            'row_ptr on the host, which a CUDA graph capture forbids; build '
            'the layout with fill_cache (or build_bsr / transpose_bsr), which '
            'fill BSR.order once')
    if x.device.type == 'cpu':
        return bsr_spmm_plain(bsr, x, num_out)
    if x.device.type != 'cuda':
        raise ValueError(f'bsr_matmul runs on cpu or cuda, not {x.device}')
    if bsr.vals.data_ptr() % 16:
        raise ValueError('bsr_matmul: the block values must be 16-byte '
                         'aligned')
    bf16 = bsr.vals.dtype == torch.bfloat16
    n_src, f = x.shape
    plan = bsr_plan(f, bf16)
    fn = _kernel('bf16' if bf16 else 'f32')
    # the pre-pass reads x as float32 (and rounds it to bf16 for bf16
    # blocks); the kernel writes a float32 result
    xf = x.float()
    xs = torch.empty(num_blocks(n_src) * plan.n_ft * plan.chunks
                     * plan.x_bytes, dtype=torch.uint8, device=x.device)
    counter = torch.empty(1, dtype=torch.int32, device=x.device)
    order = bsr.order if bsr.order is not None else torch.as_tensor(
        row_order(bsr.row_ptr.cpu().numpy()), device=x.device)
    out = torch.empty((num_out, f), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(bsr.row_ptr.data_ptr(), bsr.cols.data_ptr(),
                 order.data_ptr(), bsr.vals.data_ptr(), xf.data_ptr(),
                 xs.data_ptr(), out.data_ptr(), counter.data_ptr(),
                 bsr.row_ptr.shape[0] - 1, num_out, n_src, f,
                 bsr.vals.shape[0], plan.ft, plan.stages, stream)
    if err != 0:
        raise RuntimeError(f'bsr_matmul kernel launch failed: CUDA error '
                           f'{err}')
    if bf16:
        bsr_matmul.launches_bf16 += 1
    else:
        bsr_matmul.launches += 1
    return out.to(x.dtype)


compat.register_launch_counter('bsr_spmm', bsr_matmul)
compat.register_launch_counter('bsr_spmm_bf16', bsr_matmul,
                               'launches_bf16')
