"""Sparse (adjacency) x dense (features) matmul.

Counterpart of ``pytorch_geometric_tpu/ops/spmm.py``:
``out[dst] = reduce over incoming edges of edge_weight * x[src]``.

The ladder, checked in the JAX package's order (``spmm_regime``):

  * ``'dense-cached'``: a dense adjacency baked by ``fill_cache`` (weights
    in it, no weight passed) with ``reduce`` in sum|mean -> one matrix
    product (``ops/dense_spmm.py``: float32, bf16 operands with a float32
    result, or int8 for inference), then the mean's division by the CSC
    degree and the cast back to ``x``'s dtype. PyTorch's matmuls, as the
    JAX package leaves these to XLA; it runs whatever
    ``backend.use_kernel_spmm`` says.
  * ``'bsr'``: a block-sparse cache baked by ``fill_cache`` (weights in the
    blocks, no weight passed) with ``reduce`` in sum|mean -> the block
    kernel (``ops/bsr_spmm.py``) over the nonempty 128x128 blocks, un-doing
    the hubs-first relabel around it when one was baked in, plus the
    residual edges through the segment-sum kernel, which takes the block
    product as its ``base`` (``out + segment_sum(...)`` in one pass, as XLA
    fuses the JAX package's add); ``mean`` divides by the destination
    degree. Differentiable in ``x``: both kernels run their backward over
    the transposed layouts, the residual's again onto the block product.
    bf16 blocks take the block kernel's tensor-core arm.
  * ``'dense'``: the uncached dense regime (``ops/dense_spmm.py``), where
    :func:`_dense_profitable` says the densification pays.
  * ``'windowed'``: the windowed layouts ``win`` / ``win_t`` that
    ``fill_cache`` built. The CSC and CSR are views of their first ``E``
    slots (the trailing pads are never read), so the arm is the
    ``'kernel'`` arm over them: kernel 1 over the flattened layout in one
    launch each way, the dot kernel for ``grad_w``.
  * ``'chunked'``: past :func:`chunk_trigger_bytes` of gathered messages
    (``E * F * 4``), the raw COO in chunks of :func:`chunk_edges`
    (``ops/chunked_spmm.py``).
  * ``'kernel'``: ``reduce`` in sum|mean on a CUDA tensor -> the hand-written
    segment-sum kernel (``ops/segment_spmm.py``) over the cached (or freshly
    built) CSC, with its backward over the CSR; ``mean`` divides by the CSC
    degree. This is the JAX package's ``'pallas'`` regime. There is no
    edge-count threshold: the JAX package's ``_PALLAS_MIN_EDGES`` was a TPU
    measurement. The message dtype is JAX's promotion of ``x`` and the
    weights: bf16 ``x`` with no or bf16 weights takes the kernel's bf16 arm
    (bf16 out), bf16 ``x`` with float32 weights the float32 arm.
  * ``'plain'``: CPU tensors (the same CSC sum through the kernel's plain
    version), and ``min``/``max``, which gather and scatter as the JAX
    package's XLA gather path does.

Weights carried on the EdgeIndex (``fill_cache`` that baked nothing) are
applied when the caller passes none (the carried-weight rule, JAX
``ops/spmm.py:357-363``). A block-sparse cache runs the ``'bsr'`` arm on the
CPU too, and the dense, windowed and chunked regimes run there through the
kernels' plain versions. A sum/mean past the dense cache on a CUDA tensor
with ``backend.use_kernel_spmm = False`` raises: the plain versions never
stand in for a kernel on the card.

The policy's constants keep the JAX package's environment names. Their
defaults on the card come from ``kernel_ab.py --only policy`` (one H100 80GB
HBM3 at 700 W, PERF.md section 6); each constant names the sweep's rows
that set it.
"""

import os
from typing import Optional, Union

import torch

from .. import backend
from ..edge_index import CSR, EdgeIndex, dense_cap
from .bsr_spmm import bsr_matmul
from .chunked_spmm import chunked_spmm
from .dense_spmm import dense_spmm, dense_uncached
from .scatter import scatter
from .segment_spmm import segment_spmm

# The card's defaults, from ``kernel_ab.py --only policy`` (measured on one
# H100 80GB HBM3 at 700 W; PERF.md section 6, the sweep's tables). "Row"
# names a row of those tables. The arms are ranked by what a captured call
# costs (ms per CUDA-graph replay, up to 10k nodes), as the main paths are
# served captured; eager calls of small graphs cost the host's ~0.03-0.08
# ms whatever the arm.
#
# the size rule of the uncached dense regime where it is forced to run:
# n_src * n_dst <= DENSE_ADVANTAGE * E * F and the dense cap (the JAX
# package's 36; unforced it never runs, see _dense_profitable)
DENSE_ADVANTAGE = 36.0
# fill_cache(auto=True)'s dense cache on the card holds at most this many
# entries. Rows 'random n=1000 deg=10/33/100' (1e6 entries, captured):
# the bf16 cache beat 'kernel' at 5 of the 9 points, by up to 2.5x at
# degree 100 and F >= 64 (0.0068 / 0.0093 against 0.0168 / 0.0171), and
# lost the other 4 by at most 0.0030 (0.0092-0.0111 against 0.0071-0.0091;
# the same arm timed twice, 'kernel' and 'windowed', differs by up to
# 0.0041 there); rows 'random n=10000 ...' (1e8 entries): 'kernel' beat
# both caches at every point (0.0073-0.0710 against bf16's 0.0746-0.0799)
AUTO_DENSE_MAX_ENTRIES = 1_000_000
# the dtype of fill_cache(auto=True)'s dense cache on the card, as the JAX
# package's auto default. Rows 'random n=1000 ...' (within the cap above,
# captured): bf16 0.0068-0.0111 against float32 0.0113-0.0154, ahead at
# every point (the float32 product reads twice the bytes; eagerly the
# bf16 one's casts cost more host time than that saves)
AUTO_CACHE_DTYPE = torch.bfloat16
# fill_cache(auto=True) builds the windowed layouts from this many edges
# (PGT_AUTO_WIN_MIN_EDGES): never unasked. The JAX package windows its
# scan so that no [E, F] array is made; kernel 1 makes none, and the
# 'windowed' arm is the 'kernel' arm over the CSC and CSR, which are views
# of the layouts' first E slots: the same launches over the same values,
# forward and backward. The layouts add 24 bytes an edge (rows 'products':
# 5.978 GB built against 2.989 for the CSC and CSR alone) and buy
# nothing: row 'training n=100000 deg=100' (weighted forward and backward)
# 2.3743 ms 'windowed' against 2.3723 'kernel'
AUTO_WIN_MIN_EDGES = float('inf')
# fill_cache(auto=True) skips the slot orders past this many edges
# (PGT_AUTO_BLOCKED_MAX_EDGES): they serve only the fused attention
# routes, which the attention cap (PGT_ATTN_WIDE_BYTES, 1e9) sends to the
# flash kernels, which read none, past 62.5M edges at 4 heads. The
# 'products' builds: the slot orders cost 0.069 s and 5.94 GB at 123.7M
# edges (48 bytes an edge)
AUTO_BLOCKED_MAX_EDGES = 62_500_000
# the chunked regime fires past this many gathered bytes, E * F * 4
# (PGT_SPMM_CHUNK_TRIGGER): never unasked. The JAX package chunks because
# its sparse paths materialise [E, F] messages; kernel 1 gathers into
# registers and never does. Rows 'products F=100 / 64': 'chunked' 159.3595
# / 124.0525 against 'kernel uncached' (the raw COO sorted in the call)
# 111.7783 / 100.3679, and slower in device time at every grid point
CHUNK_TRIGGER_BYTES = float('inf')
# a chunk's gathered bytes (PGT_SPMM_CHUNK_BUF), as in the JAX package
CHUNK_BUF_BYTES = 1e9


def auto_dense_cap(dtype_bytes: int = 4,
                   device: Union[None, str, torch.device] = None) -> int:
    """Entry budget for ``fill_cache(auto=True)``'s dense cache.

    ``PGT_DENSE_SPMM_ENTRIES`` wins when set. On the card: the JAX
    package's memory rule, an eighth of the device's memory over the
    entry size (the cache is streamed every pass; forward, backward and
    activations need the rest), and at most :data:`AUTO_DENSE_MAX_ENTRIES`,
    past which the sweep found the cache slower than the segment-sum
    kernel. Elsewhere (the CPU, under ``PGT_FORCE_DENSE_SPMM``) the JAX
    package's fallback, 2.5e8."""
    env = os.environ.get('PGT_DENSE_SPMM_ENTRIES')
    if env:
        return int(float(env))
    dev = torch.device('cpu' if device is None else device)
    if dev.type == 'cuda':
        total = torch.cuda.get_device_properties(dev).total_memory
        return min(int(total / (8 * max(dtype_bytes, 1))),
                   AUTO_DENSE_MAX_ENTRIES)
    return int(2.5e8)


def chunk_trigger_bytes() -> float:
    """``PGT_SPMM_CHUNK_TRIGGER``, else :data:`CHUNK_TRIGGER_BYTES`."""
    return float(os.environ.get('PGT_SPMM_CHUNK_TRIGGER',
                                CHUNK_TRIGGER_BYTES))


def chunk_edges(f: int) -> int:
    """The chunked regime's edges a chunk: ``PGT_SPMM_CHUNK_BUF`` bytes of
    gathered messages at ``f`` float32 columns, at least 2**16 (JAX
    ``ops/spmm.py:510-511``)."""
    buf = float(os.environ.get('PGT_SPMM_CHUNK_BUF', CHUNK_BUF_BYTES))
    return max(1 << 16, int(buf / max(f * 4, 1)))


def _dense_profitable(adj: EdgeIndex, num_feats: int) -> bool:
    """Whether the uncached dense regime runs (JAX ``ops/spmm.py:110-125``):
    only under ``PGT_FORCE_DENSE_SPMM``, and never under
    ``PGT_DISABLE_DENSE_SPMM``, then by the size rule (``n_src * n_dst``
    within the dense cap and within :data:`DENSE_ADVANTAGE` ``* E * F``).
    The JAX package densifies unforced on the TPU; on the card it never
    pays: rows 'random n=1000 ... n=30000', arm 'dense' of the sweep lost to
    'kernel' at every point, by 5.6x at n=1000 deg=100 F=16 (0.4115 against
    0.0571) up to 100x at n=30000 deg=10 F=128 (6.9423 against 0.0631).
    On the CPU the JAX package's backend gate says the same."""
    if (os.environ.get('PGT_DISABLE_DENSE_SPMM')
            or not os.environ.get('PGT_FORCE_DENSE_SPMM')):
        return False
    entries = adj.num_src_nodes * adj.num_dst_nodes
    return (entries <= dense_cap()
            and entries <= DENSE_ADVANTAGE * adj.num_edges * max(num_feats,
                                                                 1))


def spmm_regime(adj: EdgeIndex, num_feats: int = 64, reduce: str = 'sum',
                has_edge_weight: bool = False) -> str:
    """Which arm :func:`spmm` runs for this adjacency: ``'dense-cached'``,
    ``'bsr'``, ``'dense'``, ``'windowed'``, ``'chunked'``, ``'kernel'``
    (the JAX package's ``'pallas'``) or ``'plain'`` (JAX ``ops/spmm.py:
    65-107``). ``has_edge_weight`` counts weights the EdgeIndex carries, as
    :func:`spmm` applies them."""
    simple = reduce in ('sum', 'mean')
    has_edge_weight = has_edge_weight or adj.weight is not None
    if (adj.dense_adj is not None and simple and not has_edge_weight
            and not os.environ.get('PGT_DISABLE_DENSE_SPMM')):
        return 'dense-cached'
    if (adj.bsr is not None and adj.bsr_t is not None and simple
            and not has_edge_weight
            and not os.environ.get('PGT_DISABLE_BSR_SPMM')):
        return 'bsr'
    if simple and _dense_profitable(adj, num_feats):
        return 'dense'
    if (adj.win is not None and adj.win_t is not None and simple
            and not os.environ.get('PGT_DISABLE_WIN_SPMM')):
        return 'windowed'
    if simple and adj.num_edges * num_feats * 4 > chunk_trigger_bytes():
        return 'chunked'
    if simple and adj.device.type == 'cuda':
        return 'kernel'
    return 'plain'


class _Permuted(torch.autograd.Function):
    """``w[perm]`` for ``perm`` a permutation of ``w``'s positions (an
    orientation's ``perm``); the backward writes ``g`` back through
    ``perm``, one store an edge, where indexing's own backward accumulates
    (a sort of the indices on the card)."""

    @staticmethod
    def forward(ctx, w, perm):
        ctx.save_for_backward(perm)
        return w[perm]

    @staticmethod
    def backward(ctx, g):
        perm, = ctx.saved_tensors
        return torch.empty_like(g).scatter_(0, perm, g), None


def _kernel_spmm(adj: EdgeIndex, x: torch.Tensor,
                 edge_weight: Optional[torch.Tensor],
                 csc: CSR) -> torch.Tensor:
    """Sum over ``csc`` (``adj``'s) through the segment-sum kernel; when
    ``x`` needs a gradient, hand the kernel the CSR as well, for
    ``grad_x = A^T g``. The messages take ``x``'s and the weights' promoted
    dtype, as ``x[src] * w`` does in JAX."""
    dt = x.dtype if edge_weight is None else torch.promote_types(
        x.dtype, edge_weight.dtype)
    x = x.to(dt)
    w = None
    if edge_weight is not None:
        w = (_Permuted.apply(edge_weight, csc.perm)
             if torch.is_grad_enabled() and edge_weight.requires_grad
             else edge_weight[csc.perm]).to(dt).contiguous()
    transpose = None
    if torch.is_grad_enabled() and x.requires_grad:
        csr = adj.get_csr()
        w_t = None if edge_weight is None else \
            edge_weight.detach()[csr.perm].to(dt).contiguous()
        transpose = (csr.indptr, csr.indices, w_t)
    return segment_spmm(csc.indptr, csc.indices, w, x.contiguous(),
                        transpose)


def _residual_pass(res: EdgeIndex, x: torch.Tensor, base: torch.Tensor,
                   csr: bool) -> torch.Tensor:
    """``base + R x`` (``R`` the residual's CSC) or ``base + R^T x`` (its
    CSR, ``csr``) in one segment-sum pass, in the promoted dtype of ``x``
    and the residual's weights, as ``out + res`` promotes. Runs inside
    :class:`_BsrArm`, where autograd records nothing."""
    layout = res.get_csr() if csr else res.get_csc()
    w = res.weight
    dt = x.dtype if w is None else torch.promote_types(x.dtype, w.dtype)
    if w is not None:
        w = w.detach()[layout.perm].to(dt).contiguous()
    return segment_spmm(layout.indptr, layout.indices, w,
                        x.to(dt).contiguous(), base=base.to(dt).contiguous())


class _BsrArm(torch.autograd.Function):
    """The block product plus the residual tail as one pass each way: the
    block kernel's output (its relabel un-done by a gather) is the ``base``
    the segment-sum kernel adds its residual sum to, so no separate add
    runs. Backward: ``bsr_t``'s product of ``g`` (relabelled the same way)
    is the base of the residual's CSR pass. The blocks and the residual's
    weights are constants."""

    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj, ctx.dtype = adj, x.dtype
        xb = x if adj.bsr_perm is None else x[adj.bsr_perm]
        out = bsr_matmul(adj.bsr, xb.contiguous(), adj.num_dst_nodes)
        if adj.bsr_perm is not None:
            # the blocks hold P A P^T: out_old[o] = out_new[inv[o]]
            out = out[adj.bsr_inv]
        if adj.bsr_res is not None:
            out = _residual_pass(adj.bsr_res, x, out, csr=False)
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        adj = ctx.adj
        gb = g if adj.bsr_perm is None else g[adj.bsr_perm]
        grad = bsr_matmul(adj.bsr_t, gb.contiguous(), adj.num_src_nodes)
        if adj.bsr_perm is not None:
            grad = grad[adj.bsr_inv]
        if adj.bsr_res is not None:
            grad = _residual_pass(adj.bsr_res, g, grad, csr=True)
        return grad.to(ctx.dtype), None


def _bsr_arm(adj: EdgeIndex, x: torch.Tensor) -> torch.Tensor:
    """Sum over the baked blocks, un-doing the hubs-first relabel around
    them, plus the residual tail through the segment-sum kernel with the
    block product as its base (:class:`_BsrArm`)."""
    return _BsrArm.apply(x, adj)


def spmm(adj: Union[EdgeIndex, torch.Tensor], x: torch.Tensor,
         edge_weight: Optional[torch.Tensor] = None, reduce: str = 'sum',
         transpose: bool = False) -> torch.Tensor:
    """Aggregate ``x`` over graph edges: ``out[c] = reduce_e w_e * x[r_e]``.

    Runs on the device that ``adj`` and ``x`` lie on; a raw COO becomes an
    ``EdgeIndex`` on ``x``'s device.

    Args:
        adj: ``EdgeIndex`` or raw ``[2, E]`` int tensor (on ``x``'s device).
        x: ``[N_src, F]`` node features.
        edge_weight: optional ``[E]`` weights in COO order.
        reduce: sum | mean | min | max.
        transpose: aggregate onto sources instead of destinations (A^T x).
    """
    if not isinstance(adj, EdgeIndex):
        adj = EdgeIndex(adj, device=x.device)
    if transpose:
        adj = adj.flip()
    if edge_weight is None:
        edge_weight = adj.weight
    num_out = adj.num_dst_nodes
    regime = spmm_regime(adj, x.shape[1], reduce, edge_weight is not None)

    if regime == 'dense-cached':
        out = dense_spmm(adj.dense_adj, adj.dense_scale, x)
        if reduce == 'mean':
            deg = torch.diff(adj.get_csc().indptr).to(x.dtype)
            out = out / deg.clamp(min=1)[:, None]
        return out.to(x.dtype)

    if reduce in ('sum', 'mean'):
        csc = None
        if x.device.type == 'cuda' and not backend.use_kernel_spmm:
            raise RuntimeError(
                'backend.use_kernel_spmm is False, and the port has no other '
                'CUDA arm for a sum or mean past the dense cache; move the '
                'tensors to the CPU to run the plain versions')
        if regime == 'dense':
            w = (edge_weight if edge_weight is not None else
                 torch.ones(adj.num_edges, dtype=x.dtype, device=x.device))
            out = dense_uncached(adj.coo, w, x, adj.num_src_nodes, num_out)
        elif regime == 'chunked':
            out = chunked_spmm(adj.row, adj.col, edge_weight, x, num_out,
                               chunk_edges(x.shape[1]))
        elif regime == 'bsr':
            out = _bsr_arm(adj, x)
        else:
            # 'windowed' (the CSC is a view of its layout), 'kernel', or
            # 'plain' on the CPU: the CSC sum (the segment-sum wrapper runs
            # its plain version on a CPU tensor)
            csc = adj.get_csc()
            out = _kernel_spmm(adj, x, edge_weight, csc)
        if reduce == 'mean':
            deg = _in_degree(adj, csc)
            out = out / deg.to(out.dtype).clamp(min=1)[:, None]
        return out

    src, dst = adj.row.long(), adj.col.long()
    n_src = x.shape[0]
    x_j = x[src.clamp(0, max(n_src - 1, 0))]
    if edge_weight is not None:
        x_j = x_j * edge_weight[:, None]
    return scatter(x_j, dst, num_out, reduce=reduce, mask=src < n_src)


def _in_degree(adj: EdgeIndex, csc: Optional[CSR] = None) -> torch.Tensor:
    """Each destination's edge count: the row pointer of ``csc`` (the one
    the arm summed over) or of the cached CSC, else a count of the
    in-range destinations (out-of-range ones counted in a spare slot past
    the end: no mask, so no host sync)."""
    csc = csc if csc is not None else adj.csc
    if csc is not None:
        return torch.diff(csc.indptr)
    n = adj.num_dst_nodes
    d = adj.col.long()
    key = torch.where((d >= 0) & (d < n), d, n)
    return torch.zeros(n + 1, dtype=torch.int64, device=d.device).scatter_add_(
        0, key, torch.ones_like(key))[:n]
