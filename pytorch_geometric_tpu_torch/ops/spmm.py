"""Sparse (adjacency) x dense (features) matmul.

Counterpart of ``pytorch_geometric_tpu/ops/spmm.py``:
``out[dst] = reduce over incoming edges of edge_weight * x[src]``.

The ladder has four arms in the port so far, checked in the JAX package's
order:

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

A block-sparse cache runs the ``'bsr'`` arm on the CPU too, through the
kernels' plain versions. A sum/mean on a CUDA tensor with
``backend.use_kernel_spmm = False`` raises: the plain version never stands in
for a kernel on the card.

The uncached dense, windowed and chunked regimes are not ported yet (ROADMAP
Queue 1, item 3).
"""

from typing import Optional, Union

import torch

from .. import backend
from ..edge_index import CSR, EdgeIndex
from .bsr_spmm import bsr_matmul
from .dense_spmm import dense_spmm
from .scatter import scatter
from .segment_spmm import segment_spmm


def spmm_regime(adj: EdgeIndex, num_feats: int = 64, reduce: str = 'sum',
                has_edge_weight: bool = False) -> str:
    """Which arm :func:`spmm` runs for this adjacency: ``'dense-cached'``,
    ``'bsr'``, ``'kernel'`` (the JAX package's ``'pallas'``) or
    ``'plain'``. ``num_feats`` is accepted for signature parity with the
    JAX package and does not change the arm."""
    del num_feats
    simple = reduce in ('sum', 'mean')
    if adj.dense_adj is not None and simple and not has_edge_weight:
        return 'dense-cached'
    if (adj.bsr is not None and adj.bsr_t is not None and simple
            and not has_edge_weight):
        return 'bsr'
    if simple and adj.device.type == 'cuda':
        return 'kernel'
    return 'plain'


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
    w = None if edge_weight is None else \
        edge_weight[csc.perm].to(dt).contiguous()
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
        if x.device.type == 'cuda' and not backend.use_kernel_spmm:
            raise RuntimeError(
                'backend.use_kernel_spmm is False, and the port has no other '
                'CUDA arm for a sum or mean yet; move the tensors to the CPU '
                'to run the plain versions')
        # 'kernel', or 'plain' on the CPU: the CSC sum (the segment-sum
        # wrapper runs its plain version on a CPU tensor)
        csc = (adj.get_csc() if regime != 'bsr' or reduce == 'mean'
               else None)
        out = (_bsr_arm(adj, x) if regime == 'bsr'
               else _kernel_spmm(adj, x, edge_weight, csc))
        if reduce == 'mean':
            deg = torch.diff(csc.indptr).to(out.dtype)
            out = out / deg.clamp(min=1)[:, None]
        return out

    src, dst = adj.row.long(), adj.col.long()
    n_src = x.shape[0]
    x_j = x[src.clamp(0, max(n_src - 1, 0))]
    if edge_weight is not None:
        x_j = x_j * edge_weight[:, None]
    return scatter(x_j, dst, num_out, reduce=reduce, mask=src < n_src)
