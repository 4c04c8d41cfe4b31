"""The dense adjacency: the cached one (its build, the int8 factorisation,
and the three matrix products of the ``'dense-cached'`` SpMM arm) and the
uncached ``'dense'`` regime, which builds it in every call.

Counterpart of the dense cache of ``pytorch_geometric_tpu/edge_index.py:
364-413`` and of the ``'dense-cached'`` arm of ``ops/spmm.py:371-417``. The
JAX package leaves these products to XLA's matmuls, outside any Pallas
kernel; the port leaves them to PyTorch's:

  * float32: ``torch.mm`` (full float32 while TF32 is off, PyTorch's
    default for matmuls);
  * bfloat16: bf16 operands, float32 products and sums, a float32 result,
    as ``jnp.matmul(dense, x.astype(bf16), preferred_element_type=f32)``:
    on the card ``torch.mm(..., out_dtype=torch.float32)``, on the CPU
    (which has no ``aten::mm.dtype``) the same products in float32, exact
    since two bf16 values multiply exactly in float32. Differentiable in
    ``x``: ``grad_x`` is ``A^T g`` rounded through bf16, as ``jax.grad``
    rounds the cotangent of the bf16 operand;
  * int8: ``A ~= diag(r) Q diag(c)``; ``c * x`` is quantised per tensor to
    int8, ``Q @ xq`` runs int8 x int8 -> int32 (``torch._int_mm``), and the
    result is rescaled. Inference only: no gradient flows.

The build is one float32 scatter-add of the weights into ``[n_dst, n_src]``
on the EdgeIndex's device (padded edges dropped), then the cast or the
factorisation.

The uncached regime (``_dense_spmm`` / ``_dense_build`` / ``_dense_spmm_bwd``,
JAX ``ops/spmm.py:128-182``, :func:`dense_uncached`) builds ``A`` in every
call and runs one ``torch.mm``: a plain large product, left to the library
as the JAX package leaves it to XLA (full float32 while TF32 is off; the
JAX package runs bf16x3 on the TPU). Its backward is ``grad_x = A^T g``
(one more ``torch.mm`` over the saved ``A``) and ``grad_w[e] = <x[src_e],
g[dst_e]>`` on the per-edge dot kernel (``ops/edge_dot.py``), 0 for an edge
with an endpoint out of range.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .edge_dot import edge_dot


def dense_build(coo: torch.Tensor, w: torch.Tensor, n_src: int,
                n_dst: int) -> torch.Tensor:
    """``A [n_dst, n_src]`` float32, ``A[d, s] = sum of w over the edges
    (s -> d)``; edges with an endpoint past its size are dropped
    (``_dense_build``, ``ops/spmm.py:139-146``)."""
    src, dst = coo[0].long(), coo[1].long()
    valid = (src < n_src) & (dst < n_dst)
    a = torch.zeros(n_dst * n_src, dtype=torch.float32, device=coo.device)
    a.index_add_(0, (dst * n_src + src)[valid],
                 w.to(device=coo.device, dtype=torch.float32)[valid])
    return a.view(n_dst, n_src)


def quantize_two_sided(a: torch.Tensor
                       ) -> Tuple[torch.Tensor,
                                  Tuple[torch.Tensor, torch.Tensor]]:
    """``(Q int8, (r, c))`` with ``A ~= diag(r) Q diag(c)``: the row scale
    ``r = sqrt(max_j |A_ij|)``, the column scale ``c = max_i |A_ij / r_i| /
    127``, zero for an empty row or column (``edge_index.py:401-411``).
    Overwrites ``a`` (float32) to spare the ``[n_dst, n_src]``
    temporaries."""
    rowmax = a.abs().amax(1)
    r = torch.where(rowmax > 0, torch.sqrt(rowmax), 0.0)
    a.div_(torch.where(r > 0, r, 1.0)[:, None])
    colmax = a.abs().amax(0)
    c = torch.where(colmax > 0, colmax / 127.0, 0.0)
    a.div_(torch.where(c > 0, c, 1.0)[None, :]).round_().clamp_(-127, 127)
    return a.to(torch.int8), (r, c)


def build_dense_cache(coo: torch.Tensor, w: torch.Tensor, n_src: int,
                      n_dst: int, cache_dtype=None
                      ) -> Tuple[torch.Tensor,
                                 Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """``(dense_adj, dense_scale)`` for ``fill_cache``: built in float32
    (duplicate edges must not round), then stored as ``cache_dtype``."""
    a = dense_build(coo, w, n_src, n_dst)
    if cache_dtype == torch.int8:
        return quantize_two_sided(a)
    if cache_dtype == torch.bfloat16:
        return a.to(torch.bfloat16), None
    return a, None


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` from bf16 operands with float32 products, sums and
    result."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _DenseBf16(torch.autograd.Function):
    """``dense @ bf16(x)`` with a float32 result; ``grad_x = bf16(A^T g)``
    in ``x``'s dtype. ``g`` enters the bf16 product as two bf16 halves side
    by side (``g ~= hi + lo``), so the cache is read once and ``A^T g``
    keeps about 16 bits of ``g`` before its one rounding to bf16."""

    @staticmethod
    def forward(ctx, x, dense):
        ctx.dense, ctx.x_dtype = dense, x.dtype
        return _mm_bf16(dense, x.to(torch.bfloat16))

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        f = g.shape[1]
        hi = g.to(torch.bfloat16)
        lo = (g - hi.float()).to(torch.bfloat16)
        both = _mm_bf16(ctx.dense.t(), torch.cat([hi, lo], 1))
        gx = both[:, :f] + both[:, f:]
        return gx.to(torch.bfloat16).to(ctx.x_dtype), None


def _int_mm(q: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """``q [m, k] @ xq [k, n]``, int8 x int8 -> int32. On the card the
    operands take the layout its int8 matmul needs: ``q`` row-major with
    ``m > 16`` and ``k % 8 == 0``, ``xq`` column-major with ``n % 8 == 0``,
    zero-padded where they fall short (the padding adds nothing)."""
    if not q.is_cuda:
        return torch._int_mm(q, xq)
    m, k = q.shape
    n = xq.shape[1]
    mp, kp, np_ = (m if m > 16 else 24), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k) or not q.is_contiguous():
        q = F.pad(q, (0, kp - k, 0, mp - m)).contiguous()
    xt = F.pad(xq.t(), (0, kp - k, 0, np_ - n)).contiguous()
    return torch._int_mm(q, xt.t())[:m, :n]


def dense_int8(q: torch.Tensor, scale: Tuple[torch.Tensor, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """``r * (Q @ quant(c * x))``, float32, no gradient
    (``ops/spmm.py:375-393``): ``c * x`` quantised per tensor to int8 with
    its largest magnitude at 127, round half to even."""
    r, c = scale
    with torch.no_grad():
        xs = x.detach().float() * c[:, None]
        x_scale = torch.clamp(xs.abs().max(), min=1e-30) / 127.0
        xq = torch.clamp(torch.round(xs / x_scale), -127, 127).to(
            torch.int8)
        acc = _int_mm(q, xq)
        return acc.float() * (x_scale * r[:, None])


def dense_spmm(dense: torch.Tensor,
               scale: Optional[Tuple[torch.Tensor, torch.Tensor]],
               x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over a dense cache, before the mean and the cast back to
    ``x``'s dtype: float32 for the bf16 and int8 caches, the cache's dtype
    otherwise."""
    if dense.dtype == torch.int8:
        return dense_int8(dense, scale, x)
    if dense.dtype == torch.bfloat16:
        return _DenseBf16.apply(x, dense)
    return torch.mm(dense, x.to(dense.dtype))


class _DenseUncached(torch.autograd.Function):
    """``A @ x`` with ``A`` built from ``(coo, w)`` in the call, in ``x``'s
    dtype; ``A`` is kept for ``grad_x = A^T g``, and ``grad_w`` is the
    per-edge dot of ``x`` and ``g``. The COO is a constant."""

    @staticmethod
    def forward(ctx, x, w, coo, n_src, n_dst):
        a = dense_build(coo, w.detach(), n_src, n_dst).to(x.dtype)
        ctx.save_for_backward(a, x if ctx.needs_input_grad[1] else None, coo)
        ctx.w_dtype = w.dtype
        return torch.mm(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x, coo = ctx.saved_tensors
        g = g.contiguous()
        grad_x = grad_w = None
        if ctx.needs_input_grad[0]:
            grad_x = torch.mm(a.t(), g)
        if ctx.needs_input_grad[1]:
            grad_w = edge_dot(x.contiguous(), g, coo[0], coo[1]).to(
                ctx.w_dtype)
        return grad_x, grad_w, None, None, None


def dense_uncached(coo: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                   n_src: int, n_dst: int) -> torch.Tensor:
    """The ``'dense'`` regime: ``A @ x`` with ``A[d, s]`` the sum of ``w``
    over the edges ``s -> d`` built in this call (edges with an endpoint
    out of range dropped); differentiable in ``x`` and ``w``."""
    return _DenseUncached.apply(x, w, coo, n_src, n_dst)
