"""The chunked SpMM regime.

Counterpart of ``_chunk_pass`` / ``_chunked_spmm`` (JAX ``ops/spmm.py:
184-266``). The JAX package scans the edges in chunks so that no ``[E, F]``
array of gathered messages is ever made. On the card the sums run on the
segment-sum kernel (kernel 1, ``ops/segment_spmm.py``), which gathers each
message into registers, and the weight gradients on the per-edge dot
kernel (``ops/edge_dot.py``), which writes one value per edge:
:func:`chunked_spmm` takes the raw COO ``chunk`` edges at a time, sorts
each chunk by destination on the device and sums it by kernel 1 onto the
accumulator through its ``base`` operand; the backward does the same with
the roles swapped for ``grad_x``, and runs the dot kernel chunk by chunk
for ``grad_w``. Past the accumulators, the memory a pass holds is one
chunk's sort.

The windowed regime (JAX ``_win_pass`` / ``_windowed_spmm``, ``:270-336``)
needs no module of its own: its layout's first ``E`` slots are the CSC's
own arrays (``edge_index._on_layout``), so ``ops/spmm.py`` runs it as the
kernel regime over them.

Weights are per edge in COO order, or ``None`` (all ones). The messages take
``x``'s and the weights' promoted dtype, as ``x[src] * w`` does in JAX; the
result has that dtype. On CPU tensors the kernels' wrappers run their plain
versions; on CUDA tensors they launch the kernels or raise.
"""

from typing import Optional

import torch

from .edge_dot import edge_dot
from .segment_spmm import segment_spmm


def _promoted(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.dtype:
    return x.dtype if w is None else torch.promote_types(x.dtype, w.dtype)


def chunk_pass(src: torch.Tensor, dst: torch.Tensor,
               w: Optional[torch.Tensor], x: torch.Tensor, num_out: int,
               chunk: int) -> torch.Tensor:
    """``sum_e w_e * x[src_e]`` into ``out[dst_e]``, ``chunk`` edges at a
    time (``_chunk_pass``): each chunk sorted by destination (out of range
    sorts last and drops out), summed onto the accumulator as kernel 1's
    ``base``. Sources out of range add nothing. Not differentiable:
    :func:`chunked_spmm` wraps it."""
    dt = _promoted(x, w)
    x = x.to(dt).contiguous()
    rows = torch.arange(num_out + 1, device=x.device)
    acc = None
    for c0 in range(0, src.shape[0], chunk):
        d = dst[c0:c0 + chunk].long()
        key = torch.where((d >= 0) & (d < num_out), d, num_out)
        key, order = torch.sort(key, stable=True)
        indptr = torch.searchsorted(key, rows).to(torch.int32)
        s = src[c0:c0 + chunk][order].to(torch.int32)
        ww = (None if w is None
              else w[c0:c0 + chunk].detach()[order].to(dt))
        acc = segment_spmm(indptr, s, ww, x, base=acc)
    if acc is None:
        acc = x.new_zeros((num_out, x.shape[1]))
    return acc


class _ChunkedSpmm(torch.autograd.Function):
    """``A x`` over the COO in chunks; ``grad_x`` the same pass with the
    roles swapped, ``grad_w`` the dot kernel chunk by chunk."""

    @staticmethod
    def forward(ctx, x, w, src, dst, num_out, chunk):
        ctx.chunk, ctx.dtypes = chunk, (x.dtype, None if w is None
                                        else w.dtype)
        ctx.save_for_backward(x, None if w is None else w.detach(), src, dst)
        return chunk_pass(src, dst, w, x, num_out, chunk)

    @staticmethod
    def backward(ctx, g):
        x, w, src, dst = ctx.saved_tensors
        g = g.contiguous()
        grad_x = grad_w = None
        if ctx.needs_input_grad[0]:
            grad_x = chunk_pass(dst, src, w, g, x.shape[0], ctx.chunk).to(
                ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            xg = x.to(g.dtype).contiguous()
            grad_w = torch.cat([
                edge_dot(xg, g, src[c0:c0 + ctx.chunk],
                         dst[c0:c0 + ctx.chunk])
                for c0 in range(0, src.shape[0], ctx.chunk)]
                or [g.new_zeros(0)]).to(ctx.dtypes[1])
        return grad_x, grad_w, None, None, None, None


def chunked_spmm(src: torch.Tensor, dst: torch.Tensor,
                 w: Optional[torch.Tensor], x: torch.Tensor, num_out: int,
                 chunk: int) -> torch.Tensor:
    """``out = A x`` over the raw COO ``(src, dst)``, ``chunk`` edges at a
    time (``_chunked_spmm``), ``w`` per-edge [E] weights or ``None``;
    differentiable in ``x`` and ``w``."""
    return _ChunkedSpmm.apply(x, w, src, dst, num_out, chunk)
