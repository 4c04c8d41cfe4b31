"""Segment-sum SpMM over a destination-sorted CSC: the hand-written Hopper
kernel, its plain PyTorch version and its launch count.

Counterpart of ``pytorch_geometric_tpu/ops/pallas_spmm.py``. The function

    out[d, :] = sum_{k = indptr[d]}^{indptr[d+1]-1} w[k] * x[src[k], :]

replaces the TPU kernel ``_chunk_kernel`` (``ops/pallas_spmm.py:74``,
launched at ``:132`` by ``segment_sum_sorted`` and at ``:212`` by
``segment_sum_blocked``, both reached from ``spmm_pallas``) together with
its XLA segment-sum epilogue and the ``x[src] * w`` gather before it.

Bound on the card: bytes. The least traffic is x, the indices, the weights
and out, each moved once: ``(n_src * F + n_dst * F) * 4 + E * 8 +
(n_dst + 1) * 4`` bytes over 3.35 TB/s (an H100 SXM's HBM rate). The
operations (``2 * E * F`` float32 FLOPs) are far below the card's 67 TFLOP/s.
The TPU kernel turns the scatter into one-hot matmuls for the MXU; on Hopper
that would only add work, so the kernel (``csrc/segment_spmm.cu``) reads the
CSC directly: one warp (or, for narrow F, a few lanes) per destination row,
16-byte row loads, f32 accumulators in registers, each output row written
once, no atomics, so the sum is deterministic. x (15 MB at the serving
shape) stays in the 50 MB L2, so the ``E * F`` gathered reads mostly hit L2.
Measured times against this bound are in PERF.md.

Two arms, as the TPU kernel streams float32 or bf16 messages: float32 x
(weights float32 or absent), and bf16 x (weights bf16 or absent), whose
messages are ``bf16(x[src] * w)`` summed in float32 and rounded to bf16 once
(``ops/pallas_spmm.py:199-229``); each counts its own launches
(``segment_spmm.launches``, ``segment_spmm.launches_bf16``).

The wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors; it never falls back from one to the other. Given the same
matrix in source-major order (``transpose``), it is differentiable:
``grad_x = A^T g`` is the same kernel over that CSR, as the JAX package's
``_spmm_blocked_bwd`` (``ops/pallas_spmm.py:267-277``) runs its kernel over
the transposed layout, and ``grad_w[e] = <x[src_e], g[dst_e]>`` is plain
PyTorch, as the JAX package leaves it to XLA (``:278-281``).
"""

import ctypes
from typing import Optional, Tuple

import torch

from .segment import ptr2index


def segment_spmm_plain(indptr: torch.Tensor, src: torch.Tensor,
                       w: Optional[torch.Tensor],
                       x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: gather, multiply (in x's dtype, so a bf16
    message is rounded as the kernel rounds it), ``index_add_`` in float32,
    the result in x's dtype.

    Edges past ``indptr[-1]`` (padding) are not read; an edge whose source
    lies outside ``[0, x.shape[0])`` contributes nothing."""
    n_dst = indptr.shape[0] - 1
    n_src = x.shape[0]
    e = min(int(indptr[-1]), src.shape[0])
    s = src[:e].long()
    dst = ptr2index(indptr.long(), e)
    valid = (s >= 0) & (s < n_src)
    msg = x[s.clamp(0, max(n_src - 1, 0))] if n_src > 0 else \
        x.new_zeros((e, x.shape[1]))
    if w is not None:
        msg = msg * w[:e, None]
    msg = torch.where(valid[:, None], msg, 0.0).float()
    out = msg.new_zeros((n_dst, x.shape[1])).index_add_(0, dst, msg)
    return out.to(x.dtype)


def _check(indptr, src, w, x):
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'segment_spmm takes float32 or bfloat16 x, got '
                        f'{x.dtype}')
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError('segment_spmm takes a contiguous 2-D x, got shape '
                         f'{tuple(x.shape)} strides {x.stride()}')
    for name, t, dt in (('indptr', indptr, torch.int32),
                        ('src', src, torch.int32), ('w', w, x.dtype)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f'segment_spmm: {name} is on {t.device}, x on '
                             f'{dev}')
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f'segment_spmm takes a contiguous 1-D {dt} '
                             f'{name}, got {t.dtype} shape '
                             f'{tuple(t.shape)}')
    if indptr.shape[0] < 1:
        raise ValueError('segment_spmm: indptr needs n_dst + 1 >= 1 entries')
    if w is not None and w.shape[0] != src.shape[0]:
        raise ValueError(f'segment_spmm: w has {w.shape[0]} entries, src '
                         f'{src.shape[0]}')


def _kernel(arm: str):
    """The library's entry point of ``arm``, 'f32' or 'bf16'."""
    from .. import csrc
    v, ll = ctypes.c_void_p, ctypes.c_longlong
    return csrc.function('segment_spmm', f'pgt_segment_spmm_{arm}',
                         [v, v, v, v, v, ll, ll, ll, ll, v])


def _launch(indptr: torch.Tensor, src: torch.Tensor,
            w: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """One pass: the plain version for a CPU tensor, the kernel of x's
    dtype (built at first use) for a CUDA tensor, counted in
    ``segment_spmm.launches`` (float32) or ``segment_spmm.launches_bf16``."""
    if x.device.type == 'cpu':
        return segment_spmm_plain(indptr, src, w, x)
    if x.device.type != 'cuda':
        raise ValueError(f'segment_spmm runs on cpu or cuda, not {x.device}')
    bf16 = x.dtype == torch.bfloat16
    fn = _kernel('bf16' if bf16 else 'f32')
    n_dst = indptr.shape[0] - 1
    out = torch.empty((n_dst, x.shape[1]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(indptr.data_ptr(), src.data_ptr(),
                 None if w is None else w.data_ptr(), x.data_ptr(),
                 out.data_ptr(), n_dst, x.shape[0], x.shape[1],
                 src.shape[0], stream)
    if err != 0:
        raise RuntimeError(f'segment_spmm kernel launch failed: CUDA error '
                           f'{err}')
    if bf16:
        segment_spmm.launches_bf16 += 1
    else:
        segment_spmm.launches += 1
    return out


def _edge_dot(indptr: torch.Tensor, src: torch.Tensor, x: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """``grad_w[k] = <x[src[k]], g[dst[k]]>`` per CSC slot; 0 for padded
    slots and sources outside ``[0, n_src)``."""
    n_dst, n_src = g.shape[0], x.shape[0]
    if n_dst == 0 or n_src == 0:
        return x.new_zeros(src.shape[0])
    dst = ptr2index(indptr.long(), src.shape[0])
    s = src.long()
    valid = (dst < n_dst) & (s >= 0) & (s < n_src)
    dot = (x[s.clamp(0, n_src - 1)] * g[dst.clamp(max=n_dst - 1)]).sum(-1)
    return torch.where(valid, dot, 0.0)


class _SegmentSpmm(torch.autograd.Function):
    """The kernel pass with its backward: ``grad_x`` through the kernel over
    the source-major CSR, ``grad_w`` as a per-edge dot, each only when
    needed."""

    @staticmethod
    def forward(ctx, x, w, indptr, src, transpose):
        ctx.transpose = transpose
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              indptr, src)
        return _launch(indptr, src, w, x)

    @staticmethod
    def backward(ctx, g):
        x, indptr, src = ctx.saved_tensors
        g = g.contiguous()
        grad_x = grad_w = None
        if ctx.needs_input_grad[0]:
            grad_x = _launch(*ctx.transpose, g)
        if ctx.needs_input_grad[1]:
            grad_w = _edge_dot(indptr, src, x, g)
        return grad_x, grad_w, None, None, None


def segment_spmm(indptr: torch.Tensor, src: torch.Tensor,
                 w: Optional[torch.Tensor], x: torch.Tensor,
                 transpose: Optional[Tuple[torch.Tensor, torch.Tensor,
                                           Optional[torch.Tensor]]] = None
                 ) -> torch.Tensor:
    """``out[d] = sum_{k in [indptr[d], indptr[d+1])} w[k] * x[src[k]]``.

    ``indptr [n_dst + 1]`` int32, ``src [E]`` int32, ``x [n_src, F]``
    float32 or bfloat16 and ``w [E]`` of x's dtype or ``None`` (all ones),
    all contiguous and on one device; the result has x's dtype. A CPU
    tensor runs :func:`segment_spmm_plain`; a CUDA tensor launches the
    kernel (built at first use) or raises.

    ``transpose = (indptr_t [n_src + 1], dst_t [E], w_t [E] or None)``: the
    same matrix in source-major order, with ``w_t`` the weights in that
    order. It is needed when ``x`` requires a gradient; ``w`` may require
    one without it."""
    _check(indptr, src, w, x)
    needs_x = x.requires_grad
    needs_w = w is not None and w.requires_grad
    if not torch.is_grad_enabled() or not (needs_x or needs_w):
        return _launch(indptr, src, w, x)
    if needs_x:
        if transpose is None:
            raise ValueError(
                'segment_spmm: x requires a gradient, so pass transpose='
                '(indptr_t, dst_t, w_t), the matrix in source-major order')
        t_indptr, t_dst, t_w = transpose
        if t_indptr.shape[0] != x.shape[0] + 1:
            raise ValueError(f'segment_spmm: transpose indptr has '
                             f'{t_indptr.shape[0]} entries for '
                             f'{x.shape[0]} sources')
        _check(t_indptr, t_dst, t_w, x)
        if t_w is not None and t_w.requires_grad:
            raise ValueError('segment_spmm: the transposed weights are '
                             'constants; pass w_t detached')
    return _SegmentSpmm.apply(x, w, indptr, src, transpose)


segment_spmm.launches = 0
segment_spmm.launches_bf16 = 0
