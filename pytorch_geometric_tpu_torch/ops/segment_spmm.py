"""Segment-sum SpMM over a destination-sorted CSC: the hand-written Hopper
kernel, its launch plan, its plain PyTorch version and its launch count.

Counterpart of ``pytorch_geometric_tpu/ops/pallas_spmm.py``. The function

    out[d, :] = base[d, :] + sum_{k = indptr[d]}^{indptr[d+1]-1} w[k] * x[src[k], :]

(``base`` optional, zeros when absent) replaces the TPU kernel
``_chunk_kernel`` (``ops/pallas_spmm.py:74``, launched at ``:132`` by
``segment_sum_sorted`` and at ``:212`` by ``segment_sum_blocked``, both
reached from ``spmm_pallas``) together with its XLA segment-sum epilogue and
the ``x[src] * w`` gather before it; ``base`` is the JAX package's ``out +
segment_sum(...)`` of the block-sparse arm's residual
(``pytorch_geometric_tpu/ops/spmm.py:435-441``), which XLA fuses into one
pass.

Bound on the card: bytes. The least traffic is x, base and out, the indices
and the weights, each moved once: ``(n_src * F + 2 * n_dst * F) * 4 + E * 8 +
(n_dst + 1) * 4`` bytes (without base one ``n_dst * F`` term less) over 3.35
TB/s (an H100 SXM's HBM rate). The operations (``2 * E * F`` float32 FLOPs)
are far below the card's 67 TFLOP/s. The kernel (``csrc/segment_spmm.cu``)
reads the CSC directly and gathers one x row per edge; where x fits in the 50
MB L2 (serving, path B) those gathers are L2 traffic. Its launch plan
(:func:`segment_plan`) sets the load width, the lanes that cover a row's
columns, the lane groups that split a row's edge run (their partials added
in a fixed shuffle tree, so the result is deterministic), the rows a warp
serves, and whether the warp stages the edge indices and hands them out by
shuffles (narrow rows) or each lane group loads its own (wide rows).
Measured times against the bound are in PERF.md.

Two arms, as the TPU kernel streams float32 or bf16 messages: float32 x
(weights float32 or absent), and bf16 x (weights bf16 or absent), whose
messages are ``bf16(x[src] * w)`` summed in float32 (``base`` widened and
added) and rounded to bf16 once (``ops/pallas_spmm.py:199-229``); each
counts its own launches (``segment_spmm.launches``,
``segment_spmm.launches_bf16``).

The wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors; it never falls back from one to the other. Given the same
matrix in source-major order (``transpose``), it is differentiable:
``grad_x = A^T g`` is the same kernel over that CSR, as the JAX package's
``_spmm_blocked_bwd`` (``ops/pallas_spmm.py:267-277``) runs its kernel over
the transposed layout, ``grad_w[e] = <x[src_e], g[dst_e]>`` is plain
PyTorch, as the JAX package leaves it to XLA (``:278-281``), and ``base``'s
gradient is ``g`` itself.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .segment import ptr2index

# the load widths (values a lane moves at once) of each arm, widest first:
# 16, 8 or 4 bytes for float32; 16 or 8 bytes for bf16, else scalars
VEC_WIDTHS = {4: (4, 2, 1), 2: (8, 4, 1)}
# the widest lane group whose team stages the (src, w) pairs through the
# warp and may split a row's edge run; wider groups load their own pairs
# (one address a group, served by L1), one group a row: the shape that
# measured faster for them (chip_smoke.py's sweep, PERF.md)
STAGED_MAX_LANES = 8
# the mean edges per lane group at which a staged row's edge run is split: a
# row of the mean length gets the most lane groups (a power of two, the team
# at most a warp) that leave each group at least this many of its edges.
# From the sweep: at serving F = 16 (34 edges a row) two groups beat one and
# four, at path B's F = 10 (21 a row) two beat one and four, at path A's
# residual (2 a row) one beats two
MIN_GROUP_RUN = 10


class SegmentPlan(NamedTuple):
    """How the kernel runs one call: loads of ``vec`` values, ``lanes``
    lanes across a row's columns, ``groups`` lane groups splitting a row's
    edges, ``rows_per_warp`` rows a warp (``lanes * groups * rows_per_warp
    = 32``); ``staged`` 1: the (src, w) pairs staged by the warp and handed
    out by shuffles, 0: each lane group loads its own. Both modes take the
    same sums in the same order."""
    vec: int
    lanes: int
    groups: int
    rows_per_warp: int
    staged: int = 1


def segment_plan(f: int, itemsize: int, n_dst: int, n_edges: int,
                 x_ptr: int, out_ptr: int, base_ptr: int = 0
                 ) -> SegmentPlan:
    """The kernel's launch plan for ``F = f`` columns of ``itemsize``-byte
    values (4: float32, 2: bf16) over ``n_edges`` edges into ``n_dst``
    rows, with x, out and base (0: none) at these addresses.

    ``vec``: the widest load of :data:`VEC_WIDTHS` that divides F and to
    which every pointer is aligned. ``lanes``: the least power of two that
    covers the row's ``ceil(f / vec)`` vectors, at most 32 (wider rows take
    several column passes). ``staged``: 1 up to :data:`STAGED_MAX_LANES`
    lanes a group. ``groups``: 1 in the direct mode; staged, doubled while
    the team stays within a warp and a row of the mean length ``n_edges /
    n_dst`` leaves each group at least :data:`MIN_GROUP_RUN` edges."""
    # the pointers' common alignment, up to the widest load (16 bytes)
    ptrs = x_ptr | out_ptr | base_ptr | 16
    return _plan(f, itemsize, n_dst, n_edges, ptrs & -ptrs)


@functools.lru_cache(maxsize=256)
def _plan(f: int, itemsize: int, n_dst: int, n_edges: int,
          align: int) -> SegmentPlan:
    if itemsize not in VEC_WIDTHS:
        raise ValueError(f'segment_plan: no kernel arm for {itemsize}-byte '
                         'values')
    vec = next(v for v in VEC_WIDTHS[itemsize]
               if f % v == 0 and align % (v * itemsize) == 0)
    vectors = -(-max(f, 1) // vec)
    lanes = 1
    while lanes < min(vectors, 32):
        lanes *= 2
    staged = lanes <= STAGED_MAX_LANES
    mean = n_edges / max(n_dst, 1)
    groups = 1
    while (staged and lanes * groups < 32
           and mean >= MIN_GROUP_RUN * 2 * groups):
        groups *= 2
    return SegmentPlan(vec, lanes, groups, 32 // (lanes * groups),
                       int(staged))


def check_plan(plan, f: int, itemsize: int, ptrs) -> SegmentPlan:
    """``plan`` as a :class:`SegmentPlan` if it tiles a warp for this call
    (the rules the kernel's entry points apply), else ``ValueError``:
    powers of two with ``lanes * groups * rows_per_warp = 32``, ``vec`` one
    of the arm's widths, dividing F, every pointer of ``ptrs`` (0: absent)
    aligned to it."""
    plan = SegmentPlan(*plan)
    vec, lanes, groups, rows, staged = plan
    pow2 = all(v >= 1 and v & (v - 1) == 0 for v in plan[:4])
    if not pow2 or lanes * groups * rows != 32 or staged not in (0, 1):
        raise ValueError(f'segment_spmm: the plan {tuple(plan)} does not '
                         'tile a warp (powers of two with lanes * groups * '
                         'rows_per_warp = 32, staged 0 or 1)')
    if vec not in VEC_WIDTHS.get(itemsize, ()):
        raise ValueError(f'segment_spmm: no {vec}-wide loads for '
                         f'{itemsize}-byte values')
    if f % vec or any(p % (vec * itemsize) for p in ptrs):
        raise ValueError(f'segment_spmm: {vec}-wide loads need F ({f}) and '
                         'every row pointer aligned to them')
    return plan


def segment_spmm_plain(indptr: torch.Tensor, src: torch.Tensor,
                       w: Optional[torch.Tensor], x: torch.Tensor,
                       base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: gather, multiply (in x's dtype, so a bf16
    message is rounded as the kernel rounds it), ``index_add_`` in float32,
    ``base`` (widened) added to the finished sum, the result in x's dtype.

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
    if base is not None:
        out = out + base.float()
    return out.to(x.dtype)


def _check(indptr, src, w, x, base=None):
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
    if base is not None:
        want = (indptr.shape[0] - 1, x.shape[1])
        if (base.device != dev or base.dtype != x.dtype
                or tuple(base.shape) != want or not base.is_contiguous()):
            raise ValueError(f'segment_spmm takes a contiguous {x.dtype} '
                             f'base of shape {want} on {dev}, got '
                             f'{base.dtype} shape {tuple(base.shape)} on '
                             f'{base.device}')


def _kernel(arm: str):
    """The library's entry point of ``arm``, 'f32' or 'bf16'."""
    from .. import csrc
    v, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return csrc.function('segment_spmm', f'pgt_segment_spmm_{arm}',
                         [v] * 6 + [ll] * 4 + [i] * 5 + [v])


def _launch(indptr: torch.Tensor, src: torch.Tensor,
            w: Optional[torch.Tensor], x: torch.Tensor,
            base: Optional[torch.Tensor] = None,
            plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """One pass: the plain version for a CPU tensor, the kernel of x's
    dtype (built at first use) under ``plan`` (None: :func:`segment_plan`)
    for a CUDA tensor, counted in ``segment_spmm.launches`` (float32) or
    ``segment_spmm.launches_bf16``."""
    n_dst, f = indptr.shape[0] - 1, x.shape[1]
    ptrs = (x.data_ptr(), 0 if base is None else base.data_ptr())
    if plan is not None:
        # the output is fresh, so it is aligned as far as any plan needs
        plan = check_plan(plan, f, x.element_size(), ptrs)
    if x.device.type == 'cpu':
        return segment_spmm_plain(indptr, src, w, x, base)
    if x.device.type != 'cuda':
        raise ValueError(f'segment_spmm runs on cpu or cuda, not {x.device}')
    bf16 = x.dtype == torch.bfloat16
    fn = _kernel('bf16' if bf16 else 'f32')
    out = torch.empty((n_dst, f), dtype=x.dtype, device=x.device)
    if plan is None:
        plan = segment_plan(f, x.element_size(), n_dst, src.shape[0],
                            ptrs[0], out.data_ptr(), ptrs[1])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(indptr.data_ptr(), src.data_ptr(),
                 None if w is None else w.data_ptr(), x.data_ptr(),
                 None if base is None else base.data_ptr(), out.data_ptr(),
                 n_dst, x.shape[0], f, src.shape[0], *plan, stream)
    if err != 0:
        raise RuntimeError(f'segment_spmm kernel launch failed under the plan '
                           f'{tuple(plan)}: CUDA error {err}')
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
    the source-major CSR, ``grad_w`` as a per-edge dot, ``grad_base = g``,
    each only when needed."""

    @staticmethod
    def forward(ctx, x, w, base, indptr, src, transpose, plan):
        ctx.transpose = transpose
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              indptr, src)
        return _launch(indptr, src, w, x, base, plan)

    @staticmethod
    def backward(ctx, g):
        x, indptr, src = ctx.saved_tensors
        g = g.contiguous()
        grad_x = grad_w = None
        if ctx.needs_input_grad[0]:
            grad_x = _launch(*ctx.transpose, g)
        if ctx.needs_input_grad[1]:
            grad_w = _edge_dot(indptr, src, x, g)
        grad_base = g if ctx.needs_input_grad[2] else None
        return grad_x, grad_w, grad_base, None, None, None, None


def segment_spmm(indptr: torch.Tensor, src: torch.Tensor,
                 w: Optional[torch.Tensor], x: torch.Tensor,
                 transpose: Optional[Tuple[torch.Tensor, torch.Tensor,
                                           Optional[torch.Tensor]]] = None,
                 base: Optional[torch.Tensor] = None,
                 plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """``out[d] = base[d] + sum_{k in [indptr[d], indptr[d+1])} w[k] *
    x[src[k]]``.

    ``indptr [n_dst + 1]`` int32, ``src [E]`` int32, ``x [n_src, F]``
    float32 or bfloat16, ``w [E]`` of x's dtype or ``None`` (all ones) and
    ``base [n_dst, F]`` of x's dtype or ``None`` (zeros), all contiguous
    and on one device; the result has x's dtype. A CPU tensor runs
    :func:`segment_spmm_plain`; a CUDA tensor launches the kernel (built at
    first use) or raises. ``plan`` sets the forward pass's launch plan (it
    must tile, :func:`check_plan`); None takes :func:`segment_plan`.

    ``transpose = (indptr_t [n_src + 1], dst_t [E], w_t [E] or None)``: the
    same matrix in source-major order, with ``w_t`` the weights in that
    order. It is needed when ``x`` requires a gradient; ``w`` and ``base``
    may require one without it."""
    _check(indptr, src, w, x, base)
    needs_x = x.requires_grad
    needs_w = w is not None and w.requires_grad
    needs_base = base is not None and base.requires_grad
    if not torch.is_grad_enabled() or not (needs_x or needs_w or needs_base):
        return _launch(indptr, src, w, x, base, plan)
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
    return _SegmentSpmm.apply(x, w, base, indptr, src, transpose, plan)


segment_spmm.launches = 0
segment_spmm.launches_bf16 = 0
