"""The per-edge, per-head dot kernel (``csrc/sddmm.cu``), its plain
version and its launch counts.

``out[e, h] = <a[ia[e], h], b[ib[e], h]>``. The dot has no Pallas body in
the JAX package: XLA computes ``(a[src] * b[dst]).sum(-1)`` there
(``ops/sddmm.py``, ``ops/edge_attention.py``, TransformerConv, SuperGATConv
and the mix's VJP), and PyTorch's plain version writes the two gathered
``[E, H, F]`` operands to device memory. On the card :func:`edge_dot`
launches the hand-written kernel, which reads each row into registers and
writes only ``[E, H]`` (bound: bytes; see the source), and gathers from one
L2-sized slice of the tables at a time (:func:`dot_plan`: whole heads, or
column slices of one head where a head of both tables does not fit), as
the mix kernel does with its columns; a call whose one side comes in runs
(a slot order's) takes the kernel's runs arm (:func:`runs_slice_heads`).
Each call counts one launch in ``edge_dot.launches`` (or
``launches_bf16``), and a call cut into column slices one more in
``edge_dot.launches_combine`` for the pass that sums its partials.

:func:`edge_dot` runs :func:`edge_dot_plain` for CPU tensors and launches
the kernel for CUDA tensors; it never falls back from one to the other. It
takes ``a`` and ``b`` both float32 or both bfloat16 (bf16 products, a
float32 sum, one rounding of the result). It is not differentiable:
``ops/sddmm.py`` wraps it.
"""

import ctypes
from typing import Optional

import torch

from ..compat import register_launch_counter
from .gather import MIX_L2_SHARE

_INDEX_TYPES = (torch.int32, torch.int64)


def _as_heads(t: torch.Tensor) -> torch.Tensor:
    return t[:, None, :] if t.dim() == 2 else t


def _valid(ia, ib, na, nb, edge_mask):
    ok = (ia >= 0) & (ia < na) & (ib >= 0) & (ib < nb)
    if edge_mask is not None:
        ok = ok & edge_mask
    return ok


def edge_dot_plain(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor,
                   ib: torch.Tensor,
                   edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: ``(a[ia] * b[ib]).sum(-1)``, 0 where an
    index is out of range or the mask is false. The product is rounded in
    the inputs' dtype (bf16 for bf16, as the kernel rounds it) and summed
    in float32; the result is rounded to the inputs' dtype once."""
    squeeze = a.dim() == 2
    a3, b3 = _as_heads(a), _as_heads(b)
    na, nb = a3.shape[0], b3.shape[0]
    ia, ib = ia.long(), ib.long()
    ok = _valid(ia, ib, na, nb, edge_mask)
    e, h = ia.shape[0], a3.shape[1]
    if na == 0 or nb == 0:
        out = a3.new_zeros((e, h))
    else:
        prod = a3[ia.clamp(0, na - 1)] * b3[ib.clamp(0, nb - 1)]
        out = torch.where(ok[:, None], prod.float().sum(-1), 0.0).to(
            a3.dtype)
    return out[:, 0] if squeeze else out


def _rows(name: str, t: torch.Tensor, h: int, f: int):
    """``t`` as ``[N, H, F]`` rows: the last two dimensions contiguous, any
    row stride; returns the row stride in elements."""
    t3 = _as_heads(t)
    if tuple(t3.shape[1:]) != (h, f) or t3.stride(2) != 1 or (
            h > 1 and t3.stride(1) != f) or t3.stride(0) < h * f:
        raise ValueError(f'edge_dot takes {name} as [N, {h}, {f}] (or '
                         f'[N, {f}] for one head) with each row contiguous, '
                         f'got shape {tuple(t.shape)} strides {t.stride()}')
    return t3.stride(0)


def _check(a, b, ia, ib, edge_mask):
    dev = a.device
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f'edge_dot takes a and b both [N, H, F] or both '
                         f'[N, F], got {tuple(a.shape)} and {tuple(b.shape)}')
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'edge_dot takes a and b both float32 or both '
                        f'bfloat16, got {a.dtype} and {b.dtype}')
    for name, t in (('b', b), ('ia', ia), ('ib', ib),
                    ('edge_mask', edge_mask)):
        if t is not None and t.device != dev:
            raise ValueError(f'edge_dot: {name} is on {t.device}, a on {dev}')
    e = ia.shape[0]
    for name, t in (('ia', ia), ('ib', ib)):
        if t.dim() != 1 or t.dtype not in _INDEX_TYPES:
            raise TypeError(f'edge_dot takes a 1-D int32 or int64 {name}, got '
                            f'{t.dtype} of shape {tuple(t.shape)}')
    if ib.shape[0] != e or (edge_mask is not None and (
            edge_mask.shape != (e,) or edge_mask.dtype != torch.bool)):
        raise ValueError(f'edge_dot: ia has {e} edges, ib '
                         f'{ib.shape[0]}; the mask must be a bool [{e}]')
    a3, b3 = _as_heads(a), _as_heads(b)
    if a3.shape[1:] != b3.shape[1:]:
        raise ValueError(f'edge_dot: a has heads of {tuple(a3.shape[1:])}, '
                         f'b of {tuple(b3.shape[1:])}')


# elements of a head one lane of the kernel holds (csrc/sddmm.cu's
# kLaneElems), and the most lanes a head takes
LANE_ELEMS, HEAD_LANES = 16, 32
# the share of the L2 a slice of both tables may take (the A/B of PERF.md:
# path I's two 100,000-row tables ran fastest in one slice of all four
# heads at H*F = 40, 32 MB, and in two column slices of a head at 256)
DOT_L2_SHARE = 0.75
# the narrowest column slice in bytes of a row: one 32-byte sector
MIN_SLICE_BYTES = 32
# the most column slices a head (the combine pass's registers) and slices
# a launch (the grid's second dimension) the kernel takes
MAX_COL_SLICES, MAX_SLICES = 64, 65535


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def dot_vec(a: torch.Tensor, b: torch.Tensor, f: int, lda: int,
            ldb: int) -> int:
    """The elements a leaf of the kernel reads at once: the widest power
    of two up to 16 bytes that divides ``f`` and both row strides, with
    both tables aligned to it."""
    vec = 16 // a.element_size()
    while vec > 1 and not (
            f % vec == 0 and lda % vec == 0 and ldb % vec == 0
            and a.data_ptr() % (vec * a.element_size()) == 0
            and b.data_ptr() % (vec * b.element_size()) == 0):
        vec //= 2
    return vec


def dot_slice_widths(h: int, f: int, vec: int):
    """Every slice shape the tree arm takes for ``h`` heads of ``f``
    columns read ``vec`` at a time, as ``(heads a slice, column slices a
    head)``: whole heads (a divisor of ``h``) where a head fits in the
    lanes, then one head cut into 2, 4, ... column slices (each a power of
    two of leaves, at most the lanes' width and at least one leaf), at most
    ``MAX_COL_SLICES`` of them and ``MAX_SLICES`` slices in all. Empty for
    a head too wide for any (over 64 slices of 32 lanes)."""
    nq = f // vec
    p = _pow2(nq)
    widest = HEAD_LANES * max(1, LANE_ELEMS // vec)
    out = []
    if p <= widest:
        out += [(d, 1) for d in range(h, 0, -1)
                if h % d == 0 and h // d <= MAX_SLICES]
    cs = 2
    while cs <= p:
        ncs = -(-nq // (p // cs))
        if (p // cs <= widest and ncs <= MAX_COL_SLICES
                and h * ncs <= MAX_SLICES):
            out.append((1, cs))
        cs *= 2
    return out


def dot_plan(na: int, nb: int, e: int, h: int, f: int, vec: int,
             itemsize: int, l2_bytes: int):
    """The tree arm's slices, ``(heads a slice, column slices a head)``: the
    most whole heads whose slice of the tables that the edges read again
    fits in ``DOT_L2_SHARE`` of ``l2_bytes``; where one head does not fit,
    the fewest column slices of one head that do, no narrower than a
    32-byte sector of a row. A table of at least a row per edge (a slot
    order's streamed side) is read about once a row and needs no room in
    L2. The kernel gathers from one slice at a time, so the slice's rows
    stay in L2 while the edges that read them go by. Where none fits, the
    narrowest shape the kernel takes. None where it takes none (a head too
    wide: :func:`edge_dot` gives it to the runs arm)."""
    budget = DOT_L2_SHARE * l2_bytes
    rows = sum(n for n in (na, nb) if n < e)
    widths = dot_slice_widths(h, f, vec)
    for hs, cs in widths:
        cols = f if cs == 1 else _pow2(f // vec) // cs * vec
        if rows * hs * cols * itemsize <= budget or (
                cs > 1 and cols * itemsize <= MIN_SLICE_BYTES):
            return hs, cs
    return widths[-1] if widths else None


def runs_arm(f: int, runs: Optional[bool]) -> bool:
    """Whether a call of heads of ``f`` elements takes the kernel's runs
    arm: as the caller names it (``runs``), or by default where a head fits
    one lane (``LANE_ELEMS``), where the A/B of PERF.md found the runs arm
    4 % ahead of the tree arm (H*F = 40 in edge order)."""
    return runs if runs is not None else f <= LANE_ELEMS


def runs_slice_heads(n_rows: int, h: int, f: int, itemsize: int,
                     l2_bytes: int) -> int:
    """The runs arm's heads a slice: the most whole heads ``hs`` (a divisor
    of ``h``) whose slice of a table of ``n_rows`` rows, ``n_rows * hs * f
    * itemsize`` bytes, fits in ``MIX_L2_SHARE`` of ``l2_bytes`` (the mix
    kernel's share, ``ops/gat_fused.py``); one head when none fits."""
    budget = MIX_L2_SHARE * l2_bytes
    fit = [d for d in range(1, h + 1)
           if h % d == 0 and n_rows * d * f * itemsize <= budget]
    return max(fit) if fit else 1


def _kernel(arm: str):
    """The library's entry point of ``arm``: 'f32', 'bf16' (the tree arm)
    or 'runs_f32', 'runs_bf16' (the runs arm, which takes no vector width
    and no column slices)."""
    from .. import csrc
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if arm.startswith('runs'):
        return csrc.function('sddmm', f'pgt_edge_dot_{arm}',
                             [vp] * 6 + [ll] * 5 + [i] * 5 + [vp])
    return csrc.function('sddmm', f'pgt_edge_dot_{arm}',
                         [vp] * 7 + [ll] * 5 + [i] * 7 + [vp])


def edge_dot(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor,
             ib: torch.Tensor, edge_mask: Optional[torch.Tensor] = None,
             slice_heads: Optional[int] = None,
             col_slices: Optional[int] = None,
             runs: Optional[bool] = None) -> torch.Tensor:
    """``out[e, h] = sum_f a[ia[e], h, f] * b[ib[e], h, f]``, 0 where
    ``ia[e]`` is outside ``[0, a.shape[0])``, ``ib[e]`` outside ``[0,
    b.shape[0])`` or ``edge_mask[e]`` is false.

    ``a [Na, H, F]`` and ``b [Nb, H, F]`` (or ``[N, F]`` for one head,
    giving ``[E]``) both float32 or both bfloat16, each row contiguous (a
    row stride of their own is allowed, as in a column slice of a wider
    table); ``ia``, ``ib [E]`` int32 or int64; ``edge_mask [E]`` bool. A
    CPU tensor runs :func:`edge_dot_plain`; a CUDA tensor launches the
    kernel of its dtype (built at first use) or raises. The kernel has two
    arms: the tree arm, whose ``slice_heads`` (a divisor of H) and
    ``col_slices`` (column slices a head, with one head a slice) are one of
    :func:`dot_slice_widths` (None: :func:`dot_plan` for the card); and the
    runs arm, slices of whole heads only (None: :func:`runs_slice_heads`),
    for a caller whose one side's indices come in ``runs`` (True: a slot
    order's destinations), and by default (None) for heads of at most 16
    elements (:func:`runs_arm`) or a head the tree arm takes in no shape;
    False asks for the tree arm. The two arms sum in their own orders; each
    gives the same bits for every slice shape it takes. Each call counts
    one launch in ``edge_dot.launches`` or ``edge_dot.launches_bf16``, and
    one in ``edge_dot.launches_combine`` where it is cut into column
    slices; an empty edge list launches nothing. Not differentiable:
    :func:`sddmm` and :func:`gathered_dot` wrap it."""
    _check(a, b, ia, ib, edge_mask)
    h, f = _as_heads(a).shape[1:]
    if slice_heads is not None and (slice_heads <= 0 or h % slice_heads):
        raise ValueError(f'edge_dot: slice_heads {slice_heads} does not '
                         f'tile {h} heads')
    if runs_arm(f, runs) and col_slices not in (None, 1):
        raise ValueError(f'edge_dot: the runs arm takes slices of whole '
                         f'heads, got {col_slices} column slices')
    if a.device.type == 'cpu':
        return edge_dot_plain(a, b, ia, ib, edge_mask)
    if a.device.type != 'cuda':
        raise ValueError(f'edge_dot runs on cpu or cuda, not {a.device}')
    squeeze = a.dim() == 2
    lda, ldb = _rows('a', a, h, f), _rows('b', b, h, f)
    e = ia.shape[0]
    out = torch.empty((e, h), dtype=a.dtype, device=a.device)
    if e > 0 and h > 0:
        bf16 = a.dtype == torch.bfloat16
        l2 = torch.cuda.get_device_properties(a.device).L2_cache_size
        mask = None if edge_mask is None else edge_mask.contiguous()
        ia_c, ib_c = ia.contiguous(), ib.contiguous()
        ptrs = (a.data_ptr(), b.data_ptr(), ia_c.data_ptr(), ib_c.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr())
        wide = (int(ia.dtype == torch.int64), int(ib.dtype == torch.int64))
        vec = dot_vec(a, b, f, lda, ldb)
        widths = dot_slice_widths(h, f, vec)
        if runs_arm(f, runs) or not widths:
            if col_slices not in (None, 1):
                raise ValueError(f'edge_dot: the tree arm takes no shape of '
                                 f'{f} columns a head, and the runs arm no '
                                 f'column slices')
            if slice_heads is None:
                slice_heads = runs_slice_heads(max(a.shape[0], b.shape[0]),
                                               h, f, a.element_size(), l2)
            fn, part = _kernel('runs_bf16' if bf16 else 'runs_f32'), None
            args = (*ptrs, e, a.shape[0], b.shape[0], lda, ldb, h, f,
                    slice_heads, *wide)
        else:
            if slice_heads is None and col_slices is None:
                slice_heads, col_slices = dot_plan(
                    a.shape[0], b.shape[0], e, h, f, vec, a.element_size(),
                    l2)
            slice_heads, col_slices = slice_heads or 1, col_slices or 1
            if (slice_heads, col_slices) not in widths:
                raise ValueError(f'edge_dot: {slice_heads} heads a slice in '
                                 f'{col_slices} column slices is not one of '
                                 f'{widths}')
            leaves = _pow2(f // vec) // col_slices
            ncs = -(-(f // vec) // leaves)
            part = (torch.empty((ncs, e, h), dtype=torch.float32,
                                device=a.device) if ncs > 1 else None)
            fn = _kernel('bf16' if bf16 else 'f32')
            args = (*ptrs, None if part is None else part.data_ptr(), e,
                    a.shape[0], b.shape[0], lda, ldb, h, f, vec, slice_heads,
                    leaves, *wide)
        with torch.cuda.device(a.device):
            err = fn(*args, torch.cuda.current_stream(a.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'edge_dot kernel launch failed: CUDA error '
                               f'{err}')
        if bf16:
            edge_dot.launches_bf16 += 1
        else:
            edge_dot.launches += 1
        if part is not None:
            edge_dot.launches_combine += 1
    return out[:, 0] if squeeze else out


register_launch_counter('edge_dot', edge_dot)
register_launch_counter('edge_dot_bf16', edge_dot, 'launches_bf16')
register_launch_counter('edge_dot_combine', edge_dot, 'launches_combine')
