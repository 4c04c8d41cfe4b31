"""The per-edge, per-head dot kernel (``csrc/sddmm.cu``), its plain
version and its launch counts.

``out[e, h] = <a[ia[e], h], b[ib[e], h]>``. The dot has no Pallas body in
the JAX package: XLA computes ``(a[src] * b[dst]).sum(-1)`` there
(``ops/sddmm.py``, ``ops/edge_attention.py``, TransformerConv, SuperGATConv
and the mix's VJP), and PyTorch's plain version writes the two gathered
``[E, H, F]`` operands to device memory. On the card :func:`edge_dot`
launches the hand-written kernel, which reads each row into registers and
writes only ``[E, H]`` (bound: bytes; see the source), and gathers from one
L2-sized slice of whole heads at a time (:func:`dot_slice_heads`), as the
mix kernel does with its columns.

:func:`edge_dot` runs :func:`edge_dot_plain` for CPU tensors and launches
the kernel for CUDA tensors; it never falls back from one to the other. It
takes ``a`` and ``b`` both float32 or both bfloat16 (bf16 products, a
float32 sum, one rounding of the result); each arm counts its launches
(``edge_dot.launches``, ``edge_dot.launches_bf16``). It is not
differentiable: ``ops/sddmm.py`` wraps it.
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


def dot_slice_heads(n_rows: int, h: int, f: int, itemsize: int,
                    l2_bytes: int) -> int:
    """Heads per slice of the dot kernel: the most whole heads ``hs`` (a
    divisor of ``h``) whose slice of a table of ``n_rows`` rows, ``n_rows *
    hs * f * itemsize`` bytes, fits in ``MIX_L2_SHARE`` of ``l2_bytes`` (the
    mix kernel's share, ``ops/gat_fused.py``); one head when none fits. The
    kernel gathers from one slice at a time, so the slice's rows stay in L2
    while the edges that read them go by."""
    budget = MIX_L2_SHARE * l2_bytes
    fit = [d for d in range(1, h + 1)
           if h % d == 0 and n_rows * d * f * itemsize <= budget]
    return max(fit) if fit else 1


def _kernel(arm: str):
    """The library's entry point of ``arm``, 'f32' or 'bf16'."""
    from .. import csrc
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return csrc.function('sddmm', f'pgt_edge_dot_{arm}',
                         [vp, vp, vp, vp, vp, vp, ll, ll, ll, ll, ll, i, i,
                          i, i, i, vp])


def edge_dot(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor,
             ib: torch.Tensor, edge_mask: Optional[torch.Tensor] = None,
             slice_heads: Optional[int] = None) -> torch.Tensor:
    """``out[e, h] = sum_f a[ia[e], h, f] * b[ib[e], h, f]``, 0 where
    ``ia[e]`` is outside ``[0, a.shape[0])``, ``ib[e]`` outside ``[0,
    b.shape[0])`` or ``edge_mask[e]`` is false.

    ``a [Na, H, F]`` and ``b [Nb, H, F]`` (or ``[N, F]`` for one head,
    giving ``[E]``) both float32 or both bfloat16, each row contiguous (a
    row stride of their own is allowed, as in a column slice of a wider
    table); ``ia``, ``ib [E]`` int32 or int64; ``edge_mask [E]`` bool. A
    CPU tensor runs :func:`edge_dot_plain`; a CUDA tensor launches the
    kernel of its dtype (built at first use) or raises. ``slice_heads`` (a
    divisor of H) sets the kernel's slice width in heads; None takes
    :func:`dot_slice_heads` for the card. The output is the same bits for
    every width. Each launch counts in ``edge_dot.launches`` or
    ``edge_dot.launches_bf16``; an empty edge list launches nothing. Not
    differentiable: :func:`sddmm` and :func:`gathered_dot` wrap it."""
    _check(a, b, ia, ib, edge_mask)
    h, f = _as_heads(a).shape[1:]
    if slice_heads is not None and (slice_heads <= 0 or h % slice_heads):
        raise ValueError(f'edge_dot: slice_heads {slice_heads} does not '
                         f'tile {h} heads')
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
        fn = _kernel('bf16' if bf16 else 'f32')
        if slice_heads is None:
            l2 = torch.cuda.get_device_properties(a.device).L2_cache_size
            slice_heads = dot_slice_heads(max(a.shape[0], b.shape[0]), h, f,
                                          a.element_size(), l2)
        mask = None if edge_mask is None else edge_mask.contiguous()
        ia_c, ib_c = ia.contiguous(), ib.contiguous()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = fn(a.data_ptr(), b.data_ptr(), ia_c.data_ptr(),
                     ib_c.data_ptr(), None if mask is None else
                     mask.data_ptr(), out.data_ptr(), e, a.shape[0],
                     b.shape[0], lda, ldb, h, f, slice_heads,
                     int(ia.dtype == torch.int64),
                     int(ib.dtype == torch.int64), stream)
        if err != 0:
            raise RuntimeError(f'edge_dot kernel launch failed: CUDA error '
                               f'{err}')
        if bf16:
            edge_dot.launches_bf16 += 1
        else:
            edge_dot.launches += 1
    return out[:, 0] if squeeze else out


register_launch_counter('edge_dot', edge_dot)
register_launch_counter('edge_dot_bf16', edge_dot, 'launches_bf16')
