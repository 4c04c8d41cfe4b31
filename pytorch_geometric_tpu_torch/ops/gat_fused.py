"""Fused attention aggregation: GAT's softmax-weighted multi-head sum
through the hand-written Hopper mix kernel, with its plain PyTorch version
and its launch count.

Counterpart of ``pytorch_geometric_tpu/ops/gat_fused.py``. GAT's hot path is
``softmax_per_dst(logits) -> weighted segment-sum``; the JAX package fuses
the numerator and denominator into one pass of its blocked segment-sum
kernel over the per-edge messages ``[p_s | p_u * v[src]]``:

    out[n] = (sum_e p_u,e * v[src_e]) / (sum_e p_s,e),  p = exp(l - m[dst])

with a per-destination stabiliser ``m`` taken from a log-sum-exp bound
through the same kernel, not from a scatter-max. The port keeps that
arithmetic exactly and runs every pass through ``csrc/gat_mix.cu``, which
replaces the TPU kernel ``_chunk_kernel`` (``ops/pallas_spmm.py:74``) at
its second launch site (``:212``): the stabiliser sum ``s0`` (``v``
absent), the mix ``(s, u)``, and in the backward ``grad_v`` over the
source-major slot order. The kernel forms each message in registers, so
the ``[E, H * F]`` message array is never written.

Bound on the card: bytes; see the kernel's source. The kernel gathers one
row of ``v`` per slot, and those gathers can only be fast from L2, so it
cuts the ``H * F`` columns into slices of ``W`` columns
(:func:`mix_slice_cols`, from the card's L2 size) and the whole card
gathers from one slice at a time. Measured times against the bound are in
PERF.md.

The wrapper :func:`gat_mix` runs :func:`gat_mix_plain` for CPU tensors and
launches the kernel for CUDA tensors; it never falls back from one to the
other. It takes ``p_s``, ``p_u`` and ``v`` all float32 or all bf16 (the JAX
package's bf16 messages, ``gat_fused.py:76-81``: ``bf16(p_u * v)`` summed in
float32, ``s`` and ``u`` rounded to bf16 once); each arm counts its own
launches (``gat_mix.launches``, ``gat_mix.launches_bf16``). No model path
feeds it bf16: GATConv's float32 parameters promote ``v`` and the logits.
"""

import ctypes
from typing import Optional, Tuple

import torch

from .. import backend
from ..compat import register_launch_counter
from .edge_dot import edge_dot
from .gather import MIX_L2_SHARE, take_rows
from .segment import ptr2index


def gat_mix_plain(indptr: torch.Tensor, src: torch.Tensor,
                  p_s: Optional[torch.Tensor], p_u: Optional[torch.Tensor],
                  v: Optional[torch.Tensor], f: int
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The plain PyTorch version: gather, multiply (in the inputs' dtype,
    so a bf16 message is rounded as the kernel rounds it), ``index_add_``
    in float32, the results in the inputs' dtype.

    ``s`` sums ``p_s`` over every slot of a row; ``u`` skips a slot whose
    source lies outside ``[0, v.shape[0])``. Slots past ``indptr[-1]`` are
    not read."""
    n_dst = indptr.shape[0] - 1
    e = min(int(indptr[-1]), src.shape[0])
    dst = ptr2index(indptr.long(), e).long()
    s = u = None
    if p_s is not None:
        s = p_s.new_zeros((n_dst, p_s.shape[1]), dtype=torch.float32
                          ).index_add_(0, dst, p_s[:e].float()).to(p_s.dtype)
    if v is not None:
        n_src, h = v.shape[0], p_u.shape[1]
        sl = src[:e].long()
        valid = (sl >= 0) & (sl < n_src)
        vg = v.view(n_src, h, f)[sl.clamp(0, max(n_src - 1, 0))] \
            if n_src > 0 else v.new_zeros((e, h, f))
        msg = torch.where(valid[:, None, None], vg * p_u[:e, :, None], 0.0)
        u = v.new_zeros((n_dst, h * f), dtype=torch.float32).index_add_(
            0, dst, msg.view(e, h * f).float()).to(v.dtype)
    return s, u


# the least bytes of a row that one slice gathers: one 128-byte line
MIX_MIN_SLICE_BYTES = 128


def mix_slice_cols(n_src: int, h: int, f: int, itemsize: int,
                   l2_bytes: int) -> int:
    """Columns per slice of ``v [n_src, h * f]`` for the mix kernel: the
    widest divisor ``W`` of ``h * f`` that is a multiple of the 16-byte
    vector (``16 // itemsize`` elements), gathers at least
    ``MIX_MIN_SLICE_BYTES`` of a row, and whose slice ``n_src * W *
    itemsize`` fits in ``MIX_L2_SHARE`` of ``l2_bytes``; the narrowest such
    divisor when none fits; ``h * f`` (one slice) when the vector does not
    divide it."""
    hf = h * f
    vec = max(16 // itemsize, 1)
    if hf <= 0 or hf % vec:
        return hf
    least = max(vec, MIX_MIN_SLICE_BYTES // itemsize)
    widths = [w for w in range(vec, hf + 1, vec)
              if hf % w == 0 and (w >= least or w == hf)]
    budget = MIX_L2_SHARE * l2_bytes
    fit = [w for w in widths if n_src * w * itemsize <= budget]
    return max(fit) if fit else min(widths)


def card_slice_cols(v: torch.Tensor, h: int, f: int) -> int:
    """:func:`mix_slice_cols` for ``v`` on its card, from the card's L2."""
    l2 = torch.cuda.get_device_properties(v.device).L2_cache_size
    return mix_slice_cols(v.shape[0], h, f, v.element_size(), l2)


def _data_dtype(p_s, p_u, v) -> torch.dtype:
    """The one dtype of the given ``p_s``, ``p_u``, ``v``: float32 or
    bfloat16."""
    dts = {t.dtype for t in (p_s, p_u, v) if t is not None}
    if len(dts) != 1 or not dts <= {torch.float32, torch.bfloat16}:
        raise TypeError(f'gat_mix takes p_s, p_u and v all float32 or all '
                        f'bfloat16, got {sorted(map(str, dts))}')
    return dts.pop()


def _check(indptr, src, p_s, p_u, v, f, slice_cols=None):
    dev = indptr.device
    if p_s is None and v is None:
        raise ValueError('gat_mix: nothing to compute (p_s and v are None)')
    dt = _data_dtype(p_s, p_u, v)
    for name, t, dim in (('indptr', indptr, 1), ('src', src, 1),
                         ('p_s', p_s, 2), ('p_u', p_u, 2), ('v', v, 2)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f'gat_mix: {name} is on {t.device}, indptr on '
                             f'{dev}')
        if name in ('indptr', 'src') and t.dtype != torch.int32:
            raise TypeError(f'gat_mix takes int32 {name}, got {t.dtype}')
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f'gat_mix takes a contiguous {dim}-D {name}, '
                             f'got shape {tuple(t.shape)} strides '
                             f'{t.stride()}')
    if indptr.shape[0] < 1:
        raise ValueError('gat_mix: indptr needs n_dst + 1 >= 1 entries')
    e = src.shape[0]
    for name, p in (('p_s', p_s), ('p_u', p_u)):
        if p is not None and p.shape[0] != e:
            raise ValueError(f'gat_mix: {name} has {p.shape[0]} slots, src '
                             f'{e}')
    if v is not None:
        if p_u is None:
            raise ValueError('gat_mix: v needs p_u')
        if p_s is not None and p_s.shape[1] != p_u.shape[1]:
            raise ValueError('gat_mix: p_s and p_u have different heads')
        if f <= 0 or v.shape[1] != p_u.shape[1] * f:
            raise ValueError(f'gat_mix: v has {v.shape[1]} columns for '
                             f'{p_u.shape[1]} heads of {f}')
        if slice_cols is not None and (
                slice_cols <= 0 or v.shape[1] % slice_cols
                or v.shape[1] // slice_cols > 65535):
            raise ValueError(f'gat_mix: slice_cols {slice_cols} does not '
                             f'tile the {v.shape[1]} columns of v')
    return dt


def _kernel(arm: str):
    """The library's entry point of ``arm``, 'f32' or 'bf16'."""
    from .. import csrc
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return csrc.function('gat_mix', f'pgt_gat_mix_{arm}',
                         [vp, vp, vp, vp, vp, vp, vp, ll, ll, ll, i, i, i,
                          vp])


def gat_mix(indptr: torch.Tensor, src: torch.Tensor,
            p_s: Optional[torch.Tensor], p_u: Optional[torch.Tensor],
            v: Optional[torch.Tensor], f: int = 0,
            slice_cols: Optional[int] = None
            ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``s[d] = sum_k p_s[k]`` and ``u[d, h] = sum_k p_u[k, h] *
    v[src[k], h]`` over the slots ``k`` of row ``d``.

    ``indptr [n_dst + 1]`` and ``src [S]`` int32; ``p_s``, ``p_u [S, H]``
    and ``v [n_src, H * f]`` all float32 or all bfloat16, all contiguous
    and on one device. ``p_s`` None gives no ``s``; ``v`` None gives no
    ``u``. Returns ``(s [n_dst, H] or None, u [n_dst, H * f] or None)`` in
    the inputs' dtype. A CPU tensor runs :func:`gat_mix_plain`; a CUDA
    tensor launches the kernel of its dtype (built at first use) or raises.
    ``slice_cols`` (a divisor of ``H * f``) sets the kernel's slice width;
    None takes :func:`mix_slice_cols` for the card. The output is the same
    bits for every width. Each launch counts in ``gat_mix.launches`` or
    ``gat_mix.launches_bf16``. The counts are host calls: a CUDA graph's replay
    counts nothing, and a capture's launches are kept by the compiled callable
    (``compat.Compiled.launches_per_replay``). Not differentiable:
    :func:`gat_aggregate` wraps it."""
    dt = _check(indptr, src, p_s, p_u, v, f, slice_cols)
    if indptr.device.type == 'cpu':
        return gat_mix_plain(indptr, src, p_s, p_u, v, f)
    if indptr.device.type != 'cuda':
        raise ValueError(f'gat_mix runs on cpu or cuda, not {indptr.device}')
    bf16 = dt == torch.bfloat16
    fn = _kernel('bf16' if bf16 else 'f32')
    n_dst = indptr.shape[0] - 1
    h = (p_s if p_s is not None else p_u).shape[1]
    s = None if p_s is None else torch.empty(
        (n_dst, h), dtype=dt, device=indptr.device)
    u = None if v is None else torch.empty(
        (n_dst, h * f), dtype=dt, device=indptr.device)
    if v is None:
        w = 0
    elif slice_cols is None:
        w = card_slice_cols(v, h, f)
    else:
        w = slice_cols

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(indptr.device):
        stream = torch.cuda.current_stream(indptr.device).cuda_stream
        err = fn(indptr.data_ptr(), src.data_ptr(), ptr(p_s), ptr(p_u),
                 ptr(v), ptr(s), ptr(u), n_dst,
                 0 if v is None else v.shape[0], src.shape[0], h, f, w,
                 stream)
    if err != 0:
        raise RuntimeError(f'gat_mix kernel launch failed: CUDA error {err}')
    if bf16:
        gat_mix.launches_bf16 += 1
    else:
        gat_mix.launches += 1
    return s, u


register_launch_counter('gat_mix', gat_mix)
register_launch_counter('gat_mix_bf16', gat_mix, 'launches_bf16')


class _SlotGather(torch.autograd.Function):
    """Per-edge data into slot order; the backward is the gather by the
    inverse positions (``inv_pos``), not a scatter (``_slot_gather`` of the
    JAX package). Every edge has a slot, padded ones past ``indptr[-1]``;
    :func:`gat_aggregate` masks those through ``dst``."""

    @staticmethod
    def forward(ctx, x, perm, inv_pos):
        ctx.save_for_backward(inv_pos)
        return take_rows(x, perm)

    @staticmethod
    def backward(ctx, g):
        inv_pos, = ctx.saved_tensors
        return take_rows(g, inv_pos), None, None


def _slot_gather(x: torch.Tensor, slots) -> torch.Tensor:
    return _SlotGather.apply(x, slots.perm, slots.inv_pos)


class _GatMix(torch.autograd.Function):
    """``(s, u)`` of :func:`gat_mix` over ``blk`` with its backward
    (``_gat_mix_bwd`` of the JAX package): ``grad_v`` is the same kernel
    over the source-major slot order ``blk_t``, with ``p_u`` gathered by
    ``t_pos`` and ``gu`` in the place of ``v``; ``grad_p_u[k] = <v[src_k],
    gu[dst_k]>`` is the per-edge dot kernel over the slots
    (``ops/edge_dot.py::edge_dot``), which never writes the two gathered
    ``[E, H, F]`` operands; ``grad_p_s`` is a gather."""

    @staticmethod
    def forward(ctx, p_s, p_u, v, blk, blk_t, num_dst):
        num_src, h, f = v.shape
        ctx.blk, ctx.blk_t, ctx.num_dst = blk, blk_t, num_dst
        ctx.save_for_backward(p_u, v)
        s, u = gat_mix(blk.indptr, blk.src, p_s, p_u,
                       v.reshape(num_src, h * f), f)
        return s, u.view(num_dst, h, f)

    @staticmethod
    def backward(ctx, gs, gu):
        p_u, v = ctx.saved_tensors
        blk, blk_t, num_dst = ctx.blk, ctx.blk_t, ctx.num_dst
        num_src, h, f = v.shape
        grad_p_s = grad_p_u = grad_v = None
        dsafe = blk.dst.clamp(max=max(num_dst - 1, 0))
        valid = ((blk.dst < num_dst) & (blk.src >= 0)
                 & (blk.src < num_src))[:, None]
        if ctx.needs_input_grad[0]:
            grad_p_s = torch.where(valid, take_rows(gs, dsafe), 0.0)
        if ctx.needs_input_grad[1]:
            # the per-edge dot kernel: 0 where the slot's source or
            # destination is out of range, as ``valid`` says
            grad_p_u = edge_dot(v, gu.reshape(num_dst, h, f).contiguous(),
                                blk.src, blk.dst)
        if ctx.needs_input_grad[2]:
            p_t = take_rows(p_u, blk_t.t_pos)
            _, gv = gat_mix(blk_t.indptr, blk_t.src, None, p_t,
                            gu.reshape(num_dst, h * f).contiguous(), f)
            grad_v = gv.view(num_src, h, f)
        return grad_p_s, grad_p_u, grad_v, None, None, None


def fused_gat_available(edge_index) -> bool:
    return (getattr(edge_index, 'blocked', None) is not None
            and getattr(edge_index, 'blocked_t', None) is not None)


def fused_ok(edge_index, x: torch.Tensor) -> bool:
    """Whether an attention op takes its fused route over the slot orders
    (the convs' fused branch, ``ops.softmax``'s ``edge_index=`` route):
    they are cached and ``backend.use_kernel_spmm`` is on. With the knob
    off the CPU takes the plain route and the card raises, since nothing
    else stands in for the kernels there."""
    if not fused_gat_available(edge_index):
        return False
    if not backend.use_kernel_spmm:
        if x.device.type == 'cuda':
            raise RuntimeError(
                'backend.use_kernel_spmm is False, and the fused attention '
                'route has no other CUDA arm; move the tensors to the CPU '
                'to run the plain versions')
        return False
    return True


def gat_aggregate(edge_index, logits: torch.Tensor, v: torch.Tensor,
                  edge_mask: Optional[torch.Tensor] = None,
                  numerator_scale: Optional[torch.Tensor] = None,
                  return_alpha_sum: bool = False):
    """Softmax-weighted multi-head aggregation over ``dst``.

    logits: ``[E, H]`` raw attention logits in original edge order;
    v: ``[N_src, H, F]`` per-head values. Returns ``[N_dst, H, F]`` (and the
    softmax denominator ``[N_dst, H]`` if requested). ``edge_mask`` drops
    edges; ``numerator_scale [E, H]`` scales the numerator only (attention
    dropout). Requires ``edge_index.fill_cache(blocked=True)``."""
    blk, blk_t = edge_index.blocked, edge_index.blocked_t
    if blk is None or blk_t is None:
        raise ValueError('gat_aggregate needs the slot orders: call '
                         'edge_index.fill_cache(blocked=True)')
    num_dst = edge_index.num_dst_nodes
    h, f = logits.shape[1], v.shape[-1]
    invalid = edge_index.coo[1] >= num_dst
    if edge_mask is not None:
        invalid = invalid | ~edge_mask
    logits = torch.where(invalid[:, None], float('-inf'), logits)
    # reorder to slots once; everything downstream runs in slot order
    l_slot = _slot_gather(logits, blk)
    # per-dst stabiliser from the log-sum-exp bound m = G + log(sum exp(l -
    # G)), which lies in [max, max + log deg]: softmax is invariant to any
    # per-row constant, and this is the JAX package's arithmetic exactly
    ls = l_slot.detach()
    finite = torch.isfinite(ls)
    g = torch.where(finite, ls, float('-inf')).amax(dim=0)
    g = torch.where(torch.isfinite(g), g, 0.0)
    z = torch.where(finite, torch.exp(torch.clamp(ls - g, min=-85.0)), 0.0)
    s0, _ = gat_mix(blk.indptr, blk.src, z.contiguous(), None, None)
    m = torch.where(s0 > 0, g + torch.log(torch.clamp(s0, min=1e-38)),
                    g - 85.0)
    p_slot = torch.exp(l_slot - take_rows(
        m, blk.dst.clamp(max=max(num_dst - 1, 0))))
    p_slot = torch.where((blk.dst < num_dst)[:, None], p_slot, 0.0)
    p_u = p_slot
    if numerator_scale is not None:
        p_u = p_slot * _slot_gather(numerator_scale, blk)
    s, u = _GatMix.apply(p_slot, p_u, v.contiguous(), blk, blk_t, num_dst)
    out = u / torch.clamp(s, min=1e-16)[:, :, None]
    if return_alpha_sum:
        return out, s
    return out
