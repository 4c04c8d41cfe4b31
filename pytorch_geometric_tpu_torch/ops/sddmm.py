"""SDDMM and the fused segment softmax over per-edge values, built on the
per-edge dot kernel (``ops/edge_dot.py``) and the mix kernel.

Counterpart of ``pytorch_geometric_tpu/ops/sddmm.py``:

  * :func:`sddmm`: per-edge, per-head dot scores ``<a[src_e], b[dst_e]>``
    without the dense product;
  * :func:`edge_softmax`: segment softmax over destinations, the result in
    the original edge order;
  * :func:`edge_softmax_aggregate`: softmax numerator and denominator for
    per-EDGE values in one pass of the mix kernel;
  * :func:`multi_relation_softmax_aggregate`: one softmax across every
    relation that targets a destination (HGT's union softmax).

Every dot runs on :func:`ops.edge_dot.edge_dot`. Every sum the JAX package
leaves to its blocked segment-sum (``_chunk_kernel``,
``ops/pallas_spmm.py:212``) runs on the mix kernel
(``ops/gat_fused.py::gat_mix``): ``_edge_mix`` is the mix with ``src =
arange(E)``, the stabiliser ``s0`` and :func:`edge_softmax`'s denominator
are its ``s``-only pass.

Repeatability on the card: every route over cached slot orders
(``fill_cache(blocked=True)``) sums in a fixed order and gives the same
bits on every run. :func:`sddmm`'s backward without slot orders and
:func:`gathered_dot`'s backward add with ``index_add_``, as XLA's autodiff
transposes a gather into a scatter-add; on the card those adds are atomic,
so the last bits of those gradients may change from run to run.
"""

from typing import Optional, Sequence, Tuple

import torch

from .edge_dot import _as_heads, _valid, edge_dot
from .gat_fused import _slot_gather, fused_gat_available, gat_mix
from .gather import take_rows


class _GatheredDot(torch.autograd.Function):
    """:func:`edge_dot` with the gradient XLA's autodiff gives the JAX
    package's ``(a[ia] * b[ib]).sum(-1)``: a gather of the other operand
    times the score's cotangent, added into rows with ``index_add_``."""

    @staticmethod
    def forward(ctx, a, b, ia, ib, edge_mask):
        ctx.save_for_backward(a, b, ia, ib, edge_mask)
        return edge_dot(a, b, ia, ib, edge_mask)

    @staticmethod
    def backward(ctx, g):
        a, b, ia, ib, edge_mask = ctx.saved_tensors
        a3, b3 = _as_heads(a), _as_heads(b)
        na, nb = a3.shape[0], b3.shape[0]
        ia, ib = ia.long(), ib.long()
        ok = _valid(ia, ib, na, nb, edge_mask)
        g = torch.where(ok[:, None], g.reshape(ia.shape[0], -1), 0.0)
        ia_c, ib_c = ia.clamp(0, max(na - 1, 0)), ib.clamp(0, max(nb - 1, 0))
        grad_a = grad_b = None
        if ctx.needs_input_grad[0] and na and nb:
            grad_a = torch.zeros_like(a3).index_add_(
                0, ia_c, g[:, :, None].to(b3.dtype) * b3[ib_c]).view_as(a)
        if ctx.needs_input_grad[1] and na and nb:
            grad_b = torch.zeros_like(b3).index_add_(
                0, ib_c, g[:, :, None].to(a3.dtype) * a3[ia_c]).view_as(b)
        return grad_a, grad_b, None, None, None


def gathered_dot(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor,
                 ib: torch.Tensor,
                 edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable :func:`edge_dot` over any indices; the backward adds
    with ``index_add_`` (not repeatable bit for bit on the card)."""
    return _GatheredDot.apply(a, b, ia, ib, edge_mask)


class _SddmmSlots(torch.autograd.Function):
    """:func:`edge_dot` over an edge index's own ``(src, dst)`` whose
    backward runs the mix kernel over the slot orders, with no atomics:
    ``grad_b[d] = sum_e g[e] a[src_e]`` over the destination-major order
    ``blk`` and ``grad_a[s] = sum_e g[e] b[dst_e]`` over the source-major
    order ``blk_t``, each with the cotangent gathered into its slots."""

    @staticmethod
    def forward(ctx, a, b, src, dst, edge_mask, blk, blk_t):
        ctx.save_for_backward(a, b, src, dst, edge_mask)
        ctx.blk, ctx.blk_t = blk, blk_t
        return edge_dot(a, b, src, dst, edge_mask)

    @staticmethod
    def backward(ctx, g):
        a, b, src, dst, edge_mask = ctx.saved_tensors
        blk, blk_t = ctx.blk, ctx.blk_t
        (na, h, f), nb = a.shape, b.shape[0]
        ok = _valid(src, dst, na, nb, edge_mask)
        g = torch.where(ok[:, None], g, 0.0).to(a.dtype)
        grad_a = grad_b = None
        if ctx.needs_input_grad[1]:
            _, u = gat_mix(blk.indptr, blk.src, None,
                           take_rows(g, blk.perm).contiguous(),
                           a.reshape(na, h * f).contiguous(), f)
            grad_b = u.view(nb, h, f)
        if ctx.needs_input_grad[0]:
            _, u = gat_mix(blk_t.indptr, blk_t.src, None,
                           take_rows(g, blk_t.perm).contiguous(),
                           b.reshape(nb, h * f).contiguous(), f)
            grad_a = u.view(na, h, f)
        return grad_a, grad_b, None, None, None, None, None


def sddmm(edge_index, a: torch.Tensor, b: torch.Tensor,
          edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-edge dot scores ``out[e] = <a[src_e], b[dst_e]>``.

    ``a [N_src, H, F]`` (or ``[N_src, F]``, one head), ``b`` likewise over
    the destinations; returns ``[E, H]`` (or ``[E]``). Masked edges and
    edges with an endpoint out of range score 0. Differentiable in ``a``
    and ``b``: over cached slot orders (``fill_cache(blocked=True)``, and
    ``a`` / ``b`` sized as the edge index's sources / destinations) the
    backward is two launches of the mix kernel and its result the same bits
    on every run; otherwise it adds with ``index_add_``, as XLA's autodiff
    does in the JAX package, and on the card those gradients are not
    repeatable bit for bit."""
    coo = edge_index.coo if hasattr(edge_index, 'coo') else edge_index
    squeeze = a.dim() == 2
    a3, b3 = _as_heads(a), _as_heads(b)
    src, dst = coo[0], coo[1]
    if (fused_gat_available(edge_index)
            and a3.shape[0] == edge_index.num_src_nodes
            and b3.shape[0] == edge_index.num_dst_nodes):
        out = _SddmmSlots.apply(a3, b3, src, dst, edge_mask,
                                edge_index.blocked, edge_index.blocked_t)
    else:
        out = gathered_dot(a3, b3, src, dst, edge_mask)
    return out[:, 0] if squeeze else out


# -- the fused per-edge-value mix: (s, u) = sum over slots of [p_s | p_u v] --
def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


class _EdgeMix(torch.autograd.Function):
    """``s[d] = sum p_s`` and ``u[d] = sum p_u * v_slot`` over the slots of
    row ``d`` (``_edge_mix`` of the JAX package): the mix kernel over
    ``blk.indptr`` with ``src = arange(E)``. The backward is gathers and one
    per-edge dot, no scatter: ``grad_p_s = gs[dst]``, ``grad_p_u =
    <gu[dst], v_slot>`` (:func:`edge_dot`) and ``grad_v = gu[dst] * p_u``."""

    @staticmethod
    def forward(ctx, p_s, p_u, v_slot, blk, num_dst):
        e, h, f = v_slot.shape
        ctx.blk, ctx.num_dst = blk, num_dst
        ctx.save_for_backward(p_u, v_slot)
        s, u = gat_mix(blk.indptr, _arange(e, v_slot), p_s.contiguous(),
                       p_u.contiguous(), v_slot.reshape(e, h * f), f)
        return s, u.view(num_dst, h, f)

    @staticmethod
    def backward(ctx, gs, gu):
        p_u, v_slot = ctx.saved_tensors
        blk, num_dst = ctx.blk, ctx.num_dst
        e, h, f = v_slot.shape
        dsafe = blk.dst.clamp(max=max(num_dst - 1, 0))
        valid = (blk.dst < num_dst)[:, None]
        grad_p_s = grad_p_u = grad_v = None
        if ctx.needs_input_grad[0]:
            grad_p_s = torch.where(valid, take_rows(gs, dsafe), 0.0)
        gu = gu.contiguous()
        if ctx.needs_input_grad[1]:
            grad_p_u = edge_dot(gu, v_slot, blk.dst, _arange(e, v_slot))
        if ctx.needs_input_grad[2]:
            grad_v = torch.where(valid[:, :, None],
                                 gu[dsafe] * p_u[:, :, None], 0.0)
        return grad_p_s, grad_p_u, grad_v, None, None


class _SlotSum(torch.autograd.Function):
    """``s[d] = sum p`` over the slots of row ``d`` (the mix kernel's
    ``s``-only pass); the backward is the gather ``gs[dst]``, as the JAX
    package's ``segment_sum_blocked`` VJP."""

    @staticmethod
    def forward(ctx, p, blk, num_dst):
        ctx.blk, ctx.num_dst = blk, num_dst
        s, _ = gat_mix(blk.indptr, blk.src, p.contiguous(), None, None)
        return s

    @staticmethod
    def backward(ctx, gs):
        blk, num_dst = ctx.blk, ctx.num_dst
        dsafe = blk.dst.clamp(max=max(num_dst - 1, 0))
        return torch.where((blk.dst < num_dst)[:, None],
                           take_rows(gs, dsafe), 0.0), None, None


def _column_max(x: torch.Tensor) -> torch.Tensor:
    """Per-column max of ``[E, H]``; ``-inf`` for no rows (as ``jnp.max``
    of an empty axis under the JAX package's masking)."""
    if x.shape[0] == 0:
        return x.new_full(x.shape[1:], float('-inf'))
    return x.amax(dim=0)


def _softmax_parts(edge_index, logits, edge_mask, shared_g=None):
    """Slot-order exp weights and the raw denominator of one relation:
    ``(z [E, H] = exp(l - G), s0 [N_dst, H], G [H], blk)``. With
    ``shared_g`` the caller gives the stabiliser (the union softmax)."""
    blk = edge_index.blocked
    if blk is None or edge_index.blocked_t is None:
        raise ValueError('the fused softmax needs the slot orders: call '
                         'edge_index.fill_cache(blocked=True)')
    num_dst = edge_index.num_dst_nodes
    invalid = edge_index.coo[1] >= num_dst
    if edge_mask is not None:
        invalid = invalid | ~edge_mask
    logits = torch.where(invalid[:, None], float('-inf'), logits)
    l_slot = _slot_gather(logits, blk)
    if shared_g is None:
        ls = l_slot.detach()
        g = _column_max(torch.where(torch.isfinite(ls), ls, float('-inf')))
        g = torch.where(torch.isfinite(g), g, 0.0)
    else:
        g = shared_g
    z = torch.exp(torch.clamp(l_slot - g, min=-85.0))
    z = torch.where(torch.isfinite(l_slot), z, 0.0)
    z = torch.where((blk.dst < num_dst)[:, None], z, 0.0)
    s0, _ = gat_mix(blk.indptr, blk.src, z.detach().contiguous(), None,
                    None)
    return z, s0, g, blk


def _rebase(z, s0, g, blk, num_dst):
    """``z`` rebased from ``G`` to the per-destination log-sum-exp bound
    ``m = G + log(s0)`` (in ``[max, max + log deg]``), a pure rescale."""
    m = torch.where(s0 > 0, g + torch.log(torch.clamp(s0, min=1e-38)),
                    g - 85.0).detach()
    dsafe = blk.dst.clamp(max=max(num_dst - 1, 0))
    return z * torch.exp(g - take_rows(m, dsafe))


def edge_softmax_aggregate(edge_index, logits: torch.Tensor,
                           values: torch.Tensor,
                           edge_mask: Optional[torch.Tensor] = None,
                           numerator_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Fused ``softmax_per_dst(logits) @ values`` for per-EDGE values.

    ``logits [E, H]``, ``values [E, H, F]`` in the original edge order;
    returns ``[N_dst, H, F]``. ``numerator_scale [E, H]`` scales the
    numerator only. Needs ``edge_index.fill_cache(blocked=True)``."""
    num_dst = edge_index.num_dst_nodes
    e, h = logits.shape
    f = values.shape[-1]
    z, s0, g, blk = _softmax_parts(edge_index, logits, edge_mask)
    p_slot = _rebase(z, s0, g, blk, num_dst)
    v_slot = _slot_gather(values.reshape(e, h * f), blk).view(-1, h, f)
    p_u = p_slot
    if numerator_scale is not None:
        p_u = p_slot * _slot_gather(numerator_scale, blk)
    s, u = _EdgeMix.apply(p_slot, p_u, v_slot, blk, num_dst)
    return u / torch.clamp(s, min=1e-16)[:, :, None]


def multi_relation_softmax_aggregate(
        relations: Sequence[Tuple[object, torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]],
        num_dst: int) -> torch.Tensor:
    """HGT's union softmax: normalise across ALL incoming relations.

    ``relations``: ``(edge_index, logits [E_r, H], values [E_r, H, F],
    edge_mask)`` each; every edge index targets the same destinations and
    carries the slot orders. Two passes of the mix kernel per relation:
    the raw denominators under one shared stabiliser, then the mix rebased
    to the union's log-sum-exp."""
    gs = []
    for (_, logits, _, mask) in relations:
        lg = logits.detach()
        if mask is not None:
            lg = torch.where(mask[:, None], lg, float('-inf'))
        gs.append(_column_max(lg))
    g = torch.stack(gs).amax(dim=0)
    g = torch.where(torch.isfinite(g), g, 0.0)

    parts, s0_total = [], 0
    for (ei, logits, values, mask) in relations:
        z, s0, _, blk = _softmax_parts(ei, logits, mask, shared_g=g)
        parts.append((z, blk, values))
        s0_total = s0_total + s0
    h = relations[0][1].shape[1]
    f = relations[0][2].shape[-1]
    s_total = u_total = 0
    for (z, blk, values) in parts:
        p_slot = _rebase(z, s0_total, g, blk, num_dst)
        v_slot = _slot_gather(values.reshape(values.shape[0], h * f),
                              blk).view(-1, h, f)
        s, u = _EdgeMix.apply(p_slot, p_slot, v_slot, blk, num_dst)
        s_total, u_total = s_total + s, u_total + u
    return u_total / torch.clamp(s_total, min=1e-16)[:, :, None]


def edge_softmax(edge_index, logits: torch.Tensor,
                 edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment softmax by destination, per edge in the ORIGINAL edge order
    (the ``softmax_csr`` role), its denominators from the mix kernel's
    ``s``-only pass. Needs the slot orders; callers without them use
    :func:`ops.softmax`."""
    num_dst = edge_index.num_dst_nodes
    z, s0, g, blk = _softmax_parts(edge_index, logits, edge_mask)
    p_slot = _rebase(z, s0, g, blk, num_dst)
    s = _SlotSum.apply(p_slot, blk, num_dst)
    p = take_rows(p_slot, blk.inv_pos)
    dst = edge_index.coo[1].long()
    denom = take_rows(s, dst.clamp(max=max(num_dst - 1, 0)))
    alpha = p / torch.clamp(denom, min=1e-16)
    valid = dst < num_dst
    if edge_mask is not None:
        valid = valid & edge_mask
    return torch.where(valid[:, None], alpha, 0.0)


def fused_softmax_available(edge_index) -> bool:
    """Whether the edge index carries the slot orders the fused softmax
    runs over. The JAX package also asks ``_use_pallas()`` here; in the
    port ``backend.use_kernel_spmm`` governs the kernels where a conv picks
    its branch (``nn/conv/gat_conv.py::_attend``)."""
    return fused_gat_available(edge_index)
