"""Union-softmax edge attention, the wide-gather part.

Counterpart of ``pytorch_geometric_tpu/ops/edge_attention.py``: every
relation that targets one destination set goes through ONE softmax over the
union of their edges,

    out[n] = sum_{e: dst_e = n} softmax_n(p[rel_e] <q[n], k[src_e]>) v[src_e]

with the JAX package's custom backward (``_attention``, ``:84-160``), which
saves only ``alpha`` and recomputes the rest: no forward recompute and no
``[E, H, D]`` residuals. The logits, the backward's ``dalpha = <g[dst],
v[src]>`` and its ``base = <q[dst], k[src]>`` run on the per-edge dot
kernel (``ops/edge_dot.py::edge_dot``); the softmax is ``ops.softmax``,
and the value gathers and scatters are PyTorch's gathers and
``index_add_``, as the JAX package leaves them to XLA. On the card those
adds are atomic, so the gradients' last bits may change from run to run.

The JAX package keeps ``k`` and ``v`` in one flat ``[M, 2 H D]`` table for
the TPU's one wide gather; here they are two tables, or two column halves of
one (:func:`hetero_edge_attention`), read in place.

Not ported yet (ROADMAP Queue 1, item 7): the online-softmax flash scan the
JAX package takes past ``PGT_ATTN_WIDE_BYTES`` (``_attention_flash*``), and
the host-presorted ``FlashLayout`` (``layout=``); both raise
``NotImplementedError`` here.
"""

import os
from typing import Sequence

import torch

from .edge_dot import edge_dot
from .softmax import softmax

__all__ = ['hetero_edge_attention', 'hetero_edge_attention_multi',
           'ATTN_WIDE_BYTES']

# the JAX package's PGT_ATTN_WIDE_BYTES default (WIDE_BYTES_CAP): past this
# many bytes of [E, H, 2 D] float32 gathers the JAX package takes the flash
# scan
ATTN_WIDE_BYTES = 1e9
# its PGT_ATTN_SORT_MIN_EDGES default: from this many union edges on, the
# union is sorted by destination once
ATTN_SORT_MIN_EDGES = 1 << 20


def _not_ported(what: str):
    raise NotImplementedError(
        f'{what} (ops/edge_attention.py, an XLA scan in the JAX package) is '
        f'not ported to the PyTorch package yet (ROADMAP: Queue 1, item 7)')


def _rep(a: torch.Tensor, d: int) -> torch.Tensor:
    """``[E, H] -> [E, H D]``, each head's column repeated ``D`` times (the
    head-major layout of ``reshape(e, h * d)``)."""
    return a.repeat_interleave(d, dim=1)


def _scatter_rows(x: torch.Tensor, index: torch.Tensor, n: int
                  ) -> torch.Tensor:
    """``out[i] = sum_{index_e = i} x[e]``; an index at or past ``n`` is
    dropped (the JAX package's out-of-bounds scatter)."""
    seg = torch.where(index < n, index, n)
    return x.new_zeros((n + 1,) + x.shape[1:]).index_add_(0, seg, x)[:n]


def _heads(t: torch.Tensor, h: int, d: int) -> torch.Tensor:
    """A ``[M, H D]`` table (any row stride) viewed as ``[M, H, D]``."""
    return t.as_strided((t.shape[0], h, d), (t.stride(0), d, 1))


class _Attention(torch.autograd.Function):
    """``_attention`` of the JAX package over separate ``k`` / ``v`` tables
    ``[M, H D]`` (row strides of their own allowed), ``q_table [num_dst, H,
    D]``, ``p_stack [R, H]`` (already divided by ``sqrt(D)``), ``rel``,
    ``src`` (in range) and ``dst`` (``>= num_dst`` marks a dropped edge)."""

    @staticmethod
    def forward(ctx, num_dst, k_table, v_table, q_table, p_stack, rel, src,
                dst):
        h, d = q_table.shape[1], q_table.shape[2]
        valid = dst < num_dst
        # q[dst] . k[src] per head: 0 for a dropped edge, which the softmax
        # masks anyway
        logit = edge_dot(q_table, _heads(k_table, h, d), dst, src) \
            * p_stack[rel]
        alpha = softmax(logit, dst, num_dst, mask=valid)
        msg = v_table[src] * _rep(alpha, d)
        out = _scatter_rows(msg, dst, num_dst).view(num_dst, h, d)
        ctx.num_dst = num_dst
        ctx.save_for_backward(k_table, v_table, q_table, p_stack, rel, src,
                              dst, alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        (k_table, v_table, q_table, p_stack, rel, src, dst,
         alpha) = ctx.saved_tensors
        num_dst = ctx.num_dst
        m = k_table.shape[0]
        e, h = alpha.shape
        d = q_table.shape[2]
        hd = h * d
        valid = dst < num_dst
        dsafe = dst.clamp(max=max(num_dst - 1, 0))
        g = g.contiguous()
        ge = torch.where(valid[:, None], g.view(num_dst, hd)[dsafe], 0.0)
        # out = sum alpha v: dalpha = <g[dst], v[src]>
        dalpha = edge_dot(g, _heads(v_table, h, d), dst, src)
        dv = ge * _rep(alpha, d)
        # the softmax's VJP: dlogit = alpha (dalpha - sum_seg(alpha dalpha))
        seg = _scatter_rows(torch.where(valid[:, None], alpha * dalpha, 0.0),
                            dst, num_dst)
        dlogit = alpha * (dalpha - torch.where(valid[:, None], seg[dsafe],
                                               0.0))
        grad_p = None
        if ctx.needs_input_grad[4]:
            base = edge_dot(q_table, _heads(k_table, h, d), dsafe, src)
            grad_p = torch.zeros_like(p_stack).index_add_(
                0, rel.long(), torch.where(valid[:, None], dlogit * base,
                                           0.0))
        dbase = _rep(dlogit * p_stack[rel], d)
        grad_k = grad_v = grad_q = None
        src_drop = torch.where(valid, src, m)
        if ctx.needs_input_grad[1]:
            dk = dbase * q_table.reshape(num_dst, hd)[dsafe]
            grad_k = _scatter_rows(torch.where(valid[:, None], dk, 0.0),
                                   src_drop, m)
        if ctx.needs_input_grad[2]:
            grad_v = _scatter_rows(torch.where(valid[:, None], dv, 0.0),
                                   src_drop, m)
        if ctx.needs_input_grad[3]:
            dqe = dbase * k_table[src]
            grad_q = _scatter_rows(torch.where(valid[:, None], dqe, 0.0),
                                   dst, num_dst).view(num_dst, h, d)
        return None, grad_k, grad_v, grad_q, grad_p, None, None, None


def hetero_edge_attention(kv_table: torch.Tensor, q_table: torch.Tensor,
                          p_stack: torch.Tensor, rel: torch.Tensor,
                          src: torch.Tensor, dst: torch.Tensor,
                          num_dst: int) -> torch.Tensor:
    """Union-softmax edge attention over one destination node set.

    ``kv_table [M, 2 H D]`` is FLAT, the ``k`` half then the ``v`` half,
    each head-major; ``q_table [num_dst, H, D]``; ``p_stack [R, H]`` the
    per-relation prior and ``rel [E]`` each edge's relation (one relation:
    ``p_stack = [1, H]``, ``rel = zeros``). ``src`` must be in range;
    ``dst >= num_dst`` marks a padded or invalid edge. Returns ``[num_dst,
    H, D]``."""
    hd = kv_table.shape[1] // 2
    return _Attention.apply(int(num_dst), kv_table[:, :hd], kv_table[:, hd:],
                            q_table.contiguous(), p_stack, rel, src, dst)


def hetero_edge_attention_multi(k_tabs: Sequence[torch.Tensor],
                                v_tabs: Sequence[torch.Tensor],
                                q_table: torch.Tensor,
                                p_rels: Sequence[torch.Tensor],
                                s_list: Sequence[torch.Tensor],
                                d_list: Sequence[torch.Tensor],
                                num_dst: int, layout=None) -> torch.Tensor:
    """Union-softmax edge attention over per-relation node tables.

    ``k_tabs`` / ``v_tabs``: per relation ``[N_r, H, D]``; ``p_rels``: per
    relation ``[H]`` priors; ``s_list``: per relation in-range source ids
    into that relation's table; ``d_list``: destination ids (``>=
    num_dst`` marks padded or invalid edges). The route is decided as the
    JAX package decides it, from shapes only (nothing waits for the card):
    the wide op while ``E * H * 2 * D * 4`` bytes stay within
    ``PGT_ATTN_WIDE_BYTES`` (default :data:`ATTN_WIDE_BYTES`); past it, or
    with a ``layout``, the JAX package takes the flash scan, which is not
    ported and raises."""
    if layout is not None:
        _not_ported('the host-presorted flash layout (FlashLayout)')
    e_tot = sum(int(s.shape[0]) for s in s_list)
    h, d_hid = q_table.shape[1], q_table.shape[2]
    cap = float(os.environ.get('PGT_ATTN_WIDE_BYTES', ATTN_WIDE_BYTES))
    if e_tot * h * 2 * d_hid * 4 > cap:
        _not_ported(f'the online-softmax flash scan, which the JAX package '
                    f'takes past PGT_ATTN_WIDE_BYTES ({e_tot} edges x {h} '
                    f'heads x 2 x {d_hid} x 4 bytes),')
    if len(k_tabs) == 1:
        k_cat = k_tabs[0].reshape(k_tabs[0].shape[0], -1)
        v_cat = v_tabs[0].reshape(v_tabs[0].shape[0], -1)
    else:
        k_cat = torch.cat([k.reshape(k.shape[0], -1) for k in k_tabs])
        v_cat = torch.cat([v.reshape(v.shape[0], -1) for v in v_tabs])
    p_stack = torch.stack(list(p_rels))
    off, s_off, rel_parts = 0, [], []
    for i, (k, s) in enumerate(zip(k_tabs, s_list)):
        s_off.append(s.long() + off)
        off += k.shape[0]
        rel_parts.append(torch.full((s.shape[0],), i, dtype=torch.int64,
                                    device=s.device))
    s_glob = torch.cat(s_off)
    d_glob = torch.cat([d.long() for d in d_list])
    rel_glob = torch.cat(rel_parts)
    # the union sorted by destination once (invalid edges carry num_dst and
    # sort last), the JAX package's rule; the sums then run in that order
    sort_min = int(float(os.environ.get('PGT_ATTN_SORT_MIN_EDGES',
                                        ATTN_SORT_MIN_EDGES)))
    if e_tot >= sort_min:
        order = torch.argsort(d_glob, stable=True)
        s_glob, d_glob, rel_glob = s_glob[order], d_glob[order], \
            rel_glob[order]
    return _Attention.apply(int(num_dst), k_cat, v_cat, q_table.contiguous(),
                            p_stack, rel_glob, s_glob, d_glob)
