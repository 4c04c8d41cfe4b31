"""Union-softmax edge attention: the wide-gather op and the flash scans.

Counterpart of ``pytorch_geometric_tpu/ops/edge_attention.py``: every
relation that targets one destination set goes through ONE softmax over the
union of their edges,

    out[n] = sum_{e: dst_e = n} softmax_n(p[rel_e] <q[n], k[src_e]>) v[src_e]

Two routes, chosen as the JAX package chooses them:

  * wide (:func:`hetero_edge_attention`, and the multi-relation op while
    ``E * H * 2 * D * 4`` bytes stay within ``PGT_ATTN_WIDE_BYTES``): the JAX
    package's custom backward (``_attention``, ``:84-160``), which saves only
    ``alpha`` and recomputes the rest. The logits, the backward's ``dalpha =
    <g[dst], v[src]>`` and its ``base = <q[dst], k[src]>`` run on the
    per-edge dot kernel (``ops/edge_dot.py::edge_dot``); the softmax is
    ``ops.softmax``, and the value gathers and scatters are PyTorch's gathers
    and ``index_add_``, as the JAX package leaves them to XLA. On the card
    those adds are atomic, so the gradients' last bits may change from run
    to run. The JAX package keeps ``k`` and ``v`` in one flat ``[M, 2 H D]``
    table for the TPU's one wide gather; here they are two tables, or two
    column halves of one, read in place;
  * flash (past the cap, or with a :class:`FlashLayout`): the online-softmax
    scan (``_attention_flash`` ``:321-456``, with the source-sorted backward
    of ``_attention_flash_dual`` ``:459-551`` for a layout that carries its
    source-sorted copy), on the flash kernels (``ops/flash_softmax.py``,
    ``csrc/flash_softmax.cu``) on the card and their chunked plain versions
    on the CPU. So are the GAT and GATv2 forms (:func:`gat_flash_attention`,
    :func:`gatv2_flash_attention`), which the convs take for graphs whose
    messages pass the cap. Every flash route builds no ``[E, .]`` float
    array: the scans read node tables and edge ids only.

:func:`build_hgt_flash_layouts` builds HGT's per-destination-type layouts
on the host. Not ported (ROADMAP Queue 1): the resumable block API
``gat_flash_{fwd,bwd}_{start,block,finish}``.
"""

import os
from typing import Optional, Sequence

import numpy as np
import torch

from . import flash_softmax as _fs
from .edge_dot import edge_dot
from .softmax import softmax

__all__ = ['hetero_edge_attention', 'hetero_edge_attention_multi',
           'gat_flash_attention', 'gatv2_flash_attention', 'FlashLayout',
           'build_union_flash_layout', 'build_hgt_flash_layouts',
           'ATTN_WIDE_BYTES']

# the JAX package's PGT_ATTN_WIDE_BYTES default (WIDE_BYTES_CAP): past this
# many bytes of [E, H, 2 D] float32 gathers the JAX package takes the flash
# scan
ATTN_WIDE_BYTES = 1e9
# its PGT_ATTN_SORT_MIN_EDGES default: from this many union edges on, the
# union is sorted by destination once
ATTN_SORT_MIN_EDGES = 1 << 20
# its PGT_ATTN_CHUNK_EDGES default: the flash scans' edges a chunk
ATTN_CHUNK_EDGES = 2e6


def wide_bytes_cap() -> float:
    """``PGT_ATTN_WIDE_BYTES``, read on every call as the JAX package reads
    it (default :data:`ATTN_WIDE_BYTES`)."""
    return float(os.environ.get('PGT_ATTN_WIDE_BYTES', ATTN_WIDE_BYTES))


def _sort_min() -> int:
    return int(float(os.environ.get('PGT_ATTN_SORT_MIN_EDGES',
                                    ATTN_SORT_MIN_EDGES)))


def _chunk_edges() -> int:
    return int(float(os.environ.get('PGT_ATTN_CHUNK_EDGES',
                                    ATTN_CHUNK_EDGES)))


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


# -- the flash scans ------------------------------------------------------------
# the device types on which the flash route pads each head to a multiple of
# ALIGN_COLUMNS columns, so that the kernels read every row as 16-byte
# vectors (a zero column adds exact zeros to every sum); the CPU's plain
# scan runs unpadded
ALIGN_HEADS_ON = ('cuda',)
ALIGN_COLUMNS = 4


def _pad_heads(t: Optional[torch.Tensor], h: int, c: int, cp: int
               ) -> Optional[torch.Tensor]:
    """``[N, H c]`` (or ``[H c]``) to ``[N, H cp]``: each head followed by
    ``cp - c`` zero columns."""
    if t is None or cp == c:
        return t
    rows = t.reshape(-1, h, c)
    out = torch.nn.functional.pad(rows, (0, cp - c))
    return out.reshape(t.shape[:-1] + (h * cp,))


def _unpad_heads(t: Optional[torch.Tensor], h: int, c: int, cp: int
                 ) -> Optional[torch.Tensor]:
    """The inverse of :func:`_pad_heads`: each head's first ``c``
    columns."""
    if t is None or cp == c:
        return t
    return t.reshape(-1, h, cp)[..., :c].reshape(t.shape[:-1] + (h * c,))


class _FlashAttention(torch.autograd.Function):
    """The online-softmax scan of one logit form (``ops/flash_softmax.py``):
    forward kernel (a) on the card or the chunked plain scan on the CPU,
    residuals ``(m, l, out)``, backward kernels (b) and (c) or the chunked
    plain backward.

    ``s``, ``d``, ``rel`` are the edges (``d >= num_dst`` drops one), sorted
    by destination when ``presorted``; ``chunk`` the plain scan's edges a
    chunk (the kernels walk no chunks). On the card the plans sort the edges
    (``dst_plan``, ``src_plan``). ``bwd`` is None, or a layout's
    source-sorted copy ``(s_t, d_t, rel_t)`` that the backward walks
    instead (the JAX package's ``_attention_flash_dual``).

    On a device of :data:`ALIGN_HEADS_ON`, heads of ``C`` columns not a
    multiple of :data:`ALIGN_COLUMNS` are padded with zero columns once per
    call: the values, GATv2's ``x_r`` and ``att``, the dot form's ``q`` and
    ``k`` (the GAT logit parts ``[N, H]`` and the prior ``p [R, H]`` stay),
    and the output gradient. The padded tables and output are the
    residuals; outputs and gradients are sliced back to ``C``."""

    @staticmethod
    def forward(ctx, form, heads, slope, num_dst, presorted, chunk, bwd,
                src_tab, dst_tab, val, extra, s, d, rel):
        c = val.shape[1] // heads
        cp = c
        if val.device.type in ALIGN_HEADS_ON:
            cp = -(-c // ALIGN_COLUMNS) * ALIGN_COLUMNS
        if cp != c:
            same = src_tab is val
            val = _pad_heads(val, heads, c, cp)
            if form != 'gat':
                src_tab = val if same else _pad_heads(src_tab, heads, c, cp)
                dst_tab = _pad_heads(dst_tab, heads, c, cp)
            if form == 'gatv2':
                extra = _pad_heads(extra, heads, c, cp)
        ops = _fs.FlashOperands(form, heads, src_tab, dst_tab, val, extra,
                                slope)
        plan = None
        if val.is_cuda:
            plan = _fs.dst_plan(s, d, rel, num_dst, presorted)
        out, m, l = _fs.flash_forward(ops, s, d, rel, num_dst, chunk, plan)
        ctx.meta = (form, heads, slope, num_dst, chunk, plan, c, cp)
        ctx.bwd = bwd
        ctx.save_for_backward(src_tab, dst_tab, val, extra, s, d, rel, m, l,
                              out)
        if cp != c:
            return out.view(num_dst, heads, cp)[..., :c].contiguous()
        return out.view(num_dst, heads, -1)

    @staticmethod
    def backward(ctx, g):
        form, heads, slope, num_dst, chunk, plan, c, cp = ctx.meta
        src_tab, dst_tab, val, extra, s, d, rel, m, l, out = ctx.saved_tensors
        ops = _fs.FlashOperands(form, heads, src_tab, dst_tab, val, extra,
                                slope)
        src_sorted = ctx.bwd is not None
        if src_sorted:
            s, d, rel = ctx.bwd
        plan_t = None
        if val.is_cuda:
            plan_t = _fs.src_plan(s, d, rel, num_dst, src_tab.shape[0],
                                  src_sorted)
        g = _pad_heads(g.reshape(num_dst, heads * c), heads, c, cp)
        d_src, d_dst, d_val, d_extra = _fs.flash_backward(
            ops, s, d, rel, num_dst, chunk, m, l, out, g, plan, plan_t)
        if form != 'gat':
            d_src = _unpad_heads(d_src, heads, c, cp)
            d_dst = _unpad_heads(d_dst, heads, c, cp)
        d_val = _unpad_heads(d_val, heads, c, cp)
        if form == 'gatv2':
            d_extra = _unpad_heads(d_extra, heads, c, cp)
            d_val = None       # x_l's value gradient is in d_src
        return (None,) * 7 + (d_src, d_dst, d_val, d_extra, None, None, None)


def _flash(form, heads, slope, src_tab, dst_tab, val, extra, s, d, rel,
           num_dst, chunk=None, presorted=False, bwd=None):
    """A flash scan over the edges ``(s, d, rel)``. On the CPU they are
    sorted by destination from ``PGT_ATTN_SORT_MIN_EDGES`` edges on (the
    JAX package's rule, which fixes the order of the plain scan's sums)
    unless ``presorted``, and scanned ``chunk`` (``PGT_ATTN_CHUNK_EDGES``)
    at a time, the last chunk short where the JAX package pads it with
    dropped edges. On the card the plan builder sorts them."""
    if chunk is None:
        chunk = _chunk_edges()
    if not (presorted or val.is_cuda) and s.shape[0] >= _sort_min():
        order = torch.argsort(d, stable=True)
        s, d = s[order], d[order]
        rel = None if rel is None else rel[order]
        presorted = True
    return _FlashAttention.apply(form, int(heads), float(slope), int(num_dst),
                                 bool(presorted), max(int(chunk), 1), bwd,
                                 src_tab, dst_tab, val, extra, s, d, rel)


def gat_flash_attention(a_src: torch.Tensor, a_dst: torch.Tensor,
                        v: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                        num_dst: int, negative_slope: float = 0.2,
                        chunk: Optional[int] = None) -> torch.Tensor:
    """Giant-graph GAT aggregation: additive node logits, leaky_relu, the
    segment softmax and the weighted sum as one online-softmax scan (the
    JAX package's ``gat_flash_attention``, ``:1030-1067``).

    ``a_src [N_src, H]`` and ``a_dst [num_dst, H]`` the logit parts; ``v
    [N_src, H, C]`` the values; ``src`` in range; ``dst >= num_dst`` marks a
    padded or invalid edge. Returns ``[num_dst, H, C]``. Memory: one chunk
    of ``PGT_ATTN_CHUNK_EDGES`` edges on the CPU; on the card the kernels
    keep nothing per edge."""
    v_flat = v.reshape(v.shape[0], -1)
    return _flash('gat', a_src.shape[1], negative_slope, a_src, a_dst,
                  v_flat, None, src, dst, None, num_dst, chunk)


def gatv2_flash_attention(x_l: torch.Tensor, x_r: torch.Tensor,
                          att: torch.Tensor, src: torch.Tensor,
                          dst: torch.Tensor, num_dst: int,
                          negative_slope: float = 0.2,
                          chunk: Optional[int] = None) -> torch.Tensor:
    """Giant-graph GATv2 aggregation (``:1187-1215``): the logit is ``att .
    leaky_relu(x_l[src] + x_r[dst])``, computed per edge inside the scan.
    ``x_l [N_src, H, C]`` (the values and the source half), ``x_r
    [num_dst, H, C]``, ``att [H, C]``. Returns ``[num_dst, H, C]``."""
    h = x_l.shape[1]
    xl = x_l.reshape(x_l.shape[0], -1)
    return _flash('gatv2', h, negative_slope, xl,
                  x_r.reshape(x_r.shape[0], -1), xl, att.reshape(-1), src,
                  dst, None, num_dst, chunk)


class FlashLayout:
    """A host-built union edge layout for the flash scan (the JAX package's
    ``FlashLayout``, ``:560-592``): the union sorted by destination and
    padded to whole chunks (``s_ch``, ``d_ch``, ``rel_ch``, each ``[nc, C]``
    int32; pads have ``d == num_dst``), its edge count ``e_tot``, and
    optionally the same edges sorted by source (``s_t``, ``d_t``,
    ``rel_t``; an invalid edge takes the source table's size and sorts
    last), which the backward walks. Build it once per graph with
    :func:`build_union_flash_layout`; a plain class (no pytree here)."""

    def __init__(self, s_ch, d_ch, rel_ch, e_tot: int, s_t=None, d_t=None,
                 rel_t=None):
        self.s_ch, self.d_ch, self.rel_ch = s_ch, d_ch, rel_ch
        self.e_tot = int(e_tot)
        self.s_t, self.d_t, self.rel_t = s_t, d_t, rel_t


def _stable_order(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind='stable')``: a stable sort's permutation is
    unique, and torch's sorts on every core."""
    return torch.sort(torch.from_numpy(keys), stable=True)[1].numpy()


def build_union_flash_layout(s_list, d_list, table_sizes, num_dst: int,
                             chunk: Optional[int] = None,
                             device=None) -> FlashLayout:
    """The host pass of the JAX package's ``build_union_flash_layout``
    (``:595-646``), in numpy: each relation's sources offset into the
    concatenated table, the union sorted by destination once (stable;
    invalid edges carry ``num_dst`` and sort last), padded to a chunk
    multiple; and, unless ``PGT_ATTN_BWD_SRC_SORTED=0``, the source-sorted
    copy. The arrays go to ``device`` (None: the card)."""
    from ..backend import resolve_device
    dev = resolve_device(device)
    if chunk is None:
        chunk = _chunk_edges()
    off, s_parts, rel_parts = 0, [], []
    for i, (s, nrows) in enumerate(zip(s_list, table_sizes)):
        s = np.asarray(s, np.int64)
        s_parts.append(s + off)
        off += int(nrows)
        rel_parts.append(np.full(len(s), i, np.int32))
    s_glob = np.concatenate(s_parts) if s_parts else np.zeros(0, np.int64)
    d_glob = (np.concatenate([np.asarray(d, np.int64) for d in d_list])
              if d_list else np.zeros(0, np.int64))
    rel_glob = (np.concatenate(rel_parts) if rel_parts
                else np.zeros(0, np.int32))
    e_tot = len(s_glob)
    c = max(min(chunk, max(e_tot, 1)), 1)
    nc = max(-(-e_tot // c), 1)
    pad = nc * c - e_tot
    m_total = int(off)

    def chunked(s, d, r, s_pad, d_pad):
        return tuple(torch.from_numpy(np.ascontiguousarray(
            np.pad(a, (0, pad), constant_values=fill).reshape(nc, c)
            .astype(np.int32))).to(dev)
            for a, fill in ((s, s_pad), (d, d_pad), (r, 0)))

    order = _stable_order(d_glob)
    s_f, d_f, r_f = chunked(s_glob[order], d_glob[order], rel_glob[order],
                            0, num_dst)
    if os.environ.get('PGT_ATTN_BWD_SRC_SORTED', '1') == '0':
        return FlashLayout(s_f, d_f, r_f, e_tot)
    s2 = np.where(d_glob >= num_dst, m_total, s_glob)
    order_t = _stable_order(s2)
    s_b, d_b, r_b = chunked(s2[order_t], d_glob[order_t], rel_glob[order_t],
                            m_total, num_dst)
    return FlashLayout(s_f, d_f, r_f, e_tot, s_b, d_b, r_b)


def build_hgt_flash_layouts(metadata, edge_index_dict, num_nodes_dict,
                            chunk: Optional[int] = None, feature_types=None,
                            device=None):
    """Per-destination-type :class:`FlashLayout` dict for
    :class:`~pytorch_geometric_tpu_torch.nn.conv.HGTConv` (the JAX
    package's ``build_hgt_flash_layouts``, ``:649-687``): the conv's
    relation grouping and order and its endpoint clamps, on the host.

    ``feature_types``: the node types present in ``x_dict`` at call time
    (default: every type of ``num_nodes_dict``); the conv drops relations
    whose endpoint type has no features, and the layout must drop the same
    ones, or its relation ids and table offsets go stale (the conv checks
    the edge totals and raises on a mismatch). The arrays go to ``device``
    (None: the card)."""
    from ..data.data import host
    node_types, edge_types = metadata
    if feature_types is None:
        feature_types = set(num_nodes_dict)
    feature_types = set(feature_types)
    by_dst = {}
    for et in edge_types:
        src, rel, dst = et
        if (et not in edge_index_dict or src not in feature_types
                or dst not in feature_types):
            continue
        by_dst.setdefault(dst, []).append((src, et))
    out = {}
    for dst, rels in by_dst.items():
        n = int(num_nodes_dict[dst])
        s_list, d_list, sizes = [], [], []
        for src, et in rels:
            coo = host(edge_index_dict[et])
            n_src = int(num_nodes_dict[src])
            valid = (coo[0] < n_src) & (coo[1] < n)
            s_list.append(np.minimum(coo[0], n_src - 1))
            d_list.append(np.where(valid, np.minimum(coo[1], n - 1), n))
            sizes.append(n_src)
        out[dst] = build_union_flash_layout(s_list, d_list, sizes, n,
                                            chunk=chunk, device=device)
    return out


def hetero_edge_attention_multi(k_tabs: Sequence[torch.Tensor],
                                v_tabs: Sequence[torch.Tensor],
                                q_table: torch.Tensor,
                                p_rels: Sequence[torch.Tensor],
                                s_list: Sequence[torch.Tensor],
                                d_list: Sequence[torch.Tensor],
                                num_dst: int,
                                layout: Optional[FlashLayout] = None
                                ) -> torch.Tensor:
    """Union-softmax edge attention over per-relation node tables.

    ``k_tabs`` / ``v_tabs``: per relation ``[N_r, H, D]``; ``p_rels``: per
    relation ``[H]`` priors; ``s_list``: per relation in-range source ids
    into that relation's table; ``d_list``: destination ids (``>=
    num_dst`` marks padded or invalid edges). The route is decided as the
    JAX package decides it, from shapes only (nothing waits for the card):
    the wide op while ``E * H * 2 * D * 4`` bytes stay within
    ``PGT_ATTN_WIDE_BYTES`` (default :data:`ATTN_WIDE_BYTES`); past it the
    flash scan, whose memory is one chunk. A ``layout``
    (:func:`build_union_flash_layout` over the same relations) always takes
    the flash scan, over its presorted edges, with no sort per call."""
    e_tot = sum(int(s.shape[0]) for s in s_list)
    h, d_hid = q_table.shape[1], q_table.shape[2]
    wide = layout is None and e_tot * h * 2 * d_hid * 4 <= wide_bytes_cap()
    if len(k_tabs) == 1:
        k_cat = k_tabs[0].reshape(k_tabs[0].shape[0], -1)
        v_cat = v_tabs[0].reshape(v_tabs[0].shape[0], -1)
    else:
        k_cat = torch.cat([k.reshape(k.shape[0], -1) for k in k_tabs])
        v_cat = torch.cat([v.reshape(v.shape[0], -1) for v in v_tabs])
    p_stack = torch.stack(list(p_rels))
    q_flat = q_table.reshape(num_dst, -1)
    if layout is not None:
        if layout.e_tot != e_tot:
            raise ValueError(
                f'FlashLayout holds {layout.e_tot} union edges but the call '
                f'provides {e_tot}: the layout is stale or was built with a '
                f'different relation set')
        bwd = None
        if layout.s_t is not None:
            bwd = (layout.s_t.reshape(-1), layout.d_t.reshape(-1),
                   layout.rel_t.reshape(-1))
        return _flash('dot', h, 0.0, k_cat, q_flat, v_cat, p_stack,
                      layout.s_ch.reshape(-1), layout.d_ch.reshape(-1),
                      layout.rel_ch.reshape(-1), num_dst,
                      chunk=layout.s_ch.shape[1], presorted=True, bwd=bwd)
    off, s_off, rel_parts = 0, [], []
    for i, (k, s) in enumerate(zip(k_tabs, s_list)):
        s_off.append(s.long() + off)
        off += k.shape[0]
        rel_parts.append(torch.full((s.shape[0],), i, dtype=torch.int64,
                                    device=s.device))
    s_glob = torch.cat(s_off)
    d_glob = torch.cat([d.long() for d in d_list])
    rel_glob = torch.cat(rel_parts)
    if not wide:
        return _flash('dot', h, 0.0, k_cat, q_flat, v_cat, p_stack, s_glob,
                      d_glob, rel_glob, num_dst)
    # the union sorted by destination once (invalid edges carry num_dst and
    # sort last), the JAX package's rule; the sums then run in that order
    if e_tot >= _sort_min():
        order = torch.argsort(d_glob, stable=True)
        s_glob, d_glob, rel_glob = s_glob[order], d_glob[order], \
            rel_glob[order]
    return _Attention.apply(int(num_dst), k_cat, v_cat, q_table.contiguous(),
                            p_stack, rel_glob, s_glob, d_glob)
