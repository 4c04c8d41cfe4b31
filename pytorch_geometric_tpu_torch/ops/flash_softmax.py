"""The online-softmax flash kernels (``csrc/flash_softmax.cu``), their plain
versions, their launch plan and their launch counts.

Three logit forms share one segment softmax-aggregation over each
destination's incoming edges,

    out[d, h] = sum_e softmax_d(logit[e, h]) val[s_e, h],

    gat:   logit = leaky(a_src[s, h] + a_dst[d, h]),          val = v
    gatv2: logit = att[h] . leaky(x_l[s, h] + x_r[d, h]),     val = x_l
    dot:   logit = p[rel_e, h] <q[d, h], k[s, h]>,            val = v

with the residuals ``(m, l, out)`` (the row max, the normaliser and the
output) and the custom backward of the JAX package's flash scans
(``pytorch_geometric_tpu/ops/edge_attention.py``: ``_attention_flash``
``:321-456``, ``_gat_flash`` ``:801-926``, ``_gatv2_flash`` ``:1070-1184``).
Every form is held in one layout, :class:`FlashOperands`: ``src_tab`` read
per edge at its source (``a_src``, ``x_l``, ``k``), ``dst_tab`` per row
(``a_dst``, ``x_r``, ``q``), ``val`` (``v``, or ``x_l`` again) and
``extra`` (``att [H C]`` or the prior ``p [R, H]``).

The JAX package's scans are XLA ``lax.scan``s over edge chunks, with no
Pallas body. :func:`flash_forward_plain` and :func:`flash_backward_plain`
copy their segment-op formulation chunk by chunk (``PGT_ATTN_CHUNK_EDGES``
edges a chunk), so their memory stays one chunk's in both directions. The
scatter-mode lowering of the JAX package (``_scatter_online_update``,
``_scatter_flash_scan``, ``PGT_ATTN_FLASH_IMPL``, ``PGT_ATTN_FLASH_W``)
picks an XLA:TPU lane layout for the same function and has no counterpart
here.

On the card :func:`flash_forward` launches kernel (a), destination-major over
the CSR of the destination-sorted edges, and :func:`flash_backward` kernel
(b), the destination pass, then kernel (c), the source pass over the
source-sorted permutation of the same edges (the role of the JAX package's
``_attention_flash_dual``). All three walk a row's edges with one warp per
row and group of heads (:class:`TeamShape`: 16-byte loads where the rows
allow, the next batch's edges fetched while one is used; kernel (a) keeps
an online softmax per head, rescaled once a batch), kernel (b) handing
kernel (c) one record ``(m, l, gdot, a_dst)`` per row and head. Each keeps
its sums in registers: no ``[E, .]`` intermediate, no atomic sums. A row
longer than ``FLASH_SPLIT_EDGES`` edges is cut into pieces, each with its
own partial sums, merged in piece order by the warp that finishes last
(:class:`FlashPlan`, whose ``piece_row`` maps a piece to its row). So two
launches give the same bits.

The plan (:func:`csr_plan`, :func:`dst_plan`, :func:`src_plan`) is built on
the device with sorts, ``searchsorted`` and ``cumsum``: nothing waits for
the card, so ``compat.compile`` can capture a path that builds it.

:func:`flash_forward` and :func:`flash_backward` run the plain versions for
CPU tensors and launch the kernels for CUDA tensors; they never fall back
from one to the other. The kernels take float32; each counts its launches
(``flash_forward.launches``, ``flash_backward.launches_dst``,
``flash_backward.launches_src``).
"""

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ..compat import register_launch_counter

FORMS = ('gat', 'gatv2', 'dot')
# a row longer than this many edges is cut into pieces of at most this many,
# each walked by its own team, its partials merged in piece order
FLASH_SPLIT_EDGES = 512
# the widest head the kernels take: 32 lanes of 16 columns
MAX_HEAD_COLUMNS = 512
# threads a block (the kernels' kThreads): the launch's block count, which
# sizes the per-block partials of kernel (b), follows from it
_THREADS = 256


class FlashOperands(NamedTuple):
    """One logit form's tables: ``src_tab`` is read at each edge's source,
    ``dst_tab`` at its destination, ``val`` holds the values and ``extra``
    GATv2's ``att [H C]`` or the dot form's prior ``p [R, H]`` (None for
    GAT). Each table is ``[N, H]`` (GAT's logit parts) or ``[N, H C]``,
    row-major; ``k`` and ``v`` may be column halves of one wider table."""
    form: str
    heads: int
    src_tab: torch.Tensor
    dst_tab: torch.Tensor
    val: torch.Tensor
    extra: Optional[torch.Tensor]
    slope: float = 0.2

    @property
    def columns(self) -> int:
        return self.val.shape[1] // self.heads


def _leaky(x, slope):
    return torch.where(x >= 0, x, slope * x)


def _rep(a: torch.Tensor, d: int) -> torch.Tensor:
    return a.repeat_interleave(d, dim=1)


def _chunks(n: int, chunk: int):
    chunk = max(int(chunk), 1)
    return [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]


def _logit_plain(ops: FlashOperands, s, d, r, num_dst):
    """``_flash_logit`` / ``_gat_logit`` / ``_gatv2_logit`` of the JAX
    package on one chunk: ``(logit, base, joint, valid, dsafe)``, the logit
    ``-inf`` on an invalid edge (``d >= num_dst``)."""
    h, dh = ops.heads, ops.columns
    c = s.shape[0]
    valid = d < num_dst
    dsafe = d.clamp(max=max(num_dst - 1, 0))
    joint = None
    if ops.form == 'gat':
        base = ops.src_tab[s] + ops.dst_tab[dsafe]               # [C, H]
        logit = _leaky(base, ops.slope)
    elif ops.form == 'gatv2':
        base = ops.src_tab[s] + ops.dst_tab[dsafe]               # [C, HC]
        joint = _leaky(base, ops.slope)
        logit = (joint * ops.extra).view(c, h, dh).sum(-1)
    else:
        base = (ops.dst_tab[dsafe] * ops.src_tab[s]).view(c, h, dh).sum(-1)
        logit = base * ops.extra[r]
    logit = torch.where(valid[:, None], logit, -math.inf)
    return logit, base, joint, valid, dsafe


def _seg_max(x, seg, n):
    out = x.new_full((n + 1,) + x.shape[1:], -math.inf)
    idx = seg[:, None].expand_as(x)
    return out.scatter_reduce_(0, idx, x, 'amax', include_self=True)[:n]


def _seg_sum(x, seg, n):
    return x.new_zeros((n + 1,) + x.shape[1:]).index_add_(0, seg, x)[:n]


def flash_forward_plain(ops: FlashOperands, s: torch.Tensor, d: torch.Tensor,
                        rel: Optional[torch.Tensor], num_dst: int,
                        chunk: int):
    """The JAX package's segment-op forward scan, ``chunk`` edges at a time:
    ``(out [num_dst, H C], m [num_dst, H], l [num_dst, H])``. Empty rows
    keep ``m = -inf`` and ``l = 0`` and give ``out = 0``."""
    h, dh = ops.heads, ops.columns
    dt, dev = ops.val.dtype, ops.val.device
    m = torch.full((num_dst, h), -math.inf, dtype=dt, device=dev)
    l = torch.zeros((num_dst, h), dtype=dt, device=dev)
    acc = torch.zeros((num_dst, h * dh), dtype=dt, device=dev)
    for lo, hi in _chunks(s.shape[0], chunk):
        sc, dc = s[lo:hi].long(), d[lo:hi].long()
        rc = None if rel is None else rel[lo:hi].long()
        logit, _, _, valid, dsafe = _logit_plain(ops, sc, dc, rc, num_dst)
        dseg = torch.where(valid, dc, num_dst)
        m_new = torch.maximum(m, _seg_max(logit, dseg, num_dst))
        # rescale the running sums from the old max to the new; an empty
        # row keeps m = -inf until an edge reaches it
        scale = torch.exp(torch.where(m > m_new, 0.0, m - m_new))
        scale = torch.where(torch.isfinite(m), scale, 0.0)
        z = torch.exp(logit - torch.where(torch.isfinite(m_new), m_new,
                                          0.0)[dsafe])
        z = torch.where(valid[:, None], z, 0.0)
        l = l * scale + _seg_sum(z, dseg, num_dst)
        msg = ops.val[sc] * _rep(z, dh)
        acc = acc * _rep(scale, dh) + _seg_sum(msg, dseg, num_dst)
        m = m_new
    out = acc / _rep(l.clamp(min=1e-16), dh)
    return out, m, l


def flash_backward_plain(ops: FlashOperands, s: torch.Tensor, d: torch.Tensor,
                         rel: Optional[torch.Tensor], num_dst: int,
                         chunk: int, m: torch.Tensor, l: torch.Tensor,
                         out: torch.Tensor, g: torch.Tensor,
                         abs_terms: bool = False):
    """The JAX package's backward scan, ``chunk`` edges at a time, over the
    edges ``(s, d, rel)`` in any order (an invalid edge has ``d >=
    num_dst``; its ``s`` may be the table size, as in the source-sorted copy
    of a layout). Returns ``(d_src_tab, d_dst_tab, d_val, d_extra)``; GATv2's
    value gradient is in ``d_src_tab`` (``val`` is ``x_l``) and its
    ``d_val`` is None, as is GAT's ``d_extra``.

    ``abs_terms``: each entry is instead the sum of its terms' magnitudes,
    the scale of its rounding. Every row's ``dlogit`` sums to zero (the
    softmax's VJP), so a gradient summed over a row's edges (or over all
    edges, as GATv2's ``att``) can be far smaller than its terms."""
    mag = torch.abs if abs_terms else (lambda t: t)
    h, dh = ops.heads, ops.columns
    n_src = ops.src_tab.shape[0]
    g = g.reshape(num_dst, h * dh)
    gdot = (g * out).view(num_dst, h, dh).sum(-1)
    l_safe = l.clamp(min=1e-16)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    d_src = torch.zeros((n_src + 1, ops.src_tab.shape[1]), dtype=g.dtype,
                        device=g.device)
    d_dst = torch.zeros((num_dst + 1, ops.dst_tab.shape[1]), dtype=g.dtype,
                        device=g.device)
    d_val = (torch.zeros((n_src + 1, h * dh), dtype=g.dtype, device=g.device)
             if ops.form != 'gatv2' else None)
    d_extra = (torch.zeros_like(ops.extra) if ops.extra is not None
               else None)
    for lo, hi in _chunks(s.shape[0], chunk):
        dc = d[lo:hi].long()
        sc = s[lo:hi].long().clamp(max=n_src - 1)
        rc = None if rel is None else rel[lo:hi].long()
        logit, base, joint, valid, dsafe = _logit_plain(ops, sc, dc, rc,
                                                        num_dst)
        alpha = torch.exp(logit - m_safe[dsafe]) / l_safe[dsafe]
        alpha = torch.where(valid[:, None], alpha, 0.0)
        g_e = g[dsafe]
        dalpha = (g_e * ops.val[sc]).view(-1, h, dh).sum(-1)
        dlogit = alpha * (dalpha - gdot[dsafe])
        sdrop = torch.where(valid, sc, n_src)
        ddrop = torch.where(valid, dc, num_dst)
        if ops.form == 'gat':
            dbase = torch.where(base >= 0, dlogit, ops.slope * dlogit)
            dbase = mag(torch.where(valid[:, None], dbase, 0.0))
            d_src.index_add_(0, sdrop, dbase)
            d_dst.index_add_(0, ddrop, dbase)
            d_val.index_add_(0, sdrop, mag(g_e * _rep(alpha, dh)))
        elif ops.form == 'gatv2':
            dlogit = torch.where(valid[:, None], dlogit, 0.0)
            dl_rep = _rep(dlogit, dh)
            d_extra += mag(joint * dl_rep).sum(0)
            djoint = dl_rep * ops.extra
            dbase = torch.where(base >= 0, djoint, ops.slope * djoint)
            d_src.index_add_(0, sdrop, dbase + g_e * _rep(alpha, dh)
                             if not abs_terms else
                             mag(dbase) + mag(g_e * _rep(alpha, dh)))
            d_dst.index_add_(0, ddrop, mag(dbase))
        else:
            d_extra.index_add_(0, rc, mag(torch.where(valid[:, None],
                                                      dlogit * base, 0.0)))
            dbase = _rep(dlogit * ops.extra[rc], dh)
            d_src.index_add_(0, sdrop, mag(dbase * ops.dst_tab[dsafe]))
            d_val.index_add_(0, sdrop, mag(g_e * _rep(alpha, dh)))
            d_dst.index_add_(0, ddrop, mag(dbase * ops.src_tab[sc]))
    return (d_src[:n_src], d_dst[:num_dst],
            None if d_val is None else d_val[:n_src], d_extra)


# -- the launch plan ------------------------------------------------------------
class FlashPlan(NamedTuple):
    """One CSR the kernels walk, cut into pieces.

    ``nbr [E]`` (int32) holds each edge's other endpoint and ``rel [E]``
    (int32, or None) its relation, grouped by row; row ``i``'s edges are
    ``rowptr[i]:rowptr[i + 1]``. Row ``i`` is walked as ``max(1,
    ceil(deg / split))`` pieces, pieces ``piece_ptr[i]:piece_ptr[i + 1]``
    (an empty row is one piece, which writes zeros), and ``piece_row [p]``
    (int32, ``max_pieces`` long, clamped past the last piece) is the row of
    piece ``p``; a row of more than one piece keeps its partials in scratch
    slots ``split_base[i] + k``. ``max_pieces`` and ``n_slots`` bound the
    pieces and slots from the shapes alone (``n_rows + ceil(E / split)``
    and ``2 E / split + 1``), so nothing waits for the card."""
    n_rows: int
    rowptr: torch.Tensor
    piece_ptr: torch.Tensor
    piece_row: torch.Tensor
    split_base: torch.Tensor
    nbr: torch.Tensor
    rel: Optional[torch.Tensor]
    split: int
    max_pieces: int
    n_slots: int


def csr_plan(keys: torch.Tensor, nbr: torch.Tensor,
             rel: Optional[torch.Tensor], n_rows: int,
             split: int = FLASH_SPLIT_EDGES) -> FlashPlan:
    """The plan over edges sorted by ``keys`` (ascending; a key at or past
    ``n_rows`` marks an edge that is dropped, and such edges sort last)."""
    if split < 1:
        raise ValueError(f'flash plan: split must be >= 1, got {split}')
    dev = keys.device
    e = keys.shape[0]
    keys = keys.long()
    rowptr = torch.searchsorted(
        keys, torch.arange(n_rows + 1, device=dev, dtype=torch.int64))
    deg = rowptr[1:] - rowptr[:-1]
    npc = torch.div(deg + (split - 1), split,
                    rounding_mode='floor').clamp_(min=1)
    piece_ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(npc, 0, out=piece_ptr[1:])
    multi = torch.where(npc > 1, npc, 0)
    split_base = torch.cumsum(multi, 0) - multi
    max_pieces = n_rows + -(-e // split)
    piece_row = (torch.searchsorted(
        piece_ptr, torch.arange(max_pieces, device=dev, dtype=torch.int64),
        right=True) - 1).clamp_(0, max(n_rows - 1, 0)).to(torch.int32)
    return FlashPlan(n_rows, rowptr, piece_ptr, piece_row, split_base,
                     nbr.to(torch.int32).contiguous(),
                     None if rel is None else rel.to(torch.int32)
                     .contiguous(), split, max_pieces, 2 * e // split + 1)


def dst_plan(s: torch.Tensor, d: torch.Tensor, rel: Optional[torch.Tensor],
             num_dst: int, sorted_dst: bool,
             split: int = FLASH_SPLIT_EDGES) -> FlashPlan:
    """The destination-major plan of kernels (a) and (b): ``d`` sorted (a
    stable argsort unless ``sorted_dst``), the sources as neighbours."""
    if not sorted_dst:
        order = torch.argsort(d, stable=True)
        s, d = s[order], d[order]
        rel = None if rel is None else rel[order]
    return csr_plan(d, s, rel, num_dst, split)


def src_plan(s: torch.Tensor, d: torch.Tensor, rel: Optional[torch.Tensor],
             num_dst: int, n_src: int, src_sorted: bool = False,
             split: int = FLASH_SPLIT_EDGES) -> FlashPlan:
    """The source-major plan of kernel (c): the valid edges sorted by source
    (an invalid edge, ``d >= num_dst``, takes the key ``n_src`` and sorts
    last and drops), the destinations as neighbours. ``src_sorted``: the
    edges are so sorted already (a layout's source-sorted copy)."""
    key = torch.where(d < num_dst, s.long(), n_src)
    if not src_sorted:
        order = torch.argsort(key, stable=True)
        key, d = key[order], d[order]
        rel = None if rel is None else rel[order]
    return csr_plan(key, d, rel, n_src, split)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# the kernels: 'fwd' (a), 'dst' (b), 'src' (c)
KERNELS = ('fwd', 'dst', 'src')


class TeamShape(NamedTuple):
    """How a kernel lays a row over a warp. Each head is padded to ``slots``
    (a power of two) slots of ``vec`` columns (4: one 16-byte load a slot;
    1: a float); the warp owns one piece and ``heads`` heads and splits
    into ``32 // lanes`` sub-teams of ``lanes`` lanes, lane ``j`` holding
    the slots ``j, j + lanes, ...`` (``nv`` of them) of the warp's heads;
    the sub-teams take alternate batches of ``unroll`` edges, their states
    merged at the end; ``depth`` batches are in flight."""
    vec: int
    lanes: int
    heads: int
    slots: int
    nv: int
    unroll: int
    depth: int


def _batch(kernel: str, floats: int):
    """A kernel's batch (gathered row floats a lane) and batches in flight,
    by the floats of a row a lane holds, from the A/Bs on the card
    (PERF.md): kernel (a) 16 floats, kernels (b) and (c) 8; two batches in
    flight for kernels (a) and (b) where a lane holds 8 or more floats, one
    otherwise, and one for kernel (c). Within 3 % of the best of six (a)
    variants at paths K, L and M, and 8 % of the best (b) and (c) variant;
    larger batches spill. csrc/flash_softmax.cu's kFwdFloats, kBwdFloats
    and launch_batch hold the same rule, and the library only these
    instances."""
    depth = 2 if kernel != 'src' and floats >= 8 else 1
    return (16 if kernel == 'fwd' else 8), depth


def team_shape(h: int, c: int, vec: int, kernel: str) -> TeamShape:
    """Kernel ``kernel``'s shape for heads of ``c`` columns read ``vec`` at a
    time: a head wider than 32 slots takes a warp of its own; narrower ones
    share a warp, all ``h`` where a lane then holds at most 16 floats of a
    row, else the most that fit. ``unroll`` edges a batch so that a lane
    gathers :func:`_batch`'s floats of rows a batch, between 1 and 16
    edges."""
    if vec not in (1, 4) or (vec == 4 and c % 4) or kernel not in KERNELS:
        raise ValueError(f'flash team shape: vec {vec} (c = {c}), kernel '
                         f'{kernel!r}')
    slots = _pow2(-(-c // vec))

    def lay(ht):
        lanes = min(_pow2(ht * slots), 32)
        return lanes, _pow2(-(-ht * slots // lanes))

    heads = 1 if slots > 32 else next(
        ht for ht in range(h, 0, -1) if lay(ht)[1] * vec <= 16)
    lanes, nv = lay(heads)
    batch, depth = _batch(kernel, nv * vec)
    unroll = min(16, max(1, batch // (nv * vec)))
    return TeamShape(vec, lanes, heads, slots, nv, unroll, depth)


def bwd_blocks(plan: FlashPlan, h: int, shape: TeamShape) -> int:
    """Blocks of a launch over ``plan``: one warp per (piece, head
    group)."""
    groups = -(-h // shape.heads)
    return -(-plan.max_pieces * groups // (_THREADS // 32))


# -- the kernels ---------------------------------------------------------------
class _Args(ctypes.Structure):
    """``FlashArgs`` of ``csrc/flash_softmax.cu``, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        'rowptr', 'piece_ptr', 'piece_row', 'split_base', 'tickets', 'nbr',
        'rel', 'src_tab', 'dst_tab', 'val', 'extra', 'm', 'l', 'out', 'g',
        'rec', 'd_row', 'd_val', 'd_glob', 'part_s', 'part_s2', 'part_v',
        'part_v2')] + [(name, ctypes.c_longlong) for name in (
            'n_rows', 'max_pieces', 'n_slots', 'ld_src', 'ld_dst',
            'ld_val')] + [(name, ctypes.c_int) for name in (
                'form', 'h', 'c', 'g_lanes', 'split', 'n_rel', 'vec',
                'team_heads', 'qv', 'nv', 'unroll', 'depth')] + [
        ('slope', ctypes.c_float)]


def _kernel(symbol: str):
    from .. import csrc
    return csrc.function('flash_softmax', symbol,
                         [ctypes.c_void_p, ctypes.c_void_p])


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _row_stride(name: str, t: torch.Tensor, width: int) -> int:
    if t.dim() != 2 or t.shape[1] != width or t.stride(1) != 1 or (
            t.shape[0] > 1 and t.stride(0) < width):
        raise ValueError(f'flash kernels take {name} as [N, {width}] with '
                         f'each row contiguous, got shape {tuple(t.shape)} '
                         f'strides {t.stride()}')
    return t.stride(0) if t.shape[0] > 1 else width


def _check_card(ops: FlashOperands, *tensors):
    dev = ops.val.device
    if dev.type != 'cuda':
        raise ValueError(f'flash kernels run on cuda tensors, not {dev}')
    for t in (ops.src_tab, ops.dst_tab, ops.val, ops.extra) + tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f'flash kernels: a tensor is on {t.device}, '
                             f'the values on {dev}')
        if t.is_floating_point() and t.dtype != torch.float32:
            raise NotImplementedError(
                f'the flash kernels take float32 on the card, got '
                f'{t.dtype}; the bf16 arms are not written yet (ROADMAP: '
                f'Queue 1, item 7)')
    if ops.columns > MAX_HEAD_COLUMNS:
        raise ValueError(f'flash kernels take heads of at most '
                         f'{MAX_HEAD_COLUMNS} columns, got {ops.columns}')


def _args(ops: FlashOperands, plan: FlashPlan, shape: TeamShape,
          **ptrs) -> _Args:
    """The launch arguments of a kernel laid out as ``shape``."""
    h, c = ops.heads, ops.columns
    a = _Args()
    a.rowptr, a.piece_ptr, a.piece_row, a.split_base = (
        plan.rowptr.data_ptr(), plan.piece_ptr.data_ptr(),
        plan.piece_row.data_ptr(), plan.split_base.data_ptr())
    a.nbr, a.rel = plan.nbr.data_ptr(), _ptr(plan.rel)
    a.src_tab, a.dst_tab, a.val = (ops.src_tab.data_ptr(),
                                   ops.dst_tab.data_ptr(),
                                   ops.val.data_ptr())
    a.extra = _ptr(ops.extra)
    for k, v in ptrs.items():
        setattr(a, k, _ptr(v))
    sw = h if ops.form == 'gat' else h * c
    a.n_rows, a.max_pieces, a.n_slots = (plan.n_rows, plan.max_pieces,
                                         plan.n_slots)
    a.ld_src = _row_stride('src_tab', ops.src_tab, sw)
    a.ld_dst = _row_stride('dst_tab', ops.dst_tab, sw)
    a.ld_val = _row_stride('val', ops.val, h * c)
    a.form, a.h, a.c, a.split = FORMS.index(ops.form), h, c, plan.split
    a.g_lanes, a.vec, a.team_heads, a.qv = (shape.lanes, shape.vec,
                                            shape.heads, shape.slots)
    a.nv, a.unroll, a.depth = shape.nv, shape.unroll, shape.depth
    a.n_rel = ops.extra.shape[0] if ops.form == 'dot' else 0
    a.slope = float(ops.slope)
    return a


def _vec_ok(ops: FlashOperands, *rows: torch.Tensor) -> bool:
    """16-byte loads: ``c`` a multiple of 4, and every table a kernel reads
    or writes by rows 16-byte aligned with a stride of whole vectors
    (``rows``: the output, output-gradient rows)."""
    tabs = [ops.val, *rows]
    if ops.form != 'gat':
        tabs.append(ops.dst_tab)
    if ops.form == 'dot':
        tabs.append(ops.src_tab)
    if ops.form == 'gatv2':
        tabs.append(ops.extra)
    return ops.columns % 4 == 0 and all(
        t.data_ptr() % 16 == 0 and (t.dim() < 2 or t.shape[0] <= 1
                                    or t.stride(0) % 4 == 0) for t in tabs)


def kernel_shape(ops: FlashOperands, kernel: str,
                 *rows: torch.Tensor) -> TeamShape:
    """The team shape of kernel ``kernel`` ('fwd': (a), 'dst': (b), 'src':
    (c)): 16-byte loads where :func:`_vec_ok` allows them (``rows`` the
    row tables it reads or writes besides ``ops``'), heads laid out by
    :func:`team_shape`."""
    vec = 4 if _vec_ok(ops, *rows) else 1
    return team_shape(ops.heads, ops.columns, vec, kernel)


def _launch(symbol: str, args: _Args, dev: torch.device, what: str):
    fn = _kernel(symbol)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f'flash {what} kernel launch failed: CUDA error '
                           f'{err}')


def _scratch(plan: FlashPlan, h: int, width: int, like: torch.Tensor,
             vectors: int):
    """Merge slots of the multi-piece rows: per-head scalars, ``vectors``
    ``[slots, width]`` arrays, and zeroed tickets."""
    n = plan.n_slots
    kw = dict(dtype=torch.float32, device=like.device)
    parts = [torch.empty((n, h), **kw), torch.empty((n, h), **kw)] + [
        torch.empty((n, width), **kw) for _ in range(vectors)]
    tickets = torch.zeros(n * h, dtype=torch.int32, device=like.device)
    return parts, tickets


def flash_forward(ops: FlashOperands, s: torch.Tensor, d: torch.Tensor,
                  rel: Optional[torch.Tensor], num_dst: int, chunk: int,
                  plan: Optional[FlashPlan] = None):
    """``(out [num_dst, H C], m, l [num_dst, H])`` of the segment softmax
    over the edges ``(s, d, rel)`` (``d >= num_dst`` drops an edge; ``s``
    in range). A CPU tensor runs :func:`flash_forward_plain` over chunks of
    ``chunk`` edges; a CUDA tensor launches kernel (a) over ``plan`` (a
    :func:`dst_plan` of the same edges) or raises. Each launch counts in
    ``flash_forward.launches``."""
    if ops.val.device.type == 'cpu':
        return flash_forward_plain(ops, s, d, rel, num_dst, chunk)
    if ops.val.device.type != 'cuda':
        raise ValueError(f'flash_forward runs on cpu or cuda, not '
                         f'{ops.val.device}')
    _check_card(ops)
    if plan is None:
        raise ValueError('flash_forward on the card needs its dst_plan')
    h, c = ops.heads, ops.columns
    kw = dict(dtype=torch.float32, device=ops.val.device)
    out = torch.empty((num_dst, h * c), **kw)
    m = torch.empty((num_dst, h), **kw)
    l = torch.empty((num_dst, h), **kw)
    if num_dst == 0:
        return out, m, l
    (ps, ps2, pv), tickets = _scratch(plan, h, h * c, out, 1)
    args = _args(ops, plan, kernel_shape(ops, 'fwd', out), m=m, l=l,
                 out=out, tickets=tickets, part_s=ps, part_s2=ps2, part_v=pv)
    _launch('pgt_flash_fwd', args, ops.val.device, 'forward')
    flash_forward.launches += 1
    return out, m, l


def flash_backward_dst(ops: FlashOperands, m: torch.Tensor, l: torch.Tensor,
                       out: torch.Tensor, g: torch.Tensor, plan: FlashPlan):
    """Kernel (b), the backward's destination pass over ``plan`` (the
    :func:`dst_plan` of the forward): ``(rec [num_dst, H, 4], d_dst_tab,
    d_extra)``, ``rec`` each row and head's ``(m, l, gdot = <g, out>,
    a_dst)`` (``a_dst`` 0 but for GAT), which kernel (c) reads, and
    ``d_extra`` the blocks' partials of GATv2's ``att`` or the dot form's
    prior summed in block order (None for GAT). CUDA tensors only; counts
    in ``flash_backward.launches_dst``."""
    num_dst = out.shape[0]
    g = g.reshape(num_dst, -1).contiguous()
    _check_card(ops, m, l, out, g)
    h, c = ops.heads, ops.columns
    shape = kernel_shape(ops, 'dst', g, out)
    kw = dict(dtype=torch.float32, device=ops.val.device)
    rec = torch.empty((num_dst, h, 4), **kw)
    d_dst = torch.empty((num_dst, ops.dst_tab.shape[1]), **kw)
    if ops.form == 'gat':
        glob = None
    else:
        width = h * c if ops.form == 'gatv2' else ops.extra.numel()
        glob = torch.empty((bwd_blocks(plan, h, shape), width), **kw)
    (ps, ps2, pv), tickets = _scratch(plan, h, h * c, out, 1)
    args = _args(ops, plan, shape, m=m, l=l, out=out, g=g, rec=rec,
                 d_row=d_dst, d_glob=glob, tickets=tickets, part_s=ps,
                 part_s2=ps2, part_v=pv)
    _launch('pgt_flash_bwd_dst', args, ops.val.device, 'backward (dst)')
    flash_backward.launches_dst += 1
    d_extra = None if glob is None else glob.sum(0).view_as(ops.extra)
    return rec, d_dst, d_extra


def flash_backward_src(ops: FlashOperands, g: torch.Tensor, rec: torch.Tensor,
                       plan_t: FlashPlan):
    """Kernel (c), the backward's source pass over ``plan_t`` (a
    :func:`src_plan`), reading the records ``rec`` of kernel (b):
    ``(d_src_tab, d_val)`` (``d_val`` None for GATv2, whose value gradient
    is in ``d_src_tab``). CUDA tensors only; counts in
    ``flash_backward.launches_src``."""
    num_dst = rec.shape[0]
    g = g.reshape(num_dst, -1).contiguous()
    _check_card(ops, g, rec)
    h, c = ops.heads, ops.columns
    shape = kernel_shape(ops, 'src', g)
    kw = dict(dtype=torch.float32, device=ops.val.device)
    n_src = ops.src_tab.shape[0]
    d_src = torch.empty((n_src, ops.src_tab.shape[1]), **kw)
    d_val = (torch.empty((n_src, h * c), **kw) if ops.form != 'gatv2'
             else None)
    (ps, ps2, pv, pv2), tickets = _scratch(plan_t, h, h * c, g, 2)
    args = _args(ops, plan_t, shape, g=g, rec=rec, d_row=d_src, d_val=d_val,
                 tickets=tickets, part_s=ps, part_s2=ps2, part_v=pv,
                 part_v2=pv2)
    _launch('pgt_flash_bwd_src', args, ops.val.device, 'backward (src)')
    flash_backward.launches_src += 1
    return d_src, d_val


def flash_backward(ops: FlashOperands, s: torch.Tensor, d: torch.Tensor,
                   rel: Optional[torch.Tensor], num_dst: int, chunk: int,
                   m: torch.Tensor, l: torch.Tensor, out: torch.Tensor,
                   g: torch.Tensor, plan: Optional[FlashPlan] = None,
                   plan_t: Optional[FlashPlan] = None):
    """The gradients ``(d_src_tab, d_dst_tab, d_val, d_extra)`` of
    :func:`flash_forward` for the output gradient ``g`` (see
    :func:`flash_backward_plain`). A CPU tensor runs the plain version over
    the edges ``(s, d, rel)``; a CUDA tensor launches kernel (b) over
    ``plan`` (:func:`flash_backward_dst`), then kernel (c) over ``plan_t``
    (:func:`flash_backward_src`), or raises."""
    if ops.val.device.type == 'cpu':
        return flash_backward_plain(ops, s, d, rel, num_dst, chunk, m, l,
                                    out, g)
    if ops.val.device.type != 'cuda':
        raise ValueError(f'flash_backward runs on cpu or cuda, not '
                         f'{ops.val.device}')
    if plan is None or plan_t is None:
        raise ValueError('flash_backward on the card needs both plans')
    if num_dst == 0 or ops.src_tab.shape[0] == 0:
        # no edge can be valid: every gradient is zero
        return (torch.zeros_like(ops.src_tab), torch.zeros_like(ops.dst_tab),
                None if ops.form == 'gatv2' else torch.zeros_like(ops.val),
                None if ops.extra is None else torch.zeros_like(ops.extra))
    rec, d_dst, d_extra = flash_backward_dst(ops, m, l, out, g, plan)
    d_src, d_val = flash_backward_src(ops, g, rec, plan_t)
    return d_src, d_dst, d_val, d_extra


register_launch_counter('flash_fwd', flash_forward)
register_launch_counter('flash_bwd_dst', flash_backward, 'launches_dst')
register_launch_counter('flash_bwd_src', flash_backward, 'launches_src')
