"""EdgeIndex: the sparse-graph container.

Counterpart of ``pytorch_geometric_tpu/edge_index.py:126-550``. It keeps the
JAX package's layout conventions:

  * ``coo``: int ``[2, E]``; row 0 = source, row 1 = destination.
  * CSR = sorted by row (source): ``get_csr`` -> (indptr, col, perm).
  * CSC = sorted by col (destination): ``get_csc`` -> (indptr, row, perm).

Padded edges point both endpoints at ``num_nodes`` (one past the last real
row); they sort past ``indptr[-1]`` and every segment op drops them.

In the port ``indptr`` and ``indices`` are int32 (what the CUDA kernel
reads) and ``perm`` is int64 (what torch indexing takes).

``fill_cache(blocked=True)`` also builds ``blocked`` / ``blocked_t``, the
port's counterparts of the JAX package's ``BlockedCSC`` pair, which the
fused attention aggregation (``ops/gat_fused.py``) runs over. The TPU pads
every 128-node destination block to 1024-edge chunks for its MXU kernel;
the Hopper kernels read plain CSC, so a :class:`Slots` is the CSC (and
``blocked_t`` the CSR) in slot order, with the maps between slots and
edges that the JAX layout carries (``perm``, ``inv_pos``, ``t_pos``).

``fill_cache(windowed=True)`` (or ``auto=True`` on a graph past
``PGT_AUTO_WIN_MIN_EDGES``) also builds ``win`` / ``win_t``, the
:class:`WindowedCSC` pair of the windowed SpMM regime (``ops/spmm.py``):
the destination-sorted edges cut into fixed chunks. Its flattened slots are
the CSC's own order plus trailing pads, so the CSC built beside it is a view
of the layout's ``src`` and ``perm`` (the CSR of ``win_t``'s), and the
layout adds only its per-slot rows ``dst`` and ``inv_pos``.

``fill_cache(auto=True)`` is the one-knob policy of the JAX package
(``edge_index.py:285-316``), with the card's constants (``ops/spmm.py``).

``fill_cache(dense_weight=..., block_sparse=..., cache_dtype=...)`` bakes
the weighted adjacency, in the JAX package's order: a dense ``dense_adj``
``[n_dst, n_src]`` (float32, bfloat16, or int8 with the two-sided scales
``dense_scale``, ``ops/dense_spmm.py``) while ``n_src * n_dst`` is within the
cap, else a block-sparse cache (``ops/bsr_spmm.py``): the forward and
transposed block layouts ``bsr`` / ``bsr_t`` (float32 or bfloat16 blocks),
the residual edges ``bsr_res`` (an EdgeIndex of its own, in original ids,
with its weights carried) and, when a hubs-first relabel was baked in,
``bsr_perm`` / ``bsr_inv`` (``perm[new] = old``). Weights that neither
cache takes are carried as ``weight``.
"""

import os
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from . import compat
from .backend import resolve_device

# fill_cache bakes a dense [nd, ns] adjacency up to this many entries, read
# from PGT_DENSE_SPMM_ENTRIES at call time as in the JAX package
# (edge_index.py:372); past it, it considers blocks.
DENSE_MAX_ENTRIES = 250_000_000


def dense_cap() -> int:
    """The dense cache's entry cap: ``PGT_DENSE_SPMM_ENTRIES`` when set."""
    return int(float(os.environ.get('PGT_DENSE_SPMM_ENTRIES',
                                    DENSE_MAX_ENTRIES)))


class CSR(NamedTuple):
    """One sorted orientation: indptr [N+1], indices [E], perm [E]
    (perm maps sorted-edge position -> original COO position)."""
    indptr: torch.Tensor
    indices: torch.Tensor
    perm: torch.Tensor


class Slots(NamedTuple):
    """One orientation in slot order, the port's ``BlockedCSC``.

    Slot ``k`` is position ``k`` of the sorted orientation (the CSC for
    ``blocked``, the CSR for ``blocked_t``), so every edge has a slot;
    slots at or past ``indptr[-1]`` hold the padded edges and are no
    row's, which ``dst`` marks.

    indptr:  [N+1] int32, the orientation's row pointer
    src:     [E] int32, the other endpoint of each slot's edge
    dst:     [E] int64, each slot's row (``N`` for a padded slot)
    perm:    [E] int64, slot -> original edge (the orientation's ``perm``)
    inv_pos: [E] int64, original edge -> slot (the inverse of ``perm``)
    t_pos:   [E] int64, slot -> the slot of the same edge in the other
             orientation
    """
    indptr: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    perm: torch.Tensor
    inv_pos: torch.Tensor
    t_pos: torch.Tensor


class WindowedCSC(NamedTuple):
    """The destination-sorted edge list cut into fixed ``C``-edge chunks,
    the layout of the windowed SpMM regime (the JAX package's
    ``WindowedCSC``, ``edge_index.py:65-85``).

    src:     [n_chunks, C] int32, source node per slot (``n_src`` for pads)
    dst:     [n_chunks, C] int32, destination per slot, non-decreasing over
             the flattened layout (``n_dst`` for pads and out-of-range
             edges)
    perm:    [n_chunks, C] int64, original COO edge per slot (``E`` for
             pads)
    inv_pos: [E] int64, original edge -> flat slot ``chunk * C + slot``
    """
    src: torch.Tensor
    dst: torch.Tensor
    perm: torch.Tensor
    inv_pos: torch.Tensor


def build_windowed_csc(coo: torch.Tensor, num_dst: int, num_src: int,
                       chunk_edges: Optional[int] = None,
                       order: Optional[torch.Tensor] = None) -> WindowedCSC:
    """Sort by destination (stably, on ``coo``'s device), clamp
    out-of-range destinations to the drop sentinel ``num_dst``, pad to a
    chunk multiple and reshape: the JAX package's host build
    (``edge_index.py:88-122``) value for value. ``chunk_edges`` defaults to
    ``PGT_WIN_EDGES`` (2**21). ``order`` reuses a stable argsort of
    ``coo[1]`` (``fill_cache`` shares the CSC's)."""
    e = int(coo.shape[1])
    if chunk_edges is None:
        chunk_edges = int(float(os.environ.get('PGT_WIN_EDGES', 1 << 21)))
    c = max(min(int(chunk_edges), max(e, 1)), 1)
    if order is None:
        order = torch.sort(coo[1], stable=True).indices
    order = order.long()
    dst_s = coo[1][order].long().clamp(max=num_dst)
    n_chunks = max(-(-e // c), 1)
    size = n_chunks * c
    dev = coo.device
    src_w = torch.full((size,), num_src, dtype=torch.int32, device=dev)
    src_w[:e] = coo[0][order]
    dst_w = torch.full((size,), num_dst, dtype=torch.int32, device=dev)
    dst_w[:e] = dst_s
    perm_w = torch.full((size,), e, dtype=torch.int64, device=dev)
    perm_w[:e] = order
    inv = torch.empty(e, dtype=torch.int64, device=dev)
    inv[order] = torch.arange(e, device=dev)
    return WindowedCSC(src=src_w.view(n_chunks, c),
                       dst=dst_w.view(n_chunks, c),
                       perm=perm_w.view(n_chunks, c), inv_pos=inv)


def _on_layout(o: 'CSR', win: WindowedCSC, e: int) -> 'CSR':
    """The orientation ``o`` with its indices and perm as views of the
    windowed layout built from its own order (the same values): the two
    share their memory."""
    return CSR(indptr=o.indptr, indices=win.src.view(-1)[:e],
               perm=win.perm.view(-1)[:e])


def auto_win_min_edges() -> float:
    """``fill_cache(auto=True)`` builds the windowed layouts from this many
    edges (``PGT_AUTO_WIN_MIN_EDGES``; the port's default in
    ``ops/spmm.py``, infinite: never unasked)."""
    from .ops.spmm import AUTO_WIN_MIN_EDGES
    return float(os.environ.get('PGT_AUTO_WIN_MIN_EDGES',
                                AUTO_WIN_MIN_EDGES))


def auto_blocked_max_edges() -> int:
    """``fill_cache(auto=True)`` skips the slot orders past this many edges
    (``PGT_AUTO_BLOCKED_MAX_EDGES``; the port's default in
    ``ops/spmm.py``)."""
    from .ops.spmm import AUTO_BLOCKED_MAX_EDGES
    return int(float(os.environ.get('PGT_AUTO_BLOCKED_MAX_EDGES',
                                    AUTO_BLOCKED_MAX_EDGES)))


class EdgeIndex:
    """``[2, E]`` edge index with a static sparse size and optional cached
    CSR/CSC orientations, on one device.

    ``device=None`` means the CUDA card (and raises when there is none); a
    tensor ``coo`` brings its own device unless ``device`` is given. Without
    ``sparse_size`` the size is read from the COO's largest id, a wait for
    the card that raises while a CUDA graph captures (``compat.compile``)."""

    def __init__(self, coo, sparse_size: Optional[Tuple[int, int]] = None,
                 csr: Optional[CSR] = None, csc: Optional[CSR] = None,
                 num_real_edges: Optional[int] = None,
                 weight: Optional[torch.Tensor] = None,
                 device: Union[None, str, torch.device] = None,
                 bsr=None, bsr_t=None,
                 bsr_res: Optional['EdgeIndex'] = None,
                 bsr_perm: Optional[torch.Tensor] = None,
                 bsr_inv: Optional[torch.Tensor] = None,
                 blocked: Optional[Slots] = None,
                 blocked_t: Optional[Slots] = None,
                 dense_adj: Optional[torch.Tensor] = None,
                 dense_scale: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                 win: Optional[WindowedCSC] = None,
                 win_t: Optional[WindowedCSC] = None):
        if device is None and isinstance(coo, torch.Tensor):
            device = coo.device
        self.device = resolve_device(device)
        if isinstance(coo, np.ndarray):
            coo = np.ascontiguousarray(coo)
        coo = torch.as_tensor(coo, device=self.device)
        if coo.dim() != 2 or coo.shape[0] != 2:
            raise ValueError(f'EdgeIndex expects shape [2, E], got '
                             f'{tuple(coo.shape)}')
        if coo.dtype not in (torch.int32, torch.int64):
            coo = coo.to(torch.int32)
        self.coo = coo
        if sparse_size is None:
            if compat.is_compiling():
                raise RuntimeError(
                    'EdgeIndex: no sparse_size was given, and reading the '
                    'largest node id from the COO waits for the card, which a '
                    'CUDA graph capture forbids; pass sparse_size=(num_src, '
                    'num_dst)')
            n = int(coo.max()) + 1 if coo.numel() else 0
            sparse_size = (n, n)
        self.sparse_size = tuple(int(s) for s in sparse_size)
        self.csr = csr
        self.csc = csc
        self.num_real_edges = (int(coo.shape[1]) if num_real_edges is None
                               else int(num_real_edges))
        # per-edge weights (COO order) carried by fill_cache(dense_weight=)
        # and applied by spmm when the caller passes none
        self.weight = weight
        # the block-sparse cache (ops/bsr_spmm.py), weights baked in
        self.bsr, self.bsr_t, self.bsr_res = bsr, bsr_t, bsr_res
        self.bsr_perm, self.bsr_inv = bsr_perm, bsr_inv
        # the slot orders of the fused attention aggregation
        self.blocked, self.blocked_t = blocked, blocked_t
        # the dense cache (ops/dense_spmm.py), weights baked in: [nd, ns];
        # int8 with its scales (r [nd], c [ns]), A ~= diag(r) Q diag(c)
        self.dense_adj, self.dense_scale = dense_adj, dense_scale
        # an int8 cache's transpose, materialised at the first flip: the
        # card's int8 matmul takes a row-major left operand
        self._dense_t: Optional[torch.Tensor] = None
        # the windowed layouts (forward / transpose) of the windowed regime
        self.win, self.win_t = win, win_t

    # -- basic accessors ----------------------------------------------------
    @property
    def row(self) -> torch.Tensor:
        return self.coo[0]

    @property
    def col(self) -> torch.Tensor:
        return self.coo[1]

    @property
    def num_edges(self) -> int:
        return int(self.coo.shape[1])

    @property
    def num_src_nodes(self) -> int:
        return self.sparse_size[0]

    @property
    def num_dst_nodes(self) -> int:
        return self.sparse_size[1]

    def __getitem__(self, i):
        return self.coo[i]

    def __repr__(self):
        dense = None if self.dense_adj is None else self.dense_adj.dtype
        return (f'EdgeIndex(E={self.num_edges}, '
                f'sparse_size={self.sparse_size}, device={self.device}, '
                f"csr={'cached' if self.csr is not None else None}, "
                f"csc={'cached' if self.csc is not None else None}, "
                f'dense={dense}, '
                f"bsr={'cached' if self.bsr is not None else None}, "
                f"win={'cached' if self.win is not None else None})")

    # -- cached orientations ------------------------------------------------
    def get_csr(self) -> CSR:
        if self.csr is not None:
            return self.csr
        return _build_sorted(self.row, self.col, self.num_src_nodes)

    def get_csc(self) -> CSR:
        if self.csc is not None:
            return self.csc
        return _build_sorted(self.col, self.row, self.num_dst_nodes)

    def fill_cache(self, blocked: bool = True, dense_weight=None,
                   block_sparse: Optional[bool] = None, cache_dtype=None,
                   auto: bool = False,
                   windowed: Optional[bool] = None) -> 'EdgeIndex':
        """Return a copy with both CSR and CSC materialised, the slot
        orders ``blocked`` / ``blocked_t`` built when ``blocked``, and
        ``dense_weight`` ([E] per-edge weights, COO order) baked or
        carried. The parameters come in the JAX package's order.

        The decision is the JAX package's (``edge_index.py:364-470``):

          * ``n_src * n_dst`` within :func:`dense_cap` and not
            ``block_sparse``: a dense adjacency ``dense_adj``, stored as
            ``cache_dtype`` (``None`` or ``torch.float32``,
            ``torch.bfloat16``, or ``torch.int8`` with ``dense_scale``; the
            int8 cache serves inference only);
          * else, unless ``block_sparse=False``: the block-sparse cache when
            forced (``block_sparse=True``) or when the blocks pay
            (``bsr_profitable``), its blocks ``torch.bfloat16`` when
            ``cache_dtype`` says so (float32 otherwise);
          * weights that no cache took are carried as ``weight`` for the
            sparse path. New weights replace carried ones either way: a
            baked cache drops them (the block cache's residual keeps its
            own weights), else ``dense_weight`` is carried in their place.

        ``auto=True`` is the one-knob policy (JAX ``edge_index.py:285-316``):
        on the card it bakes unit weights when none are given (the carried
        ones when the EdgeIndex carries some), caps the dense cache at
        ``ops.spmm.auto_dense_cap`` entries, stores it as
        ``ops.spmm.AUTO_CACHE_DTYPE`` unless ``cache_dtype`` says otherwise,
        bakes no block cache unless ``block_sparse=True`` asks for one (the
        sweep's row 'path A clustered', on the graph the block cache was
        built for: 'bsr' 1.2153 ms against 'kernel' 0.1776), and skips the
        slot orders past ``PGT_AUTO_BLOCKED_MAX_EDGES`` edges;
        on CPU tensors it bakes nothing and carries ``dense_weight``, as the
        JAX package does on its CPU backend (``PGT_FORCE_DENSE_SPMM`` lifts
        that, as there). Auto's unit weights are never carried.

        ``windowed``: build the :class:`WindowedCSC` pair ``win`` /
        ``win_t`` (True), or not (False); ``None`` builds it under ``auto``
        when nothing was baked and the graph has at least
        ``PGT_AUTO_WIN_MIN_EDGES`` edges. The CSC and CSR then become views
        of the layouts (:func:`_on_layout`)."""
        if cache_dtype not in (None, torch.float32, torch.bfloat16,
                               torch.int8):
            raise ValueError(f'fill_cache: cache_dtype {cache_dtype} is not '
                             'one of float32, bfloat16, int8')
        weight = self.weight
        auto_unit = False
        cap = dense_cap()
        if auto:
            from .ops.spmm import AUTO_CACHE_DTYPE, auto_dense_cap
            on_cpu = (self.device.type == 'cpu'
                      and not os.environ.get('PGT_FORCE_DENSE_SPMM'))
            if on_cpu:
                # no baked cache pays on the CPU: carry the weights, so the
                # sparse regimes compute the same function
                if dense_weight is not None:
                    weight = torch.as_tensor(dense_weight,
                                             device=self.device)
                dense_weight = None
            elif dense_weight is None:
                # the JAX package bakes unit weights and keeps carrying its
                # own, which spmm then applies instead of the cache; the
                # port drops carried weights when it bakes, so it bakes them
                if weight is None:
                    dense_weight = torch.ones(self.num_edges,
                                              dtype=torch.float32,
                                              device=self.device)
                    auto_unit = True
                else:
                    dense_weight = weight
            if self.device.type != 'cpu':
                if cache_dtype is None:
                    cache_dtype = AUTO_CACHE_DTYPE
                if block_sparse is None:
                    block_sparse = False
            cap = auto_dense_cap((cache_dtype or torch.float32).itemsize,
                                 self.device)
            blocked = blocked and self.num_edges <= auto_blocked_max_edges()
        dense, scale = self.dense_adj, self.dense_scale
        bsr = dict(bsr=self.bsr, bsr_t=self.bsr_t, bsr_res=self.bsr_res,
                   bsr_perm=self.bsr_perm, bsr_inv=self.bsr_inv)
        if dense_weight is not None and dense is None and self.bsr is None:
            ns, nd = self.sparse_size
            if ns * nd <= cap and not block_sparse:
                from .ops.dense_spmm import build_dense_cache
                dense, scale = build_dense_cache(
                    self.coo, torch.as_tensor(dense_weight,
                                              device=self.device),
                    ns, nd, cache_dtype)
            elif block_sparse is not False:
                baked = self._bake_bsr(dense_weight, bool(block_sparse),
                                       cache_dtype == torch.bfloat16)
                if baked is not None:
                    bsr = baked
            if dense is not None or bsr['bsr'] is not None:
                weight = None
            elif not auto_unit:
                weight = torch.as_tensor(dense_weight, device=self.device)
        csr, csc = self.get_csr(), self.get_csc()
        win, win_t = self.win, self.win_t
        if windowed is None:
            windowed = (auto and dense is None and bsr['bsr'] is None
                        and self.num_edges >= auto_win_min_edges())
        if windowed and win is None:
            e = self.num_edges
            ns, nd = self.sparse_size
            win = build_windowed_csc(self.coo, nd, ns, order=csc.perm)
            win_t = build_windowed_csc(self.coo.flip(0), ns, nd,
                                       order=csr.perm)
            csc, csr = _on_layout(csc, win, e), _on_layout(csr, win_t, e)
        blk, blk_t = self.blocked, self.blocked_t
        if blocked and blk is None:
            blk, blk_t = _link_slots(csc, csr, self.num_edges)
        return EdgeIndex(self.coo, self.sparse_size, csr=csr, csc=csc,
                         num_real_edges=self.num_real_edges, weight=weight,
                         device=self.device, blocked=blk, blocked_t=blk_t,
                         dense_adj=dense, dense_scale=scale, win=win,
                         win_t=win_t, **bsr)

    def _bake_bsr(self, dense_weight, force: bool, bf16: bool):
        """The block-sparse cache of ``dense_weight`` (a dict of the
        ``bsr*`` fields), its blocks bfloat16 when ``bf16``, or ``None``
        when it is not forced and does not pay."""
        from .ops.bsr_spmm import (bsr_profitable, build_bsr_pair,
                                   choose_block_order)
        ns, nd = self.sparse_size
        coo = self.coo.cpu().numpy()
        if isinstance(dense_weight, torch.Tensor):
            dense_weight = dense_weight.detach().cpu()
        w = np.asarray(dense_weight)
        # a hubs-first relabel where it concentrates the edges into fewer
        # blocks; spmm un-permutes, so callers never see it
        perm, inv, cap, in_blk = choose_block_order(coo, ns, nd)
        if perm is not None:
            # padded endpoints (the == ns sentinel) pass through
            coo = np.concatenate([inv, [ns]])[np.minimum(
                coo.astype(np.int64), ns)]
        if not force and not bsr_profitable(coo, ns, nd, capture=cap,
                                            in_blk=in_blk):
            return None
        fwd, bwd, res = build_bsr_pair(coo, w, ns, nd, device=self.device,
                                       in_blk=in_blk)
        if bf16:
            # the blocks are summed and stored float32 first, then rounded:
            # the JAX package's double rounding (edge_index.py:444-451)
            fwd = fwd._replace(vals=fwd.vals.to(torch.bfloat16))
            bwd = bwd._replace(vals=bwd.vals.to(torch.bfloat16))
        out = dict(bsr=fwd, bsr_t=bwd, bsr_res=None, bsr_perm=None,
                   bsr_inv=None)
        if res is not None:
            r_src, r_dst, r_w = res
            if perm is not None:
                # residual back to the original ids: x and out are not
                # permuted on the gather path
                r_src, r_dst = perm[r_src], perm[r_dst]
            # its weights carried, for the segment-sum kernel
            out['bsr_res'] = EdgeIndex(
                np.stack([r_src, r_dst]).astype(np.int32), (ns, nd),
                device=self.device,
                weight=torch.as_tensor(r_w, device=self.device)).fill_cache(
                    blocked=False)
        if perm is not None:
            out['bsr_perm'] = torch.as_tensor(perm, device=self.device)
            out['bsr_inv'] = torch.as_tensor(inv, device=self.device)
        return out

    def flip(self) -> 'EdgeIndex':
        """Transpose: swap src/dst, swap cached orientations, slot orders,
        windowed layouts and block layouts, and flip the residual. A relabel is square, so
        ``A^T`` keeps the same ``bsr_perm``. The dense cache becomes its
        transpose (a view, or for int8 the copy kept at the first flip),
        and ``A = diag(r) Q diag(c)`` gives ``A^T = diag(c) Q^T diag(r)``:
        the scale pair swaps."""
        dense = self.dense_adj
        if dense is not None:
            if dense.dtype == torch.int8:
                if self._dense_t is None:
                    self._dense_t = dense.t().contiguous()
                dense = self._dense_t
            else:
                dense = dense.t()
        out = EdgeIndex(self.coo.flip(0),
                        (self.sparse_size[1], self.sparse_size[0]),
                        csr=self.csc, csc=self.csr,
                        num_real_edges=self.num_real_edges,
                        weight=self.weight, device=self.device,
                        bsr=self.bsr_t, bsr_t=self.bsr,
                        bsr_res=(None if self.bsr_res is None
                                 else self.bsr_res.flip()),
                        bsr_perm=self.bsr_perm, bsr_inv=self.bsr_inv,
                        blocked=self.blocked_t, blocked_t=self.blocked,
                        dense_adj=dense,
                        dense_scale=(None if self.dense_scale is None
                                     else self.dense_scale[::-1]),
                        win=self.win_t, win_t=self.win)
        if dense is not None and dense.dtype == torch.int8:
            out._dense_t = self.dense_adj
        return out

    def sort_by(self, order: str = 'row') -> Tuple['EdgeIndex', torch.Tensor]:
        """The edges sorted stably by ``'row'`` (source) or ``'col'``
        (destination), as a new EdgeIndex with no caches, and the sort's
        ``perm`` (JAX ``edge_index.py:497-504``)."""
        key = self.row if order == 'row' else self.col
        perm = torch.sort(key, stable=True).indices
        return EdgeIndex(self.coo[:, perm], self.sparse_size,
                         num_real_edges=self.num_real_edges,
                         device=self.device), perm

    def to_dense_adj(self, edge_weight: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """The dense ``[n_src, n_dst]`` adjacency, ``adj[s, d]`` the sum of
        the weights (ones by default) over the edges ``s -> d``; edges with
        an endpoint past its size are dropped (JAX ``edge_index.py:
        532-541``)."""
        n_src, n_dst = self.sparse_size
        w = (torch.ones(self.num_edges, dtype=torch.float32,
                        device=self.device)
             if edge_weight is None else edge_weight)
        r = self.row.long().clamp(max=n_src)
        c = self.col.long().clamp(max=n_dst)
        adj = w.new_zeros((n_src + 1, n_dst + 1))
        adj.index_put_((r, c), w, accumulate=True)
        return adj[:n_src, :n_dst]

    # -- SpMM ---------------------------------------------------------------
    def matmul(self, x: torch.Tensor,
               edge_weight: Optional[torch.Tensor] = None,
               reduce: str = 'sum', transpose: bool = False) -> torch.Tensor:
        """out[dst] = reduce_{(src,dst) in E} w * x[src]; see ``ops.spmm``."""
        from .ops.spmm import spmm
        return spmm(self, x, edge_weight, reduce=reduce, transpose=transpose)


def _build_sorted(key: torch.Tensor, other: torch.Tensor, n: int) -> CSR:
    perm = torch.argsort(key, stable=True)
    pos = torch.arange(n + 1, dtype=key.dtype, device=key.device)
    indptr = torch.searchsorted(key[perm].contiguous(), pos)
    return CSR(indptr=indptr.to(torch.int32),
               indices=other[perm].to(torch.int32).contiguous(),
               perm=perm)


def from_numpy_coo(row: np.ndarray, col: np.ndarray, num_nodes: int,
                   device: Union[None, str, torch.device] = None
                   ) -> EdgeIndex:
    """A square EdgeIndex of ``num_nodes`` from numpy endpoint arrays, int32
    (JAX ``edge_index.py:651-654``), on ``device`` (the card by default)."""
    return EdgeIndex(np.stack([row, col]).astype(np.int32),
                     (num_nodes, num_nodes), device=device)


def _link_slots(csc: CSR, csr: CSR, e: int) -> Tuple[Slots, Slots]:
    """The two slot orders of one edge set, each knowing where its edges
    sit in the other (``_link_blocked_pair`` of the JAX package, built on
    the edge index's device)."""
    from .ops.segment import ptr2index
    pos = torch.arange(e, device=csc.perm.device)

    def inverse(perm):
        return torch.empty_like(perm).index_copy_(0, perm, pos)

    inv_c, inv_r = inverse(csc.perm), inverse(csr.perm)

    def one(o: CSR, inv, inv_other) -> Slots:
        return Slots(indptr=o.indptr, src=o.indices,
                     dst=ptr2index(o.indptr.long(), e), perm=o.perm,
                     inv_pos=inv, t_pos=inv_other[o.perm])

    return one(csc, inv_c, inv_r), one(csr, inv_r, inv_c)
