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


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f'{what} is not ported to the PyTorch package yet (ROADMAP: {item})')


class EdgeIndex:
    """``[2, E]`` edge index with a static sparse size and optional cached
    CSR/CSC orientations, on one device.

    ``device=None`` means the CUDA card (and raises when there is none); a
    tensor ``coo`` brings its own device unless ``device`` is given."""

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
                                             torch.Tensor]] = None):
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
                f"bsr={'cached' if self.bsr is not None else None})")

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

        The windowed and auto caches are not ported yet and raise."""
        if windowed:
            _not_ported('fill_cache(windowed=True)',
                        'Queue 1, item 3: the windowed regime')
        if auto:
            _not_ported('fill_cache(auto=True)',
                        'Queue 1, item 3: the regime policy')
        if cache_dtype not in (None, torch.float32, torch.bfloat16,
                               torch.int8):
            raise ValueError(f'fill_cache: cache_dtype {cache_dtype} is not '
                             'one of float32, bfloat16, int8')
        weight = self.weight
        dense, scale = self.dense_adj, self.dense_scale
        bsr = dict(bsr=self.bsr, bsr_t=self.bsr_t, bsr_res=self.bsr_res,
                   bsr_perm=self.bsr_perm, bsr_inv=self.bsr_inv)
        if dense_weight is not None and dense is None and self.bsr is None:
            ns, nd = self.sparse_size
            if ns * nd <= dense_cap() and not block_sparse:
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
            weight = (None if dense is not None or bsr['bsr'] is not None
                      else torch.as_tensor(dense_weight, device=self.device))
        csr, csc = self.get_csr(), self.get_csc()
        blk, blk_t = self.blocked, self.blocked_t
        if blocked and blk is None:
            blk, blk_t = _link_slots(csc, csr, self.num_edges)
        return EdgeIndex(self.coo, self.sparse_size, csr=csr, csc=csc,
                         num_real_edges=self.num_real_edges, weight=weight,
                         device=self.device, blocked=blk, blocked_t=blk_t,
                         dense_adj=dense, dense_scale=scale, **bsr)

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
        """Transpose: swap src/dst, swap cached orientations, slot orders
        and block layouts, and flip the residual. A relabel is square, so
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
                                     else self.dense_scale[::-1]))
        if dense is not None and dense.dtype == torch.int8:
            out._dense_t = self.dense_adj
        return out

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
