"""Typed (grouped) matrix multiply: the ``pyg_lib.ops.segment_matmul`` /
``grouped_matmul`` role (reference ``nn/dense/linear.py:301`` uses it inside
HeteroLinear, ``rgcn_conv.py:224`` for typed message transforms).

Counterpart of ``pytorch_geometric_tpu/ops/grouped.py``, whose three arms are
plain GEMMs that the JAX package leaves to XLA (no Pallas kernel); here they
are PyTorch matmuls. The dispatch is the JAX package's:

1. no layout: the dense einsum, ``x @ W[r]`` for every (row, type) pair and
   then each row's own type picked, ``R - 1`` of ``R`` products wasted;
2. a :class:`TypedLayout`: rows sorted by type on the host into per-type
   runs padded to a shared bucket ``T``, then ONE batched GEMM ``[R, T, F]
   @ [R, F, C]``;
3. a :class:`RaggedLayout`: rows sorted by type, one GEMM per type over its
   run, no padding (``lax.ragged_dot`` in the JAX package). The run lengths
   are known on the host (``host_sizes``), so no call waits for the card.

The layouts are host-built sorts (like the cached CSC permutations): build
once per graph or batch shape.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..backend import resolve_device


class TypedLayout(NamedTuple):
    """Host-built type-major layout.

    perm:    [R * T] row feeding each slot (``len(x)`` for pads)
    inv:     [N] slot of each row (to scatter results back)
    bucket:  T (rows per type after padding)
    """
    perm: torch.Tensor
    inv: torch.Tensor
    bucket: int


def build_typed_layout(types, num_types: int, bucket: Optional[int] = None,
                       device=None) -> TypedLayout:
    """Sort rows by type; pad every type's run to ``bucket`` slots. The
    index tensors go to ``device`` (None: the card)."""
    dev = resolve_device(device)
    types = np.asarray(types)
    n = len(types)
    counts = np.bincount(types, minlength=num_types)
    T = int(bucket or (int(counts.max()) if n else 1))
    T = max(T, 1)
    if n and int(counts.max()) > T:
        raise ValueError(
            f'build_typed_layout: bucket={T} is smaller than the largest '
            f'per-type count ({int(counts.max())}); rows would be silently '
            f'dropped. Pass bucket=None to size automatically.')
    perm = np.full(num_types * T, n, np.int64)
    inv = np.zeros(n, np.int64)
    order = np.argsort(types, kind='stable')
    cursor = 0
    for r in range(num_types):
        c = int(counts[r])
        take = min(c, T)
        rows = order[cursor:cursor + take]
        perm[r * T:r * T + take] = rows
        inv[rows] = r * T + np.arange(take)
        cursor += c
    return TypedLayout(perm=torch.from_numpy(perm.astype(np.int32)).to(dev),
                       inv=torch.from_numpy(inv.astype(np.int32)).to(dev),
                       bucket=T)


class RaggedLayout(NamedTuple):
    """Host-built type-major sort for the ragged arm.

    order:       [N] row indices sorted by type (stable)
    unorder:     [N] inverse permutation (sorted slot -> original row)
    group_sizes: [R] rows per type
    host_sizes:  the same counts as Python ints, which the arm splits by
    """
    order: torch.Tensor
    unorder: torch.Tensor
    group_sizes: torch.Tensor
    host_sizes: Tuple[int, ...]


def build_ragged_layout(types, num_types: int, device=None) -> RaggedLayout:
    """Stable type-sort of rows, no padding (see :class:`RaggedLayout`).
    The index tensors go to ``device`` (None: the card)."""
    dev = resolve_device(device)
    types = np.asarray(types)
    order = np.argsort(types, kind='stable')
    unorder = np.empty_like(order)
    unorder[order] = np.arange(len(order))
    sizes = np.bincount(types, minlength=num_types)
    return RaggedLayout(
        order=torch.from_numpy(order.astype(np.int32)).to(dev),
        unorder=torch.from_numpy(unorder.astype(np.int32)).to(dev),
        group_sizes=torch.from_numpy(sizes.astype(np.int32)).to(dev),
        host_sizes=tuple(int(s) for s in sizes))


def typed_matmul(x: torch.Tensor, types: Optional[torch.Tensor],
                 weights: torch.Tensor,
                 layout: Optional[NamedTuple] = None) -> torch.Tensor:
    """``out[i] = x[i] @ weights[types[i]]``.

    ``x [N, F]``; ``types [N]`` int (unused with a layout); ``weights [R,
    F, C]``. A :class:`RaggedLayout` (:func:`build_ragged_layout`) takes one
    GEMM per type run; a :class:`TypedLayout` the sort-and-batch batched
    GEMM; no layout the dense einsum."""
    r = weights.shape[0]
    if isinstance(layout, RaggedLayout):
        xs = x.index_select(0, layout.order.long())
        parts = [p @ weights[i] for i, p in
                 enumerate(torch.split(xs, list(layout.host_sizes)))]
        out = torch.cat(parts) if parts else x.new_zeros(
            (0, weights.shape[-1]))
        return out.index_select(0, layout.unorder.long())
    if layout is None:
        # dense: [N, R, C], then each row's own type
        all_out = torch.einsum('nf,rfc->nrc', x, weights)
        return torch.take_along_dim(
            all_out, types.long()[:, None, None], dim=1)[:, 0]
    t = layout.bucket
    x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    xs = x_pad.index_select(0, layout.perm.long()).view(r, t, x.shape[1])
    out = torch.bmm(xs, weights)                    # one batched GEMM
    return out.reshape(r * t, -1).index_select(0, layout.inv.long())


def grouped_matmul(xs, weights):
    """List-of-matrices variant (reference ``pyg_lib.ops.grouped_matmul``):
    ``out[i] = xs[i] @ weights[i]``."""
    return [x @ w for x, w in zip(xs, weights)]
