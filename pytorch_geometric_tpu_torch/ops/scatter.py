"""Index-based segment reductions (the GNN aggregation substrate).

Counterpart of ``pytorch_geometric_tpu/ops/scatter.py`` for the reductions
this port serves: ``sum`` (alias ``add``), ``mean``, ``min`` and ``max``
along dim 0. As in the JAX package, an index outside ``[0, dim_size)`` is
dropped (padded edges point at ``dim_size``), ``mask`` drops elements, and
an empty segment comes out as 0 for every reduction. As there, a min or max
output equal to the reduction's identity (``+inf`` / ``-inf`` for floats,
``iinfo.max`` / ``iinfo.min`` for integers) also becomes 0, empty segment or
not.
"""

from typing import Optional

import torch

REDUCTIONS = ('sum', 'add', 'mean', 'min', 'max')


def scatter(src: torch.Tensor, index: torch.Tensor, dim_size: int,
            reduce: str = 'sum',
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment-reduce ``src`` rows by ``index`` into ``dim_size``
    segments."""
    if reduce not in REDUCTIONS:
        raise ValueError(f"Unknown reduction '{reduce}' (choose from "
                         f"{REDUCTIONS})")
    index = index.long()
    valid = (index >= 0) & (index < dim_size)
    if mask is not None:
        valid = valid & mask
    # out-of-range and masked elements land in one extra row, cut off below
    index = torch.where(valid, index, dim_size)
    shape = (dim_size + 1,) + tuple(src.shape[1:])
    idx = index.view((-1,) + (1,) * (src.dim() - 1)).expand_as(src)
    if reduce in ('sum', 'add', 'mean'):
        out = src.new_zeros(shape).index_add_(0, index, src)
        if reduce == 'mean':
            count = src.new_zeros(dim_size + 1).index_add_(
                0, index, src.new_ones(index.shape[0]))
            count = count.clamp(min=1).view((-1,) + (1,) * (src.dim() - 1))
            out = out / count
        return out[:dim_size]
    # min / max: empty segments keep the zero they start from
    out = src.new_zeros(shape).scatter_reduce_(
        0, idx, src, reduce='amin' if reduce == 'min' else 'amax',
        include_self=False)[:dim_size]
    return torch.where(out == _identity(reduce, src.dtype), 0, out)


def _identity(reduce: str, dtype: torch.dtype):
    """The identity of ``reduce`` ('min' or 'max') in ``dtype``, as the JAX
    package's ``_identity``."""
    if dtype.is_floating_point:
        return float('inf') if reduce == 'min' else float('-inf')
    info = torch.iinfo(dtype)
    return info.max if reduce == 'min' else info.min
