"""CSR pointer <-> segment id conversions and pointer-delimited segment
reductions.

Counterpart of ``pytorch_geometric_tpu/ops/segment.py`` (``ptr2index``,
``index2ptr``, ``segment``, ``segment_logsumexp``), on torch tensors; the
reductions are plain PyTorch, as the JAX package leaves them to XLA.
"""

from typing import Optional

import torch

from .scatter import scatter


def ptr2index(ptr: torch.Tensor,
              num_elements: Optional[int] = None) -> torch.Tensor:
    """Expand a CSR row pointer into per-element segment ids.

    Element ``e`` belongs to the segment ``s`` with ``ptr[s] <= e <
    ptr[s + 1]``; elements at or past ``ptr[-1]`` get ``len(ptr) - 1``, one
    past the last segment, so segment ops drop them."""
    if num_elements is None:
        num_elements = int(ptr[-1])
    pos = torch.arange(num_elements, dtype=ptr.dtype, device=ptr.device)
    return torch.searchsorted(ptr[1:].contiguous(), pos,
                              right=True).to(ptr.dtype)


def index2ptr(index: torch.Tensor, size: int) -> torch.Tensor:
    """Build a CSR pointer ``[size + 1]`` from a **sorted** segment-id
    vector."""
    pos = torch.arange(size + 1, dtype=index.dtype, device=index.device)
    return torch.searchsorted(index.contiguous(), pos).to(index.dtype)


def segment(src: torch.Tensor, ptr: torch.Tensor, num_segments: int,
            reduce: str = 'sum') -> torch.Tensor:
    """Reduce the contiguous runs of ``src`` that ``ptr [num_segments + 1]``
    delimits (JAX ``ops/segment.py:42-50``); any :func:`scatter`
    reduction."""
    return scatter(src, ptr2index(ptr, src.shape[0]), num_segments,
                   reduce=reduce)


def segment_logsumexp(src: torch.Tensor, ptr: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """``log(sum(exp(src)))`` over each run of ``ptr``, shifted by the run's
    max for stability (JAX ``ops/segment.py:53-65``). An empty run gives
    ``-inf``, as there: the JAX package's floor of 1e-38 on the sum lies
    below float32's normal range and is flushed to zero."""
    index = ptr2index(ptr, src.shape[0]).long()
    valid = index < num_segments
    idx = torch.where(valid, index, num_segments)
    shape = (num_segments + 1,) + tuple(src.shape[1:])
    ix = idx.view((-1,) + (1,) * (src.dim() - 1)).expand_as(src)
    maxes = src.new_full(shape, float('-inf')).scatter_reduce_(
        0, ix, src, reduce='amax', include_self=True)
    maxes = torch.where(torch.isfinite(maxes), maxes, 0.0)
    shifted = torch.exp(src - maxes[idx])
    sums = src.new_zeros(shape).index_add_(0, idx, shifted)
    return (maxes + torch.log(sums))[:num_segments]
