"""Graph utilities of the compute path.

Counterpart of ``pytorch_geometric_tpu/utils/core.py``: ``degree``,
``cumsum``, ``one_hot``, ``index_sort``, ``lexsort``,
``scatter_normalize`` and ``maybe_num_nodes``, each keeping shapes static
so it can sit inside a captured step.
"""

from typing import Optional, Sequence

import torch

from .loop import maybe_num_nodes


def degree(index: torch.Tensor, num_nodes: int, dtype=torch.float32,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Node degrees from an endpoint vector; ``mask`` drops padded edges,
    and so does an index outside ``[0, num_nodes)``."""
    index = index.long()
    valid = (index >= 0) & (index < num_nodes)
    if mask is not None:
        valid = valid & mask
    index = torch.where(valid, index, num_nodes)
    out = torch.zeros(num_nodes + 1, dtype=dtype, device=index.device)
    return out.index_add_(0, index, torch.ones(index.shape[0], dtype=dtype,
                                               device=index.device))[:-1]


def cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Cumulative sum with a zero prepended: ``shape[dim] + 1`` entries
    (a ``ptr`` vector from counts)."""
    out = torch.cumsum(x, dim=dim)
    zero = out.narrow(dim, 0, 1).new_zeros(
        out.shape[:dim] + (1,) + out.shape[dim + 1:])
    return torch.cat([zero, out], dim=dim)


def one_hot(index: torch.Tensor, num_classes: int,
            dtype=torch.float32) -> torch.Tensor:
    """One-hot rows; as ``jax.nn.one_hot``, an index outside ``[0,
    num_classes)`` gives a row of zeros."""
    classes = torch.arange(num_classes, device=index.device)
    return (index.long()[..., None] == classes).to(dtype)


def index_sort(x: torch.Tensor, max_value: Optional[int] = None):
    """``(sorted, perm)`` of an index vector, stable."""
    perm = torch.argsort(x, stable=True)
    return x[perm], perm


def lexsort(keys: Sequence[torch.Tensor],
            descending: bool = False) -> torch.Tensor:
    """The permutation sorting by several keys, the last key primary (as
    ``numpy.lexsort``); ties keep their order."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        k = -k if descending else k
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def scatter_normalize(edge_weight: torch.Tensor, index: torch.Tensor,
                      num_nodes: int) -> torch.Tensor:
    """Edge weights scaled so that the weights into each node sum to 1."""
    index = index.long()
    s = edge_weight.new_zeros((num_nodes,) + edge_weight.shape[1:])
    s = s.index_add_(0, index, edge_weight)
    return edge_weight / s[index].clamp(min=1e-16)


__all__ = ['degree', 'cumsum', 'one_hot', 'index_sort', 'lexsort',
           'scatter_normalize', 'maybe_num_nodes']
