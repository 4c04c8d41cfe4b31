"""Aggregation base class.

Counterpart of ``pytorch_geometric_tpu/nn/aggr/base.py`` (reference
``torch_geometric/nn/aggr/base.py:10``). Every reduction goes through
``ops.scatter`` (``index_add_`` / ``scatter_reduce_``), as the JAX package
goes through XLA's segment ops; neither has a hand-written kernel for
them. Every entry point takes a static ``dim_size``.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from ...ops import scatter
from ...utils.dense import to_dense_batch


class Aggregation(nn.Module):
    """Base of the permutation-invariant set aggregations.

    Call signature of every subclass: ``aggr(x, index, dim_size, mask=None,
    max_num_elements=None)``: ``x`` is ``[N, F]`` (or ``[N]``), ``index``
    puts each row in a segment, ``dim_size`` is the static number of
    segments, and ``mask`` marks the valid rows. An index outside ``[0,
    dim_size)`` (a padded row at ``dim_size``) is dropped."""

    def forward(self, x: torch.Tensor, index: Optional[torch.Tensor] = None,
                dim_size: Optional[int] = None,
                mask: Optional[torch.Tensor] = None,
                max_num_elements: Optional[int] = None) -> torch.Tensor:
        if index is None:
            index = torch.zeros(x.shape[0], dtype=torch.long,
                                device=x.device)
            dim_size = dim_size or 1
        if dim_size is None:
            raise ValueError('Aggregation requires a static dim_size')
        return self.aggregate(x, index, dim_size, mask, max_num_elements)

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        raise NotImplementedError

    # -- helpers -----------------------------------------------------------
    def reduce(self, x: torch.Tensor, index: torch.Tensor, dim_size: int,
               reduce: str = 'sum',
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return scatter(x, index, dim_size, reduce=reduce, mask=mask)

    def to_dense(self, x: torch.Tensor, index: torch.Tensor, dim_size: int,
                 mask: Optional[torch.Tensor] = None,
                 max_num_elements: Optional[int] = None,
                 fill_value: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ragged rows to padded ``[dim_size, L, F]`` and its mask."""
        if max_num_elements is None:
            max_num_elements = int(x.shape[0])
        index = index.long()
        if mask is not None:
            index = torch.where(mask, index, dim_size)
        dense, valid = to_dense_batch(x, index, dim_size + 1,
                                      max_num_elements,
                                      fill_value=fill_value)
        return dense[:dim_size], valid[:dim_size]
