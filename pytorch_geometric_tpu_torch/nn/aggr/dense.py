"""Aggregations over a padded per-segment matrix: sort, quantile, median,
GRU, LSTM and MLP.

Counterpart of ``pytorch_geometric_tpu/nn/aggr/dense.py`` (reference
``torch_geometric/nn/aggr/sort.py``, ``quantile.py``, ``gru.py``,
``lstm.py`` and ``mlp.py``). Each lays the rows out as ``[dim_size, L,
F]`` (``Aggregation.to_dense``, ``L`` static) and works on that, as the
JAX package does; no Pallas kernel stands behind any of them.
"""

from typing import Optional

import torch
from torch import nn

from .attention import _LSTMCell
from .base import Aggregation
from ..inits import gru_cell, linear
from ...backend import resolve_device


class SortAggregation(Aggregation):
    """Each segment's rows sorted by their last channel, descending, the
    first ``k`` kept and flattened to ``[dim_size, k * F]`` (reference
    ``sort.py``). The sort is stable, as ``jnp.argsort`` is: equal keys
    keep their row order."""

    def __init__(self, k: int = 1):
        super().__init__()
        self.k = k

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        dense, valid = self.to_dense(x, index, dim_size, mask,
                                     max_num_elements)
        key = torch.where(valid, dense[..., -1], -torch.inf)
        order = torch.argsort(-key, dim=1, stable=True)
        sorted_x = dense.gather(1, order[..., None].expand_as(dense))
        sorted_valid = valid.gather(1, order)
        L = dense.shape[1]
        if L >= self.k:
            top, top_valid = sorted_x[:, :self.k], sorted_valid[:, :self.k]
        else:
            pad = self.k - L
            top = nn.functional.pad(sorted_x, (0, 0, 0, pad))
            top_valid = nn.functional.pad(sorted_valid, (0, pad))
        top = torch.where(top_valid[..., None], top, 0.0)
        return top.reshape(dim_size, self.k * x.shape[-1])


class QuantileAggregation(Aggregation):
    """The ``q``-quantile of each segment with ``interpolation`` in
    ``linear | lower | higher | nearest | midpoint`` (reference
    ``quantile.py``); an empty segment gives 0."""

    def __init__(self, q: float = 0.5, interpolation: str = 'linear'):
        super().__init__()
        if interpolation not in ('linear', 'lower', 'higher', 'nearest',
                                 'midpoint'):
            raise ValueError(f'unknown interpolation {interpolation!r}')
        self.q, self.interpolation = q, interpolation

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        squeeze = x.dim() == 1
        if squeeze:
            x = x[:, None]
        dense, valid = self.to_dense(x, index, dim_size, mask,
                                     max_num_elements, fill_value=torch.inf)
        dense = torch.where(valid[..., None], dense, torch.inf)
        sorted_x = torch.sort(dense, dim=1).values
        count = valid.sum(1)
        pos = self.q * (count - 1).clamp(min=0).to(x.dtype)
        lo = torch.floor(pos).long()
        hi = torch.ceil(pos).long()

        def take(idx):
            return sorted_x.gather(
                1, idx[:, None, None].expand(-1, 1, sorted_x.shape[-1]))[:, 0]

        x_lo, x_hi = take(lo), take(hi)
        if self.interpolation == 'lower':
            out = x_lo
        elif self.interpolation == 'higher':
            out = x_hi
        elif self.interpolation == 'nearest':
            out = torch.where((pos - lo)[:, None] < 0.5, x_lo, x_hi)
        elif self.interpolation == 'midpoint':
            out = 0.5 * (x_lo + x_hi)
        else:
            frac = (pos - lo.to(x.dtype))[:, None]
            out = x_lo + frac * (x_hi - x_lo)
        out = torch.where((count > 0)[:, None], out, 0.0)
        return out[:, 0] if squeeze else out


class MedianAggregation(QuantileAggregation):
    """The median, ``q = 0.5`` with lower interpolation (reference
    ``quantile.py``)."""

    def __init__(self):
        super().__init__(0.5, 'lower')


class GRUAggregation(Aggregation):
    """A GRU over each segment's padded sequence (row order, then the zero
    padding up to ``L``, as the reference's ``gru.py:57`` runs it); the
    final hidden state, ``[dim_size, out_channels]``."""

    def __init__(self, in_channels: int, out_channels: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gru = gru_cell(in_channels, out_channels or in_channels,
                            resolve_device(device), generator)

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        dense, _ = self.to_dense(x, index, dim_size, mask, max_num_elements)
        h = dense.new_zeros((dim_size, self.gru.hidden_size))
        for t in range(dense.shape[1]):
            h = self.gru(dense[:, t], h)
        return h


class LSTMAggregation(Aggregation):
    """An LSTM (flax's cell, ``attention._LSTMCell``) over each segment's
    padded sequence, the padding included (reference ``lstm.py:57``); the
    final hidden state."""

    def __init__(self, in_channels: int, out_channels: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lstm = _LSTMCell(in_channels, out_channels or in_channels,
                              device=resolve_device(device),
                              generator=generator)

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        dense, _ = self.to_dense(x, index, dim_size, mask, max_num_elements)
        zeros = dense.new_zeros((dim_size, self.lstm.features))
        carry = (zeros, zeros)
        for t in range(dense.shape[1]):
            carry, _ = self.lstm(carry, dense[:, t])
        return carry[1]


class MLPAggregation(Aggregation):
    """The padded ``[dim_size, L * F]`` segment matrix (invalid rows 0)
    through one Linear, ``mlp`` (reference ``mlp.py``); ``L`` is
    ``max_num_elements``, fixed at construction."""

    def __init__(self, in_channels: int, out_channels: int = 0,
                 max_num_elements: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not max_num_elements:
            raise ValueError('MLPAggregation needs max_num_elements')
        self.max_num_elements = max_num_elements
        self.mlp = linear(in_channels * max_num_elements,
                          out_channels or in_channels,
                          device=resolve_device(device),
                          generator=generator)

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        L = max_num_elements or self.max_num_elements
        dense, valid = self.to_dense(x, index, dim_size, mask, L)
        return self.mlp((dense * valid[..., None]).reshape(dim_size, -1))
