"""MultiAggregation and DegreeScalerAggregation.

Counterpart of ``pytorch_geometric_tpu/nn/aggr/multi.py`` (reference
``torch_geometric/nn/aggr/multi.py:14`` and ``nn/aggr/scaler.py:11``, the
PNA scalers).
"""

from typing import Any, Optional, Sequence

import torch

from .base import Aggregation
from .basic import (MaxAggregation, MeanAggregation, MinAggregation,
                    MulAggregation, PowerMeanAggregation, SoftmaxAggregation,
                    StdAggregation, SumAggregation, VarAggregation,
                    VariancePreservingAggregation)
from ..inits import linear
from ...backend import resolve_device

_STR_AGGRS = {
    'sum': SumAggregation, 'add': SumAggregation, 'mean': MeanAggregation,
    'max': MaxAggregation, 'min': MinAggregation, 'mul': MulAggregation,
    'var': VarAggregation, 'std': StdAggregation,
    'softmax': SoftmaxAggregation, 'powermean': PowerMeanAggregation,
    'variance_preserving': VariancePreservingAggregation,
}


def aggregation_resolver(aggr) -> Aggregation:
    """A name, a list of names or modules, or a module -> an
    ``Aggregation`` module."""
    if isinstance(aggr, Aggregation):
        return aggr
    if isinstance(aggr, (list, tuple)):
        return MultiAggregation(aggrs=tuple(aggr))
    if isinstance(aggr, str):
        key = aggr.lower()
        if key not in _STR_AGGRS:
            raise ValueError(f"Unknown aggregation '{aggr}' "
                             f'(choose from {sorted(_STR_AGGRS)})')
        return _STR_AGGRS[key]()
    raise TypeError(f'Cannot resolve aggregation from {type(aggr)}')


class MultiAggregation(Aggregation):
    """Several aggregations combined by ``mode``: 'cat', 'proj' (a Linear
    from the concatenation to ``out_channels``, by default one
    aggregation's width; give ``in_channels``, the concatenation's width),
    'sum', 'mean', 'max' or 'min'."""

    def __init__(self, aggrs: Sequence[Any] = ('mean', 'max'),
                 mode: str = 'cat', in_channels: Optional[int] = None,
                 out_channels: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ('cat', 'proj', 'sum', 'add', 'mean', 'max', 'min'):
            raise ValueError(f"Unknown combine mode '{mode}'")
        self.aggrs = torch.nn.ModuleList(aggregation_resolver(a)
                                         for a in aggrs)
        self.mode = mode
        self.proj = None
        if mode == 'proj':
            if in_channels is None:
                raise ValueError("MultiAggregation(mode='proj') needs "
                                 'in_channels (the concatenated width)')
            out = out_channels or in_channels // len(self.aggrs)
            self.proj = linear(in_channels, out,
                               device=resolve_device(device),
                               generator=generator)

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        outs = [a(x, index, dim_size, mask, max_num_elements)
                for a in self.aggrs]
        if self.mode in ('cat', 'proj'):
            out = torch.cat(outs, -1)
            return out if self.proj is None else self.proj(out)
        stack = torch.stack(outs, 0)
        if self.mode in ('sum', 'add'):
            return stack.sum(0)
        if self.mode == 'mean':
            return stack.mean(0)
        if self.mode == 'max':
            return stack.amax(0)
        return stack.amin(0)


class DegreeScalerAggregation(Aggregation):
    """PNA: the aggregations times each degree scaler, concatenated
    aggregation-major within each scaler (scaler-major overall).

    ``avg_deg_log`` is the training set's E[log(deg + 1)] and
    ``avg_deg_lin`` its E[deg]. 'amplification' multiplies by log(deg + 1)
    / avg_deg_log, 'attenuation' by avg_deg_log / log(max(deg, 1) + 1),
    'linear' by deg / avg_deg_lin, 'inverse_linear' by avg_deg_lin /
    max(deg, 1). ``train_norm=True`` (the statistics as trained
    parameters) is not supported and raises."""

    def __init__(self, aggr: Any = ('mean', 'min', 'max', 'std'),
                 scaler: Sequence[str] = ('identity', 'amplification',
                                          'attenuation'),
                 avg_deg_log: float = 1.0, avg_deg_lin: float = 1.0,
                 train_norm: bool = False):
        super().__init__()
        if train_norm:
            raise NotImplementedError('train_norm=True (trained degree '
                                      'statistics) is not supported')
        for s in scaler:
            if s not in ('identity', 'amplification', 'attenuation',
                         'linear', 'inverse_linear'):
                raise ValueError(f"Unknown scaler '{s}'")
        self.aggr = aggregation_resolver(
            MultiAggregation(aggrs=tuple(aggr))
            if isinstance(aggr, (list, tuple)) else aggr)
        self.scaler = tuple(scaler)
        self.avg_deg_log = avg_deg_log
        self.avg_deg_lin = avg_deg_lin

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        out = self.aggr(x, index, dim_size, mask, max_num_elements)
        deg = self.reduce(x.new_ones(x.shape[0]), index, dim_size, 'sum',
                          mask)
        outs = []
        for s in self.scaler:
            if s == 'identity':
                outs.append(out)
            elif s == 'amplification':
                outs.append(out * (torch.log(deg + 1)[:, None]
                                   / self.avg_deg_log))
            elif s == 'attenuation':
                outs.append(out * (self.avg_deg_log / torch.log(
                    deg.clamp(min=1.0) + 1)[:, None]))
            elif s == 'linear':
                outs.append(out * (deg[:, None] / self.avg_deg_lin))
            else:
                outs.append(out * (self.avg_deg_lin
                                   / deg[:, None].clamp(min=1.0)))
        return torch.cat(outs, -1)
