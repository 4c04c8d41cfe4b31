"""Basic aggregations.

Counterpart of ``pytorch_geometric_tpu/nn/aggr/basic.py`` (reference
``torch_geometric/nn/aggr/basic.py``).
"""

import torch
from torch import nn

from .base import Aggregation
from ...ops import softmax as segment_softmax

# sqrt(1e-5) in float32, as the JAX package computes it: StdAggregation's
# floor, below which an output counts as undefined
_STD_FLOOR = float(torch.tensor(1e-5).sqrt())


class SumAggregation(Aggregation):
    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        return self.reduce(x, index, dim_size, 'sum', mask)


class MeanAggregation(Aggregation):
    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        return self.reduce(x, index, dim_size, 'mean', mask)


class MaxAggregation(Aggregation):
    """Empty segments give 0."""

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        return self.reduce(x, index, dim_size, 'max', mask)


class MinAggregation(Aggregation):
    """Empty segments give 0."""

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        return self.reduce(x, index, dim_size, 'min', mask)


class MulAggregation(Aggregation):
    """Empty segments give 1."""

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        return self.reduce(x, index, dim_size, 'mul', mask)


class VarAggregation(Aggregation):
    """E[x^2] - E[x]^2 per segment, clamped at 0."""

    def __init__(self, semi_grad: bool = False):
        super().__init__()
        self.semi_grad = semi_grad

    def _var(self, x, index, dim_size, mask):
        mean = self.reduce(x, index, dim_size, 'mean', mask)
        mean2 = self.reduce(x * x, index, dim_size, 'mean', mask)
        return (mean2 - mean * mean).clamp(min=0)

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        return self._var(x, index, dim_size, mask)


class StdAggregation(VarAggregation):
    """sqrt(max(var, 1e-5)), with the outputs at or below sqrt(1e-5) (the
    clamped, undefined ones) set to 0."""

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        out = self._var(x, index, dim_size, mask).clamp(min=1e-5).sqrt()
        return torch.where(out <= _STD_FLOOR, 0.0, out)


class SoftmaxAggregation(Aggregation):
    """sum_i softmax(t * x)_i * x_i, ``t`` a parameter of ``channels``
    entries with ``learn=True``."""

    def __init__(self, t: float = 1.0, learn: bool = False,
                 channels: int = 1, device=None):
        super().__init__()
        self.learn = learn
        if learn:
            self.t = nn.Parameter(torch.full((channels,), float(t),
                                             device=device))
        else:
            self.t = t

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        alpha = segment_softmax(x * self.t, index, dim_size, mask=mask)
        return self.reduce(x * alpha, index, dim_size, 'sum', mask)


class PowerMeanAggregation(Aggregation):
    """mean(clip(x, 0, 100)^p)^(1/p), the mean clipped to [1e-12, 1e4];
    ``p`` a parameter of ``channels`` entries with ``learn=True``."""

    def __init__(self, p: float = 1.0, learn: bool = False,
                 channels: int = 1, device=None):
        super().__init__()
        self.learn = learn
        if learn:
            self.p = nn.Parameter(torch.full((channels,), float(p),
                                             device=device))
        else:
            self.p = p

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        p = self.p
        xp = torch.pow(x.clamp(0, 100), p)
        out = self.reduce(xp, index, dim_size, 'mean', mask)
        return torch.pow(out.clamp(1e-12, 100 ** 2), 1.0 / p)


class VariancePreservingAggregation(Aggregation):
    """sum / sqrt(count), the count at least 1."""

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        total = self.reduce(x, index, dim_size, 'sum', mask)
        count = self.reduce(x.new_ones(x.shape[0]), index, dim_size, 'sum',
                            mask)
        scale = count.clamp(min=1.0).rsqrt()
        return total * scale.view((-1,) + (1,) * (total.dim() - 1))
