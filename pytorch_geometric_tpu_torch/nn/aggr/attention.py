"""Learnable set aggregations: attentional pooling, Set2Set, DeepSets.

Counterpart of ``pytorch_geometric_tpu/nn/aggr/attention.py`` (reference
``torch_geometric/nn/aggr/attention.py``, ``set2set.py`` and
``deep_sets.py``).
"""

from typing import Optional

import torch
from torch import nn

from .base import Aggregation
from ..inits import linear
from ...backend import resolve_device
from ...ops import softmax as segment_softmax


class AttentionalAggregation(Aggregation):
    """r_b = sum_i softmax(gate_nn(x_i)) * nn(x_i); ``gate_nn`` maps F to 1
    (or F), ``nn`` (optional) transforms the features first."""

    def __init__(self, gate_nn: nn.Module, nn: Optional[nn.Module] = None):
        super().__init__()
        self.gate_nn = gate_nn
        self.nn = nn

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        gate = self.gate_nn(x)
        h = self.nn(x) if self.nn is not None else x
        alpha = segment_softmax(gate, index, dim_size, mask=mask)
        return self.reduce(alpha * h, index, dim_size, 'sum', mask)


class _LSTMCell(nn.Module):
    """flax's ``LSTMCell``: gates i, f, g, o from eight Dense layers (the
    input ones ``ii``, ``if``, ``ig``, ``io`` without bias, the hidden ones
    ``hi``, ``hf``, ``hg``, ``ho`` with), stacked here into one input and
    one hidden weight in the gate order i, f, g, o, as ``nn.LSTMCell``
    keeps them; sigmoid gates and a tanh cell input, the carry ``(c,
    h)``."""

    def __init__(self, in_channels: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        ih = [linear(in_channels, features, bias=False, device=device,
                     generator=generator) for _ in range(4)]
        # flax initialises the hidden Denses orthogonally; any weights do
        # for a fresh model, and trained ones come from convert.py
        hh = [linear(features, features, device=device,
                     generator=generator) for _ in range(4)]
        self.weight_ih = nn.Parameter(torch.cat([m.weight for m in ih]))
        self.weight_hh = nn.Parameter(torch.cat([m.weight for m in hh]))
        self.bias_hh = nn.Parameter(torch.cat([m.bias for m in hh]))

    def forward(self, carry, x):
        c, h = carry
        gates = (nn.functional.linear(x, self.weight_ih)
                 + nn.functional.linear(h, self.weight_hh, self.bias_hh))
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class Set2Set(Aggregation):
    """LSTM-iterated attention pooling (Vinyals et al.): ``[dim_size,
    2F]``, ``processing_steps`` rounds of an LSTM cell over ``q*``, a
    segment softmax of ``<x_i, q>`` and the weighted sum."""

    def __init__(self, in_channels: int, processing_steps: int = 4,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.processing_steps = processing_steps
        self.lstm = _LSTMCell(2 * in_channels, in_channels,
                              device=resolve_device(device),
                              generator=generator)

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        f = x.shape[-1]
        q_star = x.new_zeros((dim_size, 2 * f))
        carry = (x.new_zeros((dim_size, f)), x.new_zeros((dim_size, f)))
        idx = index.long().clamp(0, dim_size - 1)
        for _ in range(self.processing_steps):
            carry, q = self.lstm(carry, q_star)
            e = (x * q[idx]).sum(-1, keepdim=True)
            a = segment_softmax(e, index, dim_size, mask=mask)
            r = self.reduce(a * x, index, dim_size, 'sum', mask)
            q_star = torch.cat([q, r], -1)
        return q_star


class DeepSetsAggregation(Aggregation):
    """global_nn(sum_i local_nn(x_i))."""

    def __init__(self, local_nn: Optional[nn.Module] = None,
                 global_nn: Optional[nn.Module] = None):
        super().__init__()
        self.local_nn = local_nn
        self.global_nn = global_nn

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        if self.local_nn is not None:
            x = self.local_nn(x)
        out = self.reduce(x, index, dim_size, 'sum', mask)
        if self.global_nn is not None:
            out = self.global_nn(out)
        return out
