"""MLP.

Counterpart of ``pytorch_geometric_tpu/nn/models/mlp.py``.
"""

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..inits import linear
from ..norm.norms import RunningBatchNorm
from ...backend import resolve_device


class MLP(nn.Module):
    """Multi-layer perceptron over a channel list, with optional batch or
    layer norm and dropout.

    ``channel_list`` excludes the input width, as in the JAX package:
    ``MLP(16, [64, 64, 10])`` is three Linear layers ``16 -> 64 -> 64 ->
    10``. ``norm='batch_norm'`` is flax's default ``BatchNorm``
    (:class:`~..norm.RunningBatchNorm`, momentum 0.01 in torch's sense):
    batch statistics in training mode, running ones in eval mode."""

    def __init__(self, in_channels: int, channel_list: Sequence[int],
                 act: Callable = F.relu, norm: Optional[str] = None,
                 dropout: float = 0.0, plain_last: bool = True,
                 use_bias: bool = True, act_first: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm not in (None, 'batch_norm', 'layer_norm'):
            raise ValueError(f'unknown norm {norm!r}')
        device = resolve_device(device)
        self.act = act
        self.dropout = dropout
        self.plain_last = plain_last
        self.act_first = act_first
        widths = [in_channels] + list(channel_list)
        self.lins = nn.ModuleList(
            linear(i, o, bias=use_bias, device=device, generator=generator)
            for i, o in zip(widths[:-1], widths[1:]))
        n_norms = len(channel_list) - (1 if plain_last else 0)
        if norm == 'batch_norm':
            self.norms = nn.ModuleList(
                RunningBatchNorm(c, device=device)
                for c in channel_list[:n_norms])
        elif norm == 'layer_norm':
            # torch LayerNorm parity in the JAX package: eps=1e-5, two-pass
            self.norms = nn.ModuleList(
                nn.LayerNorm(c, eps=1e-5, device=device)
                for c in channel_list[:n_norms])
        else:
            self.norms = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.lins)
        for i, lin in enumerate(self.lins):
            x = lin(x)
            if i == n - 1 and self.plain_last:
                break
            if self.act_first:
                x = self.act(x)
            if self.norms is not None:
                x = self.norms[i](x)
            if not self.act_first:
                x = self.act(x)
            x = F.dropout(x, self.dropout, training=self.training)
        return x
