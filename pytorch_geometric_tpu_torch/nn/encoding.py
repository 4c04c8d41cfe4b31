"""PositionalEncoding, TemporalEncoding and TimeEncoder.

Counterpart of ``pytorch_geometric_tpu/nn/encoding.py`` (reference
``torch_geometric/nn/encoding.py:13,70`` and ``nn/models/tgn.py:215``).
"""

import math
from typing import Optional

import torch
from torch import nn

from .inits import linear
from ..backend import resolve_device


class PositionalEncoding(nn.Module):
    """Sinusoidal encoding of scalar positions: frequencies ``base_freq **
    linspace(0, 1, c / 2)``, output ``[sin(x f), cos(x f)]``."""

    def __init__(self, out_channels: int, base_freq: float = 1e-4,
                 granularity: float = 1.0):
        super().__init__()
        if out_channels % 2 != 0:
            raise ValueError(
                f"Cannot use sinusoidal positional encoding with odd "
                f"'out_channels' (got {out_channels}).")
        self.out_channels = out_channels
        self.base_freq = base_freq
        self.granularity = granularity

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = x / self.granularity if self.granularity != 1.0 else x
        freqs = torch.pow(self.base_freq, torch.linspace(
            0.0, 1.0, self.out_channels // 2, device=x.device))
        args = pos[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], -1)


class TemporalEncoding(nn.Module):
    """Parameter-free cosine time encoding (the GraphMixer paper):
    ``y_i = cos(t * sqrt(c) ** -linspace(0, sqrt(c), c)_i)``."""

    def __init__(self, out_channels: int):
        super().__init__()
        self.out_channels = out_channels

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        c = self.out_channels
        sqrt_c = math.sqrt(c)
        w = 1.0 / sqrt_c ** torch.linspace(0.0, sqrt_c, c, device=t.device)
        return torch.cos(t[:, None] * w[None, :])


class TimeEncoder(nn.Module):
    """Learned cosine time encoding ``cos(W t + b)`` (the TGN memory's);
    ``lin`` a flax ``Dense(1 -> out_channels)``."""

    def __init__(self, out_channels: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_channels = out_channels
        self.lin = linear(1, out_channels, device=resolve_device(device),
                          generator=generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cos(self.lin(t[:, None].float()))
