"""Weight initialisers matching the JAX package's flax defaults, drawn from
an explicit ``torch.Generator`` on the CPU and then moved to the device, so
one seed gives the same weights on every device."""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """``nn.Linear`` that promotes its input and parameters to one dtype
    first, as flax's ``Dense`` does (``promote_dtype``): a bf16 input to
    float32 parameters computes, and returns, float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


def linear(in_channels: int, out_channels: int, bias: bool = True,
           init: str = 'lecun_normal', device=None,
           generator: Optional[torch.Generator] = None) -> Linear:
    """:class:`Linear` initialised as flax's ``Dense``: ``lecun_normal`` (a
    normal truncated at two standard deviations, variance ``1 / fan_in``)
    or ``glorot_uniform`` for the weight, zeros for the bias."""
    lin = Linear(in_channels, out_channels, bias=bias)
    with torch.no_grad():
        if init == 'glorot_uniform':
            nn.init.xavier_uniform_(lin.weight, generator=generator)
        elif init == 'lecun_normal':
            # flax scales the truncated normal so its variance is 1/fan_in
            std = math.sqrt(1.0 / max(in_channels, 1)) / .87962566103423978
            nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
        else:
            raise ValueError(f'unknown init {init!r}')
        if bias:
            lin.bias.zero_()
    return lin.to(device)
