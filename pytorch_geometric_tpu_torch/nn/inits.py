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


def glorot(shape, device=None,
           generator: Optional[torch.Generator] = None) -> nn.Parameter:
    """A parameter of ``shape`` drawn as flax's ``glorot_uniform`` draws
    it: fan in and out from the last two axes, each times the product of
    the leading axes (flax's receptive field); a 1-D shape takes its one
    axis as both fans."""
    shape = tuple(shape)
    if len(shape) >= 2:
        field = math.prod(shape[:-2])
        fan_in, fan_out = shape[-2] * field, shape[-1] * field
    else:
        fan_in = fan_out = shape[0] if shape else 1
    limit = math.sqrt(6.0 / max(fan_in + fan_out, 1))
    t = torch.empty(shape).uniform_(-limit, limit, generator=generator)
    return nn.Parameter(t.to(device))


def constant(shape, value: float, device=None) -> nn.Parameter:
    """A parameter of ``shape`` filled with ``value`` (flax's ``zeros`` /
    ``ones``)."""
    return nn.Parameter(torch.full(tuple(shape), float(value),
                                   device=device))


def embedding(num_embeddings: int, features: int, device=None,
              generator: Optional[torch.Generator] = None) -> nn.Embedding:
    """``nn.Embedding`` initialised as flax's ``Embed``: a normal truncated
    at two standard deviations, variance ``1 / features``."""
    emb = nn.Embedding(num_embeddings, features)
    with torch.no_grad():
        std = math.sqrt(1.0 / max(features, 1)) / .87962566103423978
        nn.init.trunc_normal_(emb.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
    return emb.to(device)


def gru_cell(in_channels: int, features: int, device=None,
             generator: Optional[torch.Generator] = None) -> nn.GRUCell:
    """``torch.nn.GRUCell`` in the place of flax's ``GRUCell``, whose reset
    and update gates have no hidden bias: those two start at 0 (and
    ``convert.py`` loads them as 0), the rest uniform in ``+-features **
    -0.5``."""
    cell = nn.GRUCell(in_channels, features)
    with torch.no_grad():
        bound = features ** -0.5
        for p in cell.parameters():
            p.uniform_(-bound, bound, generator=generator)
        cell.bias_hh[:2 * features].zero_()
    return cell.to(device)
