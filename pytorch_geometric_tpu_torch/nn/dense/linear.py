"""Linear / HeteroLinear / HeteroDictLinear.

Counterpart of ``pytorch_geometric_tpu/nn/dense/linear.py`` (reference
``torch_geometric/nn/dense/linear.py``; ``HeteroLinear``, ``:255``,
dispatches to ``pyg_lib.ops.segment_matmul`` on CUDA). The typed product is
``ops.grouped.typed_matmul`` against the ``[T, F, F']`` weight bank: the
dense einsum unless the caller passes a host-built layout, as in the JAX
package; the per-type bias is gathered by ``type_vec``.

The JAX modules infer their input width at ``init``; these take it as an
argument (an int, or for :class:`HeteroDictLinear` a per-type dict).
"""

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from ..inits import constant, glorot, linear
from ...backend import resolve_device
from ...ops.grouped import typed_matmul


class Linear(nn.Module):
    """Dense layer (reference ``nn/dense/linear.py:Linear``): ``lin``, a
    flax ``Dense`` initialised ``glorot`` (uniform) or, for any other
    ``weight_initializer``, ``kaiming`` (flax's ``kaiming_uniform``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = True, weight_initializer: str = 'glorot',
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.lin = linear(in_channels, out_channels, bias=use_bias,
                          init='glorot_uniform', device=device,
                          generator=generator)
        if weight_initializer != 'glorot':
            # flax's kaiming_uniform: variance 2 / fan_in, uniform
            with torch.no_grad():
                bound = (6.0 / max(in_channels, 1)) ** 0.5
                w = torch.empty(out_channels, in_channels).uniform_(
                    -bound, bound, generator=generator)
                self.lin.weight.copy_(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin(x)


class HeteroLinear(nn.Module):
    """Per-type linear ``out[i] = x[i] @ W[type[i]] (+ b[type[i]])``
    (reference ``linear.py:255``); ``weight [T, F, C]``, ``bias [T,
    C]``."""

    def __init__(self, in_channels: int, out_channels: int, num_types: int,
                 use_bias: bool = True, is_sorted: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_types = num_types
        self.is_sorted = is_sorted     # API parity; layout-independent
        self.weight = glorot((num_types, in_channels, out_channels), device,
                             generator)
        self.bias = (constant((num_types, out_channels), 0.0, device)
                     if use_bias else None)

    def forward(self, x: torch.Tensor, type_vec: torch.Tensor,
                typed_layout=None) -> torch.Tensor:
        """``typed_layout``: ``ops.build_ragged_layout(type_vec, T)`` for
        one GEMM per type, ``ops.build_typed_layout`` for the batched
        sort-and-batch GEMM; None for the dense einsum."""
        out = typed_matmul(x, type_vec, self.weight, typed_layout)
        if self.bias is not None:
            out = out + self.bias.index_select(0, type_vec.long())
        return out


class HeteroDictLinear(nn.Module):
    """Dict-of-types linear (reference ``linear.py:HeteroDictLinear``): one
    ``lin_{t}`` per type, glorot-initialised."""

    def __init__(self, in_channels: Union[int, Dict[str, int]],
                 out_channels: int, types: Sequence[str] = (),
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if isinstance(in_channels, dict):
            types = list(types) or list(in_channels)
        for t in types:
            f = (in_channels[t] if isinstance(in_channels, dict)
                 else in_channels)
            self.add_module(f'lin_{t}', linear(
                f, out_channels, bias=use_bias, init='glorot_uniform',
                device=device, generator=generator))

    def forward(self, x_dict: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        return {t: getattr(self, f'lin_{t}')(x) for t, x in x_dict.items()}
