"""SuperGATConv: GAT with self-supervised attention (Kim and Oh).

Counterpart of ``SuperGATConv`` in ``pytorch_geometric_tpu/nn/conv/
gps_conv.py:194-251`` (the rest of that file, ``GPSConv``, ``RGATConv`` and
``HEATConv``, is the port's ``gps_conv.py``). Two attention forms:

  * ``'MX'``: ``alpha = (a_l . h_j + a_r . h_i) * sigmoid(h_i . h_j)``;
  * ``'SD'``: ``alpha = h_i . h_j / sqrt(C)``;

then LeakyReLU and a softmax over each destination's incoming edges. The
dot ``h_i . h_j`` is the per-edge dot kernel on the card
(``ops/sddmm.py``). Two branches, as in the JAX package:

  * fused: the slot orders cached (``fill_cache(blocked=True)``) and no
    self loops added at call time: the dot is ``ops.sddmm.sddmm`` (its
    backward on the mix kernel) and the softmax and aggregation one
    ``ops.gat_fused.gat_aggregate``. ``backend.use_kernel_spmm`` plays the
    JAX package's ``_use_pallas()``: off, the CPU takes the plain branch
    and the card raises;
  * plain: the dot by :func:`ops.sddmm.gathered_dot` over the clamped
    endpoints, ``ops.softmax`` over the clamped destinations, and
    ``index_add_``, as the JAX package leaves this branch to XLA. With
    ``add_self_loops`` the conv masks the input's loops and appends one per
    node (a raw COO), so this branch runs.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..inits import linear
from ..message_passing import MessagePassing
from ...backend import resolve_device
from ...edge_index import EdgeIndex
from ...ops.gat_fused import fused_ok, gat_aggregate
from ...ops.gather import take_rows
from ...ops.sddmm import gathered_dot, sddmm
from .gat_conv import _glorot


def _with_self_loops(edge_index, edge_mask: Optional[torch.Tensor], n: int):
    """remove_self_loops + add_self_loops with static shapes (the JAX
    package's ``nn/conv/point_conv.py:19-30``): the input's loops are
    masked out and ``n`` fresh loops appended; returns a raw COO and the
    mask."""
    coo = edge_index.coo if isinstance(edge_index, EdgeIndex) else edge_index
    loop_free = coo[0] != coo[1]
    edge_mask = loop_free if edge_mask is None else (edge_mask & loop_free)
    loops = torch.arange(n, dtype=coo.dtype, device=coo.device)
    coo = torch.cat([coo, torch.stack([loops, loops])], dim=1)
    edge_mask = torch.cat([edge_mask, edge_mask.new_ones(n)])
    return coo, edge_mask


class SuperGATConv(MessagePassing):
    """SuperGAT attention (``attention_type`` ``'MX'`` or ``'SD'``).
    Parameter names follow the JAX package's (``lin``, ``att_l``,
    ``att_r``, ``bias``), so ``convert.flax_to_state_dict`` carries its
    weights."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 add_self_loops: bool = True, attention_type: str = 'MX',
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if attention_type not in ('MX', 'SD'):
            raise ValueError(f'attention_type {attention_type!r} is not one '
                             f"of 'MX', 'SD'")
        device = resolve_device(device)
        self.out_channels, self.heads = out_channels, heads
        self.concat = concat
        self.negative_slope, self.add_self_loops = negative_slope, \
            add_self_loops
        self.attention_type = attention_type
        kw = dict(device=device, generator=generator)
        self.lin = linear(in_channels, heads * out_channels, bias=False, **kw)
        self.att_l = self.att_r = None
        if attention_type == 'MX':
            self.att_l = _glorot((1, heads, out_channels), **kw)
            self.att_r = _glorot((1, heads, out_channels), **kw)
        self.bias = (nn.Parameter(torch.zeros(
            heads * out_channels if concat else out_channels, device=device))
            if use_bias else None)

    def forward(self, x: torch.Tensor, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = x.shape[0]
        hd, c = self.heads, self.out_channels
        if self.add_self_loops:
            edge_index, edge_mask = _with_self_loops(edge_index, edge_mask, n)
        coo = edge_index.coo if isinstance(edge_index, EdgeIndex) \
            else edge_index
        src = coo[0].long().clamp(max=n - 1)
        dst = coo[1].long().clamp(max=n - 1)
        h = self.lin(x).view(n, hd, c)
        fused = not self.add_self_loops and fused_ok(edge_index, x)
        if fused:
            dot = sddmm(edge_index, h, h)
        else:
            dot = gathered_dot(h, h, src, dst)
        if self.attention_type == 'MX':
            e_l = (h * self.att_l).sum(-1)           # applied to x_j (src)
            e_r = (h * self.att_r).sum(-1)           # applied to x_i (dst)
            alpha = (take_rows(e_l, src) + take_rows(e_r, dst)) \
                * torch.sigmoid(dot)
        else:
            alpha = dot / math.sqrt(c)
        alpha = F.leaky_relu(alpha, self.negative_slope)
        if fused:
            out = gat_aggregate(edge_index, alpha, h,
                                edge_mask=edge_mask).reshape(n, hd * c)
        else:
            alpha = self.edge_softmax(alpha, dst, n, edge_mask)
            msg = (h[src] * alpha[..., None]).reshape(-1, hd * c)
            seg = dst if edge_mask is None else torch.where(edge_mask, dst,
                                                            n)
            out = msg.new_zeros((n + 1, hd * c)).index_add_(0, seg,
                                                            msg)[:n]
        if not self.concat:
            out = out.reshape(n, hd, c).mean(dim=1)
        if self.bias is not None:
            out = out + self.bias
        return out
