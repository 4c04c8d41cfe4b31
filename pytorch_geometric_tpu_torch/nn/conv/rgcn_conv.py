"""Relational GCN (reference ``nn/conv/rgcn_conv.py:29,302``).

Counterpart of ``pytorch_geometric_tpu/nn/conv/rgcn_conv.py``. The relation
transform is one batched product ``x @ W[R]`` (``[R, N, F']``), then each
edge's row of its relation is gathered and summed into its destination;
with a ``typed_layout`` the transform runs per edge instead, through
``ops.grouped.typed_matmul`` (E x F' where the dense one is R x N x F').
Basis decomposition composes the bank first; block-diagonal weights
transform reshaped features. The JAX package aggregates with ``scatter``
(XLA, no Pallas kernel), and so does the port (``index_add_``; on the card
its adds are atomic, so the last bits may change from run to run).
"""

from typing import Optional, Tuple, Union

import torch

from ..inits import constant, glorot, linear
from ..message_passing import MessagePassing
from ...backend import resolve_device
from ...ops import scatter


class RGCNConv(MessagePassing):
    """``x'_i = W_root x_i + sum_r sum_{j in N_r(i)} 1/c_{i,r} W_r x_j``.

    ``in_channels`` is an int or ``(in_src, in_dst)`` for bipartite ``(x_src,
    x_dst)`` input. Parameters as the JAX package names them: ``weight [R,
    F, F']``, or ``basis [B, F, F']`` and ``comp [R, B]``, or ``blocks [R,
    B, F/B, F'/B]``; ``root`` (no bias) and ``bias``."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, num_relations: int = 1,
                 num_bases: Optional[int] = None,
                 num_blocks: Optional[int] = None, aggr: str = 'mean',
                 root_weight: bool = True, use_bias: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst = (in_channels if isinstance(in_channels, tuple)
                          else (in_channels, in_channels))
        self.in_channels, self.out_channels = in_channels, out_channels
        self.num_relations = r = num_relations
        self.num_bases, self.num_blocks = num_bases, num_blocks
        self.aggr = aggr
        if num_bases is not None:
            self.basis = glorot((num_bases, in_src, out_channels), device,
                                generator)
            self.comp = glorot((r, num_bases), device, generator)
        elif num_blocks is not None:
            if in_src % num_blocks or out_channels % num_blocks:
                raise ValueError('num_blocks must divide in_channels and '
                                 'out_channels')
            self.blocks = glorot((r, num_blocks, in_src // num_blocks,
                                  out_channels // num_blocks), device,
                                 generator)
        else:
            self.weight = glorot((r, in_src, out_channels), device,
                                 generator)
        self.root = (linear(in_dst, out_channels, bias=False, device=device,
                            generator=generator) if root_weight else None)
        self.bias = (constant((out_channels,), 0.0, device) if use_bias
                     else None)

    def _bank(self) -> Optional[torch.Tensor]:
        """The ``[R, F, F']`` bank, None for block-diagonal weights."""
        if self.num_bases is not None:
            return torch.einsum('rb,bio->rio', self.comp, self.basis)
        if self.num_blocks is not None:
            return None
        return self.weight

    def forward(self, x, edge_index, edge_type: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None,
                typed_layout=None) -> torch.Tensor:
        """``typed_layout``: optional host-built
        ``ops.build_ragged_layout(edge_type, num_relations)`` (or a
        ``TypedLayout``): the relation transform per edge instead of the
        dense ``[R, N, F']`` product."""
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        n_src, n_dst = x_src.shape[0], x_dst.shape[0]
        r = self.num_relations
        weight = self._bank()

        coo = edge_index.coo if hasattr(edge_index, 'coo') else edge_index
        src = coo[0].long().clamp(max=n_src - 1)
        dst = coo[1].long().clamp(max=n_dst - 1)
        et = edge_type.long().clamp(max=r - 1)

        if typed_layout is not None and weight is not None:
            # the segment_matmul form: gather source rows, one GEMM per
            # relation run
            from ...ops.grouped import typed_matmul
            msg = typed_matmul(x_src.index_select(0, src), et, weight,
                               typed_layout)
        else:
            if weight is not None:
                h = torch.einsum('nf,rfo->rno', x_src, weight)  # [R, N, F']
            else:
                b = self.num_blocks
                xb = x_src.reshape(n_src, b, -1)
                h = torch.einsum('nbf,rbfo->rnbo', xb, self.blocks).reshape(
                    r, n_src, self.out_channels)
            msg = h.reshape(r * n_src, -1).index_select(
                0, et * n_src + src)                             # [E, F']

        # per (dst, relation) normalisation when aggr == 'mean'
        if self._aggr() == 'mean':
            flat = dst * r + et
            cnt = scatter(msg.new_ones(flat.shape[0]), flat, n_dst * r,
                          'sum', mask=edge_mask)
            norm = 1.0 / cnt.index_select(0, flat).clamp(min=1.0)
            msg = msg * norm[:, None]
            out = scatter(msg, dst, n_dst, 'sum', mask=edge_mask)
        else:
            out = scatter(msg, dst, n_dst, self._aggr(), mask=edge_mask)

        if self.root is not None and x_dst is not None:
            out = out + self.root(x_dst)
        if self.bias is not None:
            out = out + self.bias
        return out


class FastRGCNConv(RGCNConv):
    """The single-pass variant (reference ``rgcn_conv.py:302``): the base
    class already computes every relation in one batched product, so, as
    in the JAX package, an alias kept for API parity."""
