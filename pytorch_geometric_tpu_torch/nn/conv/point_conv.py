"""EdgeConv.

Counterpart of ``EdgeConv`` in ``pytorch_geometric_tpu/nn/conv/
point_conv.py`` (reference ``torch_geometric/nn/conv/edge_conv.py``), the
convolution of ``EdgeCNN``. The file's other convolutions
(``DynamicEdgeConv`` and the point-cloud ones) need ``knn_graph`` of
``nn/pool/point.py`` and are ROADMAP Queue 1, item 11.
"""

from typing import Optional

import torch
from torch import nn

from ..message_passing import MessagePassing


class EdgeConv(MessagePassing):
    """x'_i = aggr_j nn([x_i, x_j - x_i]), max by default. The network is
    kept as ``mlp``, the name ``EdgeCNN``'s flax parameters carry
    (``mlp_i``)."""

    def __init__(self, nn: nn.Module, aggr: str = 'max'):
        super().__init__()
        self.mlp = nn
        self.aggr = aggr

    def forward(self, x, edge_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        return self.propagate(edge_index, x=(x_src, x_dst),
                              size=(x_src.shape[0], x_dst.shape[0]),
                              edge_mask=edge_mask)

    def message(self, x_i, x_j):
        return self.mlp(torch.cat([x_i, x_j - x_i], -1))
