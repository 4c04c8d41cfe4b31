"""BasicGNN model family: GCN, GraphSAGE, GIN, GAT, PNA and EdgeCNN.

Counterpart of ``pytorch_geometric_tpu/nn/models/basic_gnn.py``. Stacks
``num_layers`` convolutions with activation, optional batch or layer norm,
dropout, jumping-knowledge aggregation and a final projection;
:func:`basic_gnn_inference` runs a model layer by layer over sampled
neighbourhoods.
"""

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..conv import (EdgeConv, GATConv, GATv2Conv, GCNConv, GINConv,
                    PNAConv, SAGEConv)
from ..inits import linear
from ..norm.norms import RunningBatchNorm
from .mlp import MLP
from ...backend import resolve_device


class BasicGNN(nn.Module):
    """``norm='batch_norm'`` is flax's default ``BatchNorm``
    (:class:`~..norm.RunningBatchNorm`, momentum 0.01 in torch's sense,
    eps 1e-5) over every row it is given, padded rows included, as in the
    JAX package; ``'layer_norm'`` is flax's default ``LayerNorm`` (eps
    1e-6). ``module.train()`` uses and updates the batch statistics (the
    JAX package's ``deterministic=False``), ``module.eval()`` the running
    ones."""
    supports_edge_weight = False
    supports_edge_attr = False

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_layers: int, out_channels: Optional[int] = None,
                 dropout: float = 0.0, act: Callable = F.relu,
                 norm: Optional[str] = None, jk: Optional[str] = None,
                 conv_kwargs: Optional[Dict[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm not in (None, 'batch_norm', 'layer_norm'):
            raise ValueError(f'unknown norm {norm!r}')
        if jk not in (None, 'last', 'cat', 'max'):
            raise ValueError(f'unknown jk {jk!r}')
        device = resolve_device(device)
        self.hidden_channels = hidden_channels
        self.num_layers = num_layers
        self.out_channels = out_channels
        self.dropout = dropout
        self.act = act
        self.norm = norm
        self.jk = jk
        self.conv_kwargs = conv_kwargs or {}
        # whether the final conv already outputs out_channels (no jk, no
        # post-projection)
        self._final_in_loop = out_channels is not None and jk is None
        convs = []
        ch_in = in_channels
        for i in range(num_layers):
            is_last = i == num_layers - 1
            ch = (out_channels if is_last and self._final_in_loop
                  else hidden_channels)
            convs.append(self.init_conv(ch_in, ch, i, device, generator))
            ch_in = ch
        self.convs = nn.ModuleList(convs)
        # norm/act/dropout are skipped on the last layer when jk is None
        n_norms = num_layers - (1 if jk is None else 0)
        if norm == 'batch_norm':
            self.norms = nn.ModuleList(
                RunningBatchNorm(hidden_channels, device=device)
                for _ in range(n_norms))
        elif norm == 'layer_norm':
            self.norms = nn.ModuleList(
                nn.LayerNorm(hidden_channels, eps=1e-6, device=device)
                for _ in range(n_norms))
        else:
            self.norms = None
        self.lin_out = None
        if out_channels is not None and not self._final_in_loop:
            width = (hidden_channels * num_layers if jk == 'cat'
                     else hidden_channels)
            self.lin_out = linear(width, out_channels, device=device,
                                  generator=generator)

    def init_conv(self, in_channels: int, out_channels: int, idx: int,
                  device, generator) -> nn.Module:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_attr: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xs = []
        for i, conv in enumerate(self.convs):
            kwargs = {}
            if self.supports_edge_weight and edge_weight is not None:
                kwargs['edge_weight'] = edge_weight
            if self.supports_edge_attr and edge_attr is not None:
                kwargs['edge_attr'] = edge_attr
            x = conv(x, edge_index, edge_mask=edge_mask, **kwargs)
            if i == self.num_layers - 1 and self.jk is None:
                xs.append(x)
                break
            if self.norms is not None:
                x = self.norms[i](x)
            x = self.act(x)
            x = F.dropout(x, self.dropout, training=self.training)
            xs.append(x)
        if self.jk == 'cat':
            x = torch.cat(xs, dim=-1)
        elif self.jk == 'max':
            x = torch.stack(xs, dim=0).amax(dim=0)
        if self.lin_out is not None:
            x = self.lin_out(x)
        return x


class GCN(BasicGNN):
    """Stack of GCNConv."""
    supports_edge_weight = True

    def init_conv(self, in_channels, out_channels, idx, device, generator):
        return GCNConv(in_channels, out_channels, **self.conv_kwargs,
                       device=device, generator=generator)


class GraphSAGE(BasicGNN):
    """Stack of SAGEConv."""

    def init_conv(self, in_channels, out_channels, idx, device, generator):
        return SAGEConv(in_channels, out_channels, **self.conv_kwargs,
                        device=device, generator=generator)


class GIN(BasicGNN):
    """Stack of GINConv with 2-layer MLPs ``[in, out, out]`` (plain last
    layer; BasicGNN's own norm/act run afterwards)."""

    def init_conv(self, in_channels, out_channels, idx, device, generator):
        mlp = MLP(in_channels, [out_channels, out_channels], act=self.act,
                  device=device, generator=generator)
        return GINConv(mlp, **self.conv_kwargs)


class GAT(BasicGNN):
    """Stack of GATConv, or GATv2Conv with ``v2=True``: hidden layers
    concatenate ``heads`` heads of ``hidden_channels // heads`` channels;
    the final layer averages its heads. The convs' attention dropout is
    ``dropout``; as in the JAX package, the model runs them
    deterministically."""
    supports_edge_attr = True

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_layers: int, out_channels: Optional[int] = None,
                 v2: bool = False, heads: int = 1, **kwargs):
        # read by init_conv, which BasicGNN.__init__ calls
        self.v2, self.heads = v2, heads
        super().__init__(in_channels, hidden_channels, num_layers,
                         out_channels, **kwargs)

    def init_conv(self, in_channels, out_channels, idx, device, generator):
        concat = not (idx == self.num_layers - 1 and self._final_in_loop)
        ch = out_channels // self.heads if concat else out_channels
        cls = GATv2Conv if self.v2 else GATConv
        return cls(in_channels, ch, heads=self.heads, concat=concat,
                   dropout=self.dropout, **self.conv_kwargs, device=device,
                   generator=generator)


class PNA(BasicGNN):
    """Stack of PNAConv; ``conv_kwargs`` carries PNAConv's options
    (aggregators, scalers, ``avg_deg_log``, ``towers``, ``edge_dim`` ...)."""
    supports_edge_attr = True

    def init_conv(self, in_channels, out_channels, idx, device, generator):
        return PNAConv(in_channels, out_channels, **self.conv_kwargs,
                       device=device, generator=generator)


class EdgeCNN(BasicGNN):
    """Stack of EdgeConv with 2-layer MLPs ``[2 * in, out, out]`` (plain
    last layer)."""

    def init_conv(self, in_channels, out_channels, idx, device, generator):
        mlp = MLP(2 * in_channels, [out_channels, out_channels],
                  act=self.act, device=device, generator=generator)
        return EdgeConv(mlp, **self.conv_kwargs)


def basic_gnn_inference(model: BasicGNN, data, batch_size: int = 256,
                        num_neighbors_per_layer: int = 64,
                        edge_weight=None) -> torch.Tensor:
    """Layer-wise full-graph inference (reference ``basic_gnn.py:302-383``):
    each layer's representation of ALL nodes is computed before the next
    layer, sampling only 1-hop neighbourhoods per batch, which avoids the
    exponential fan-out of full L-hop sampling. Requires ``jk=None`` and
    ``norm in (None, 'layer_norm')``; returns ``[N, C]`` on the model's
    device.

    The JAX package's ``basic_gnn_inference(model, params, data, ...)``
    with the same sampling and the same results; the port's model holds its
    parameters. Where the JAX package joins each batch's features on the
    host, the port keeps ``x_all`` on the model's device: the loader yields
    structure only (``filter_features=False``), each batch gathers its rows
    by ``n_id`` there and builds its ``EdgeIndex`` there
    (``loader/scan_train.py::batch_edge_index``; a SAGE or GCN layer then
    runs the segment-sum kernel on the card), and each batch's seed rows go
    into the layer's output there. ``edge_weight`` ([E], full-graph
    weights such as cached GCN norms) is gathered per batch by ``e_id``.
    One loader serves every layer, its generator re-seeded before each, so
    every layer samples what the JAX package's fresh loader of seed 0
    samples."""
    import numpy as np
    from ...data import Data
    from ...data.data import as_tensor
    from ...loader import NeighborLoader
    from ...loader.scan_train import batch_edge_index

    if model.jk is not None:
        raise ValueError('basic_gnn_inference needs jk=None (got '
                         f'{model.jk!r})')
    if model.norm not in (None, 'layer_norm'):
        raise ValueError("basic_gnn_inference needs norm in (None, "
                         f"'layer_norm') (got {model.norm!r})")
    device = next(model.parameters()).device
    n = data.num_nodes
    x_all = data.x.to(device, torch.float32)
    w_all = None if edge_weight is None else as_tensor(edge_weight).to(
        device)
    loader = NeighborLoader(Data(edge_index=data.edge_index, num_nodes=n),
                            num_neighbors=[num_neighbors_per_layer],
                            batch_size=batch_size, shuffle=False,
                            filter_features=False)
    with torch.inference_mode():
        for layer, conv in enumerate(model.convs):
            is_last = layer == model.num_layers - 1
            loader.rng = np.random.default_rng(0)
            out = None
            for i, b in enumerate(loader):
                node_mask = b.node_mask.to(device)
                n_id = torch.where(node_mask, b.n_id.to(device), 0).long()
                edge_mask = b.edge_mask.to(device)
                x = torch.where(node_mask[:, None], x_all[n_id], 0.0)
                ei = batch_edge_index(b.edge_index.to(device), edge_mask,
                                      node_mask.shape[0])
                kwargs = {}
                if w_all is not None:
                    e_id = torch.where(edge_mask, b.e_id.to(device), 0)
                    kwargs['edge_weight'] = torch.where(
                        edge_mask, w_all[e_id.long()], 0)
                h = conv(x, ei, **kwargs)
                if not (is_last and model._final_in_loop):
                    if model.norms is not None:
                        h = model.norms[layer](h)
                    h = model.act(h)
                if out is None:
                    out = h.new_empty((n, h.shape[1]))
                start = i * batch_size
                bs = int(b.batch_size)
                out[start:start + bs] = h[:bs]
            x_all = out
    return x_all
