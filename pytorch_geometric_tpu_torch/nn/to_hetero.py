"""to_hetero: duplicate a homogeneous GNN per edge type.

Counterpart of ``pytorch_geometric_tpu/nn/to_hetero.py`` (reference
``torch_geometric/nn/to_hetero_transformer.py:123`` rewrites the fx graph,
duplicating each MessagePassing module per edge type and grouping
per-destination outputs; ``to_hetero_module.py`` is the module-level
variant). As in the JAX package this is the module-level design: each
MessagePassing layer becomes a :class:`HeteroConv` over the metadata's edge
types (``layer_{i}``), and any other callable applies per node type.
"""

import copy
from typing import Any, Sequence, Tuple

import torch
from torch import nn

from .conv.hetero_conv import HeteroConv
from .message_passing import MessagePassing

EdgeType = Tuple[str, str, str]


def _copies(layer: nn.Module, n: int):
    """``n`` copies of ``layer`` with parameters of their own (each starts
    from the template's values)."""
    return [copy.deepcopy(layer) for _ in range(n)]


class ToHetero(nn.Module):
    """Heterogeneous wrapper of a stack of homogeneous layers.

    ``layers``: a MessagePassing conv is copied per edge type into a
    :class:`HeteroConv` (parameters of its own per edge type, like the
    reference), any other callable (an activation, a parameter-free
    function) applies per node type; a callable that is an ``nn.Module`` is
    registered as ``layer_{i}``, shared by every type. As in the JAX
    package, a node type that no edge type reaches drops out after a
    conv layer."""

    def __init__(self, layers: Sequence[Any],
                 metadata: Tuple[Sequence[str], Sequence[EdgeType]],
                 aggr: str = 'sum'):
        super().__init__()
        node_types, edge_types = metadata
        self.metadata = (tuple(node_types),
                         tuple(tuple(et) for et in edge_types))
        self.aggr = aggr
        self._calls = []
        for i, layer in enumerate(layers):
            if isinstance(layer, MessagePassing):
                ets = self.metadata[1]
                layer = HeteroConv(dict(zip(ets, _copies(layer, len(ets)))),
                                   aggr=aggr)
            if isinstance(layer, nn.Module):
                self.add_module(f'layer_{i}', layer)
            self._calls.append((isinstance(layer, HeteroConv), layer))

    def forward(self, x_dict, edge_index_dict, **kwargs):
        for is_conv, layer in self._calls:
            if is_conv:
                x_dict = layer(x_dict, edge_index_dict)
            else:
                x_dict = {t: layer(v) for t, v in x_dict.items()}
        return x_dict


def to_hetero(module_or_layers, metadata, aggr: str = 'sum') -> ToHetero:
    """(reference ``to_hetero_transformer.py:to_hetero``)."""
    layers = (list(module_or_layers)
              if isinstance(module_or_layers, (list, tuple))
              else [module_or_layers])
    return ToHetero(layers, metadata, aggr=aggr)


class ToHeteroWithBases(nn.Module):
    """Basis-decomposition hetero transform (reference
    ``nn/to_hetero_with_bases_transformer.py``): each edge type mixes
    ``num_bases`` shared copies of the conv (``basis_{b}``) with learned
    per-type coefficients (``basis_coef [R, B]``)."""

    def __init__(self, module: nn.Module, metadata, num_bases: int,
                 generator=None):
        super().__init__()
        node_types, edge_types = metadata
        self.node_types = tuple(node_types)
        self.edge_types = tuple(tuple(et) for et in edge_types)
        self.num_bases = num_bases
        for b, basis in enumerate(_copies(module, num_bases)):
            self.add_module(f'basis_{b}', basis)
        # flax's normal(1 / num_bases): the standard deviation
        dev = next((p.device for p in module.parameters()), None)
        coef = torch.randn(len(self.edge_types), num_bases,
                           generator=generator) / num_bases
        self.basis_coef = nn.Parameter(coef.to(dev))

    def forward(self, x_dict, edge_index_dict, **kw):
        out = {t: 0.0 for t in self.node_types}
        cnt = {t: 0 for t in self.node_types}
        bases = [getattr(self, f'basis_{b}') for b in range(self.num_bases)]
        for r, et in enumerate(self.edge_types):
            src_t, _, dst_t = et
            ei = edge_index_dict[et]
            pair = (x_dict[src_t], x_dict[dst_t])
            acc = 0.0
            for b, basis in enumerate(bases):
                acc = acc + self.basis_coef[r, b] * basis(pair, ei, **kw)
            out[dst_t] = out[dst_t] + acc
            cnt[dst_t] += 1
        return {t: out[t] for t in self.node_types if cnt[t] > 0}


def to_hetero_with_bases(module, metadata, num_bases: int,
                         in_channels=None, **kwargs) -> ToHeteroWithBases:
    """(reference ``to_hetero_with_bases_transformer.py``); ``in_channels``
    is accepted for the reference's signature, as in the JAX package."""
    return ToHeteroWithBases(module, metadata, num_bases,
                             generator=kwargs.get('generator'))


class FixedSize(nn.Module):
    """``module`` with its ``batch_size`` keyword pinned."""

    def __init__(self, module: nn.Module, batch_size: int):
        super().__init__()
        self.module = module
        self.batch_size = batch_size

    def forward(self, *args, **kwargs):
        kwargs.setdefault('batch_size', self.batch_size)
        return self.module(*args, **kwargs)


def to_fixed_size(module, batch_size: int) -> FixedSize:
    """(reference ``nn/to_fixed_size_transformer.py:13``): pin the global
    pool's batch size. The port's shapes are static throughout, so the
    wrapper just passes ``batch_size``."""
    return FixedSize(module, batch_size)
