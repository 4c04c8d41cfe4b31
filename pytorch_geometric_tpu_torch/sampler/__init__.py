"""Samplers. Counterpart of ``pytorch_geometric_tpu/sampler``: the
homogeneous samplers and the heterogeneous ones (``hetero.py``)."""

from .base import (BaseSampler, NodeSamplerInput, EdgeSamplerInput,
                   SamplerOutput, NumNeighbors, NegativeSampling)
from .hetero import HeteroNeighborSampler, HeteroSamplerOutput, HGTSampler
from .neighbor_sampler import BidirectionalNeighborSampler, NeighborSampler

__all__ = [
    'BidirectionalNeighborSampler',
    'BaseSampler', 'NodeSamplerInput', 'EdgeSamplerInput', 'SamplerOutput',
    'NumNeighbors', 'NegativeSampling', 'NeighborSampler',
    'HeteroNeighborSampler', 'HeteroSamplerOutput', 'HGTSampler',
]
