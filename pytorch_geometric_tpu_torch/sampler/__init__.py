"""Samplers. Counterpart of ``pytorch_geometric_tpu/sampler``; the
homogeneous samplers so far (``hetero.py`` goes with ROADMAP Queue 1, item
9)."""

from .base import (BaseSampler, NodeSamplerInput, EdgeSamplerInput,
                   SamplerOutput, NumNeighbors, NegativeSampling)
from .neighbor_sampler import BidirectionalNeighborSampler, NeighborSampler

__all__ = [
    'BidirectionalNeighborSampler',
    'BaseSampler', 'NodeSamplerInput', 'EdgeSamplerInput', 'SamplerOutput',
    'NumNeighbors', 'NegativeSampling', 'NeighborSampler',
]
