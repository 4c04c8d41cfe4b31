"""Sampler layer dataclasses.

Counterpart of ``pytorch_geometric_tpu/sampler/base.py`` (reference
``torch_geometric/sampler/base.py``), host-side numpy as there.
``SamplerOutput`` (reference ``base.py:168``) is padded to static budgets
with explicit masks, so every minibatch has one shape (one captured graph).
Budgets derive from ``NumNeighbors`` (batch_size x cumprod(fanouts)).
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class NodeSamplerInput:
    """Seed nodes for one minibatch (reference ``base.py:54``)."""
    node: np.ndarray
    input_id: Optional[np.ndarray] = None
    time: Optional[np.ndarray] = None


@dataclass
class EdgeSamplerInput:
    """Seed edges (+labels) for link prediction (reference ``base.py:103``)."""
    row: np.ndarray
    col: np.ndarray
    label: Optional[np.ndarray] = None
    input_id: Optional[np.ndarray] = None
    time: Optional[np.ndarray] = None


@dataclass
class SamplerOutput:
    """Padded, statically-shaped sampling result (reference ``base.py:168``).

    node: [N_cap] global node ids (0 where invalid — check node_mask)
    row/col: [E_cap] LOCAL edge endpoints (dump row N_cap where invalid)
    edge: [E_cap] global edge positions (for edge-feature gather)
    node_mask / edge_mask: validity masks
    num_sampled_nodes / num_sampled_edges: per-hop real counts
    batch_size: number of (real) seed nodes, seeds come first in `node`
    """
    node: np.ndarray
    row: np.ndarray
    col: np.ndarray
    edge: np.ndarray
    node_mask: np.ndarray
    edge_mask: np.ndarray
    num_sampled_nodes: List[int]
    num_sampled_edges: List[int]
    batch_size: int
    seed_mask: Optional[np.ndarray] = None
    metadata: Optional[dict] = None
    # disjoint mode: seed-subtree index of each local node ([N_cap];
    # reference base.py:188 ``batch``)
    batch: Optional[np.ndarray] = None

    @property
    def num_nodes_cap(self) -> int:
        return len(self.node)


@dataclass
class NumNeighbors:
    """Per-hop fanouts (reference ``base.py:699``)."""
    values: Sequence[int]

    def __post_init__(self):
        self.values = list(self.values)

    @property
    def num_hops(self) -> int:
        return len(self.values)

    def node_budget(self, batch_size: int) -> List[int]:
        """Static per-hop node capacity (seeds first)."""
        caps = [batch_size]
        for f in self.values:
            caps.append(caps[-1] * f)
        return caps

    def edge_budget(self, batch_size: int) -> List[int]:
        caps = self.node_budget(batch_size)
        return [caps[i] * f for i, f in enumerate(self.values)]


@dataclass
class NegativeSampling:
    """binary | triplet negative sampling config (reference ``base.py:849``)."""
    mode: str = 'binary'
    amount: float = 1.0

    def is_binary(self) -> bool:
        return self.mode == 'binary'

    def is_triplet(self) -> bool:
        return self.mode == 'triplet'


class BaseSampler:
    """Abstract sampler (reference ``base.py:932``)."""

    def sample_from_nodes(self, inputs: NodeSamplerInput) -> SamplerOutput:
        raise NotImplementedError

    def sample_from_edges(self, inputs: EdgeSamplerInput,
                          neg_sampling: Optional[NegativeSampling] = None
                          ) -> SamplerOutput:
        raise NotImplementedError
