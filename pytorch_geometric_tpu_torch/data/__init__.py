"""Graph containers. Counterpart of ``pytorch_geometric_tpu/data``:
``Data``, ``Batch``, ``HeteroData``, ``HeteroBatch``, ``TemporalData``,
``Dataset`` and ``InMemoryDataset``."""

from .data import Data
from .batch import Batch
from .hetero_data import HeteroData
from .hetero_batch import HeteroBatch
from .temporal import TemporalData
from .dataset import Dataset, InMemoryDataset

__all__ = ['Data', 'Batch', 'HeteroData', 'HeteroBatch', 'TemporalData',
           'Dataset', 'InMemoryDataset']

# Deprecated loader aliases the reference still re-exports from
# torch_geometric.data (data/__init__.py:60-73), resolved at first use:
# the loaders import this package
_LOADER_ALIASES = (
    'NeighborSampler', 'ClusterData', 'ClusterLoader', 'GraphSAINTSampler',
    'GraphSAINTNodeSampler', 'GraphSAINTEdgeSampler',
    'GraphSAINTRandomWalkSampler', 'ShaDowKHopSampler', 'RandomNodeLoader',
    'DataLoader', 'DataListLoader', 'DenseDataLoader')


def __getattr__(name):
    if name in _LOADER_ALIASES:
        from .. import loader
        return getattr(loader, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
