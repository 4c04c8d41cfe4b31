"""Graph containers and data plumbing. Counterpart of
``pytorch_geometric_tpu/data``: ``Data``, ``Batch``, ``HeteroData``,
``HeteroBatch``, ``TemporalData``, ``HypergraphData``, ``Dataset`` and
``InMemoryDataset``; the feature and graph stores, ``summary``, the
databases and ``OnDiskDataset``, the pipeline adapters, the data modules,
and the download and extract helpers."""

from .data import Data
from .batch import Batch
from .hetero_data import HeteroData
from .hetero_batch import HeteroBatch
from .temporal import TemporalData
from .hypergraph import HypergraphData
from .dataset import Dataset, InMemoryDataset
from .summary import Summary, Stats, summary
from .database import (Database, SQLiteDatabase, RocksDatabase,
                       OnDiskDataset, TensorInfo)
from .download import download_url, download_google_url, makedirs
from .extract import extract_tar, extract_zip, extract_bz2, extract_gz
from .stores import (FeatureStore, GraphStore, InMemoryFeatureStore,
                     InMemoryGraphStore, TensorAttr, EdgeAttr, EdgeLayout)
from .datapipes import DatasetAdapter, Batcher, functional_transform
from .lightning import (LightningDataModule, LightningDataset,
                        LightningNodeData, LightningLinkData)

__all__ = ['LightningDataModule', 'LightningDataset', 'LightningNodeData',
           'LightningLinkData', 'DatasetAdapter', 'Batcher',
           'functional_transform', 'HeteroBatch', 'Data', 'Batch',
           'HeteroData', 'Dataset', 'InMemoryDataset', 'FeatureStore',
           'GraphStore', 'InMemoryFeatureStore', 'InMemoryGraphStore',
           'TensorAttr', 'EdgeAttr', 'EdgeLayout', 'Database',
           'SQLiteDatabase', 'RocksDatabase', 'OnDiskDataset', 'TensorInfo',
           'TemporalData', 'download_url', 'download_google_url',
           'makedirs', 'extract_tar', 'extract_zip', 'extract_bz2',
           'extract_gz', 'Summary', 'Stats', 'summary', 'HypergraphData']

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
