"""Loaders. Counterpart of ``pytorch_geometric_tpu/loader``: the neighbour
loaders (homogeneous and heterogeneous), Cluster-GCN's partitioner and
loaders, the GraphSAINT samplers, ShaDow and the small samplers, IBMB, the
list, temporal and legacy loaders, the graph-list DataLoader, prefetching
and caching, and the scan pair."""

from .dataloader import Collater, DataLoader
from .neighbor_loader import LinkNeighborLoader, NeighborLoader
from .cluster import ClusterData, ClusterLoader, Partition, partition_graph
from .hetero_loader import (HGTLoader, HeteroNeighborLoader,
                            batch_edge_index_dict)
from .temporal import TemporalDataLoader
from .ibmb import IBMBBatchLoader, IBMBNodeLoader
from .prefetch import CachedLoader, PrefetchLoader
from .scan_train import make_device_train_step, stack_batches
from .list_loader import (AffinityMixin, DataListLoader, DenseDataLoader,
                          LogMemoryMixin, MultithreadingMixin, ZipLoader)
from .graph_saint import (DynamicBatchSampler, GraphSAINTEdgeSampler,
                          GraphSAINTNodeSampler, GraphSAINTRandomWalkSampler,
                          GraphSAINTSampler, ImbalancedSampler,
                          RandomNodeLoader, ShaDowKHopSampler)
from .legacy import EdgeIndexAdj, NeighborSampler

# the reference's names for the base roles
NodeLoader = NeighborLoader
LinkLoader = LinkNeighborLoader

__all__ = ['Collater', 'DataLoader', 'NeighborLoader', 'LinkNeighborLoader',
           'HeteroNeighborLoader', 'HGTLoader', 'batch_edge_index_dict',
           'TemporalDataLoader', 'IBMBNodeLoader', 'IBMBBatchLoader',
           'PrefetchLoader', 'CachedLoader', 'DataListLoader',
           'stack_batches', 'make_device_train_step', 'DenseDataLoader',
           'ClusterData', 'ClusterLoader', 'partition_graph', 'Partition',
           'GraphSAINTSampler', 'GraphSAINTNodeSampler',
           'GraphSAINTEdgeSampler', 'GraphSAINTRandomWalkSampler',
           'ShaDowKHopSampler', 'RandomNodeLoader', 'ImbalancedSampler',
           'DynamicBatchSampler', 'NodeLoader', 'LinkLoader', 'ZipLoader',
           'AffinityMixin', 'MultithreadingMixin', 'LogMemoryMixin',
           'NeighborSampler', 'EdgeIndexAdj']
