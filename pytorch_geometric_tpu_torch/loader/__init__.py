"""Loaders. Counterpart of ``pytorch_geometric_tpu/loader``: the neighbour
loaders, the graph-list DataLoader, prefetching and caching, and the scan
pair. ``cluster``, ``graph_saint``, ``ibmb``, ``list_loader``, ``temporal``
and ``legacy`` are ROADMAP Queue 1, item 8; the heterogeneous loader goes
with item 9."""

from .dataloader import Collater, DataLoader
from .neighbor_loader import LinkNeighborLoader, NeighborLoader
from .prefetch import CachedLoader, PrefetchLoader
from .scan_train import make_device_train_step, stack_batches

__all__ = ['Collater', 'DataLoader', 'NeighborLoader', 'LinkNeighborLoader',
           'PrefetchLoader', 'CachedLoader', 'stack_batches',
           'make_device_train_step']
