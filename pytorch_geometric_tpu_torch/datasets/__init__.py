"""Datasets. Counterpart of ``pytorch_geometric_tpu/datasets``: only what
is ported, ``FakeDataset``, ``planetoid_like`` and ``TUDataset``, so far."""

from .fake import FakeDataset, planetoid_like
from .tu_dataset import TUDataset

__all__ = ['FakeDataset', 'planetoid_like', 'TUDataset']
