"""Graph containers. Counterpart of ``pytorch_geometric_tpu/data``:
``Data``, ``Batch``, ``HeteroData`` and ``HeteroBatch``."""

from .data import Data
from .batch import Batch
from .hetero_data import HeteroData
from .hetero_batch import HeteroBatch

__all__ = ['Data', 'Batch', 'HeteroData', 'HeteroBatch']
