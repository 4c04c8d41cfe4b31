"""Graph containers. Counterpart of ``pytorch_geometric_tpu/data``; ``Data``
and ``Batch`` so far (the heterogeneous containers go with ROADMAP Queue 1,
item 9)."""

from .data import Data
from .batch import Batch

__all__ = ['Data', 'Batch']
