"""Dense layers. Counterpart of ``pytorch_geometric_tpu/nn/dense``:
``Linear``, ``HeteroLinear`` and ``HeteroDictLinear`` so far."""

from .linear import HeteroDictLinear, HeteroLinear, Linear

__all__ = ['Linear', 'HeteroLinear', 'HeteroDictLinear']
