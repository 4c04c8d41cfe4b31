"""Dense layers. Counterpart of ``pytorch_geometric_tpu/nn/dense``:
``Linear``, ``HeteroLinear`` and ``HeteroDictLinear``, the dense convs and
the dense pools."""

from .linear import HeteroDictLinear, HeteroLinear, Linear
from .dense_conv import (DenseGATConv, DenseGCNConv, DenseGINConv,
                         DenseGraphConv, DenseSAGEConv)
from .dense_pool import (DMoNPooling, dense_diff_pool, dense_dmon_pool,
                         dense_mincut_pool)

__all__ = [
    'Linear', 'HeteroLinear', 'HeteroDictLinear',
    'DenseGCNConv', 'DenseSAGEConv', 'DenseGINConv', 'DenseGraphConv',
    'DenseGATConv',
    'dense_diff_pool', 'dense_mincut_pool', 'dense_dmon_pool', 'DMoNPooling',
]
