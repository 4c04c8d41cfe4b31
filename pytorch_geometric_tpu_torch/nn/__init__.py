from .message_passing import MessagePassing
from . import aggr
from . import attention
from . import conv
from . import dense
from . import models
from . import norm
from . import pool
from .conv import (GATConv, GATv2Conv, GCNConv, cache_gcn_norm, gcn_norm,
                   SAGEConv, GINConv, GINEConv, GraphConv, ResGatedGraphConv,
                   GatedGraphConv, LEConv, MFConv, FAConv, AGNNConv,
                   ClusterGCNConv, WLConvContinuous, LGConv, ChebConv,
                   ARMAConv, SGConv, SSGConv, TAGConv, APPNP, MixHopConv,
                   TransformerConv, RGCNConv, FastRGCNConv, HeteroConv,
                   HGTConv, HANConv, GENConv, FiLMConv, PDNConv, GeneralConv,
                   PNAConv, EGConv, SignedConv, DirGNNConv,
                   AntiSymmetricConv, HypergraphConv, WLConv, EdgeConv,
                   GPSConv, RGATConv, SuperGATConv, HEATConv, PointNetConv,
                   DynamicEdgeConv, PPFConv, PointTransformerConv,
                   GravNetConv, GMMConv, SplineConv, NNConv, CGConv,
                   FeaStConv, DNAConv, PANConv, XConv)
from .unpool import knn_interpolate
from .encoding import PositionalEncoding, TemporalEncoding
from .dense import HeteroDictLinear, HeteroLinear, Linear
from .models import MLP, BasicGNN, GAT, GCN, GraphSAGE, GIN, PNA, EdgeCNN
from .norm import BatchNorm
from .pool import (global_add_pool, global_max_pool, global_mean_pool,
                   TopKPooling, SAGPooling, knn, knn_graph, radius,
                   radius_graph, fps, nearest, voxel_grid)
from .to_hetero import (ToHetero, to_fixed_size, to_hetero,
                        to_hetero_with_bases)

__all__ = ['MessagePassing', 'aggr', 'attention', 'conv', 'dense',
           'models', 'norm', 'pool', 'GPSConv', 'RGATConv', 'SuperGATConv',
           'HEATConv', 'PositionalEncoding', 'TemporalEncoding', 'GCNConv',
           'cache_gcn_norm', 'gcn_norm', 'SAGEConv',
           'GINConv', 'GINEConv', 'GATConv', 'GATv2Conv', 'GraphConv',
           'ClusterGCNConv', 'RGCNConv', 'FastRGCNConv', 'HeteroConv',
           'HGTConv', 'HANConv', 'GENConv', 'FiLMConv', 'PDNConv',
           'GeneralConv', 'PNAConv', 'EGConv', 'EdgeConv', 'Linear',
           'HeteroLinear', 'HeteroDictLinear', 'MLP', 'BasicGNN', 'GAT',
           'GCN', 'GraphSAGE', 'GIN', 'PNA', 'EdgeCNN', 'BatchNorm',
           'global_add_pool', 'global_mean_pool', 'global_max_pool',
           'ToHetero', 'to_hetero', 'to_hetero_with_bases', 'to_fixed_size',
           'PointNetConv', 'DynamicEdgeConv', 'PPFConv',
           'PointTransformerConv', 'GravNetConv', 'GMMConv', 'SplineConv',
           'NNConv', 'CGConv', 'FeaStConv', 'DNAConv', 'PANConv', 'XConv',
           'knn_interpolate', 'TopKPooling', 'SAGPooling', 'knn',
           'knn_graph', 'radius', 'radius_graph', 'fps', 'nearest',
           'voxel_grid', 'ResGatedGraphConv', 'GatedGraphConv', 'LEConv',
           'MFConv', 'FAConv', 'AGNNConv', 'WLConvContinuous', 'LGConv',
           'ChebConv', 'ARMAConv', 'SGConv', 'SSGConv', 'TAGConv', 'APPNP',
           'MixHopConv', 'TransformerConv', 'SignedConv', 'DirGNNConv',
           'AntiSymmetricConv', 'HypergraphConv', 'WLConv']

# pool, norm, dense and aggr re-exported at the top, as the reference and
# the JAX package do (reference nn/__init__.py:15-16)
from .pool import *          # noqa: F401,F403,E402
from .norm import *          # noqa: F401,F403,E402
from .dense import *         # noqa: F401,F403,E402
from .aggr import *          # noqa: F401,F403,E402
from . import pool as _pool, norm as _norm, dense as _dense, aggr as _aggr
for _m in (_pool, _norm, _dense, _aggr):
    for _n in _m.__all__:
        if _n not in __all__:
            __all__.append(_n)
del _m, _n, _pool, _norm, _dense, _aggr
