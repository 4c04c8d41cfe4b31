from .message_passing import MessagePassing
from . import aggr
from . import conv
from . import dense
from . import models
from . import norm
from . import pool
from .conv import (GATConv, GATv2Conv, GCNConv, cache_gcn_norm, gcn_norm,
                   SAGEConv, GINConv, GINEConv, GraphConv, ClusterGCNConv,
                   RGCNConv, FastRGCNConv, HeteroConv, HGTConv, HANConv,
                   GENConv, FiLMConv, PDNConv, GeneralConv, PNAConv, EGConv,
                   EdgeConv)
from .dense import HeteroDictLinear, HeteroLinear, Linear
from .models import MLP, BasicGNN, GAT, GCN, GraphSAGE, GIN, PNA, EdgeCNN
from .norm import BatchNorm
from .pool import global_add_pool, global_max_pool, global_mean_pool
from .to_hetero import (ToHetero, to_fixed_size, to_hetero,
                        to_hetero_with_bases)

__all__ = ['MessagePassing', 'aggr', 'conv', 'dense', 'models', 'norm',
           'pool', 'GCNConv', 'cache_gcn_norm', 'gcn_norm', 'SAGEConv',
           'GINConv', 'GINEConv', 'GATConv', 'GATv2Conv', 'GraphConv',
           'ClusterGCNConv', 'RGCNConv', 'FastRGCNConv', 'HeteroConv',
           'HGTConv', 'HANConv', 'GENConv', 'FiLMConv', 'PDNConv',
           'GeneralConv', 'PNAConv', 'EGConv', 'EdgeConv', 'Linear',
           'HeteroLinear', 'HeteroDictLinear', 'MLP', 'BasicGNN', 'GAT',
           'GCN', 'GraphSAGE', 'GIN', 'PNA', 'EdgeCNN', 'BatchNorm',
           'global_add_pool', 'global_mean_pool', 'global_max_pool',
           'ToHetero', 'to_hetero', 'to_hetero_with_bases', 'to_fixed_size']
