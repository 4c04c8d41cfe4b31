from .message_passing import MessagePassing
from . import conv
from . import dense
from . import models
from .conv import (GATConv, GATv2Conv, GCNConv, cache_gcn_norm, gcn_norm,
                   SAGEConv, GINConv, GraphConv, ClusterGCNConv, RGCNConv,
                   FastRGCNConv, HeteroConv, HGTConv, HANConv)
from .dense import HeteroDictLinear, HeteroLinear, Linear
from .models import MLP, BasicGNN, GAT, GCN, GraphSAGE, GIN
from .to_hetero import (ToHetero, to_fixed_size, to_hetero,
                        to_hetero_with_bases)

__all__ = ['MessagePassing', 'conv', 'dense', 'models', 'GCNConv',
           'cache_gcn_norm', 'gcn_norm', 'SAGEConv', 'GINConv', 'GATConv',
           'GATv2Conv', 'GraphConv', 'ClusterGCNConv', 'RGCNConv',
           'FastRGCNConv', 'HeteroConv', 'HGTConv', 'HANConv', 'Linear',
           'HeteroLinear', 'HeteroDictLinear', 'MLP', 'BasicGNN', 'GAT',
           'GCN', 'GraphSAGE', 'GIN', 'ToHetero', 'to_hetero',
           'to_hetero_with_bases', 'to_fixed_size']
