from .message_passing import MessagePassing
from . import conv
from . import models
from .conv import (GATConv, GATv2Conv, GCNConv, cache_gcn_norm, gcn_norm,
                   SAGEConv, GINConv)
from .models import MLP, BasicGNN, GAT, GCN, GraphSAGE, GIN

__all__ = ['MessagePassing', 'conv', 'models', 'GCNConv', 'cache_gcn_norm',
           'gcn_norm', 'SAGEConv', 'GINConv', 'GATConv', 'GATv2Conv', 'MLP',
           'BasicGNN', 'GAT', 'GCN', 'GraphSAGE', 'GIN']
