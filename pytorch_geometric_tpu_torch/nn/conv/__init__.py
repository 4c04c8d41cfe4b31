from ..message_passing import MessagePassing
from .gcn_conv import GCNConv, cache_gcn_norm, gcn_norm
from .sage_conv import SAGEConv
from .gin_conv import GINConv
from .gat_conv import CuGraphGATConv, FusedGATConv, GATConv, GATv2Conv

__all__ = ['MessagePassing', 'GCNConv', 'cache_gcn_norm', 'gcn_norm',
           'SAGEConv', 'GINConv', 'GATConv', 'GATv2Conv', 'FusedGATConv',
           'CuGraphGATConv']
