from ..message_passing import MessagePassing
from .gcn_conv import GCNConv, cache_gcn_norm, gcn_norm
from .sage_conv import SAGEConv
from .gin_conv import GINConv, GINEConv
from .gat_conv import CuGraphGATConv, FusedGATConv, GATConv, GATv2Conv
from .graph_conv import ClusterGCNConv, GraphConv
from .transformer_conv import TransformerConv
from .supergat_conv import SuperGATConv
from .rgcn_conv import FastRGCNConv, RGCNConv
from .hetero_conv import HANConv, HeteroConv, HGTConv
from .gen_conv import (EGConv, FiLMConv, GENConv, GeneralConv, PDNConv,
                       PNAConv)
from .point_conv import EdgeConv

__all__ = ['MessagePassing', 'GCNConv', 'cache_gcn_norm', 'gcn_norm',
           'SAGEConv', 'GINConv', 'GINEConv', 'GATConv', 'GATv2Conv', 'FusedGATConv',
           'CuGraphGATConv', 'GraphConv', 'ClusterGCNConv',
           'TransformerConv', 'SuperGATConv', 'RGCNConv', 'FastRGCNConv',
           'HeteroConv', 'HGTConv', 'HANConv', 'GENConv', 'FiLMConv',
           'PDNConv', 'GeneralConv', 'PNAConv', 'EGConv', 'EdgeConv']
