from ..message_passing import MessagePassing
from .gcn_conv import GCNConv, cache_gcn_norm, gcn_norm
from .sage_conv import SAGEConv
from .gin_conv import GINConv, GINEConv
from .gat_conv import CuGraphGATConv, FusedGATConv, GATConv, GATv2Conv
from .graph_conv import (GraphConv, ResGatedGraphConv, GatedGraphConv,
                         LEConv, MFConv, FAConv, AGNNConv, ClusterGCNConv,
                         WLConvContinuous, LGConv)
from .spectral_conv import (ChebConv, ARMAConv, SGConv, SSGConv, TAGConv,
                            APPNP, MixHopConv)
from .transformer_conv import TransformerConv
from .supergat_conv import SuperGATConv
from .rgcn_conv import FastRGCNConv, RGCNConv
from .hetero_conv import HANConv, HeteroConv, HGTConv
from .gen_conv import (EGConv, FiLMConv, GENConv, GeneralConv, PDNConv,
                       PNAConv)
from .point_conv import (PointNetConv, EdgeConv, DynamicEdgeConv, PPFConv,
                         PointTransformerConv, GravNetConv)
from .gps_conv import GPSConv, HEATConv, RGATConv
from .misc_conv import (SignedConv, DirGNNConv, AntiSymmetricConv,
                        HypergraphConv, WLConv, MeshCNNConv, SimpleConv,
                        GCN2Conv, PointGNNConv)
from .kernel_conv import GMMConv, SplineConv, NNConv, CGConv, FeaStConv
from .dna_conv import DNAConv, PANConv
from .x_conv import XConv

__all__ = ['MessagePassing', 'GCNConv', 'cache_gcn_norm', 'gcn_norm',
           'SAGEConv', 'GINConv', 'GINEConv', 'GATConv', 'GATv2Conv', 'FusedGATConv',
           'CuGraphGATConv', 'GraphConv', 'ClusterGCNConv',
           'TransformerConv', 'SuperGATConv', 'RGCNConv', 'FastRGCNConv',
           'HeteroConv', 'HGTConv', 'HANConv', 'GENConv', 'FiLMConv',
           'PDNConv', 'GeneralConv', 'PNAConv', 'EGConv', 'EdgeConv',
           'GPSConv', 'RGATConv', 'HEATConv', 'ResGatedGraphConv',
           'GatedGraphConv', 'LEConv', 'MFConv', 'FAConv', 'AGNNConv',
           'WLConvContinuous', 'LGConv', 'ChebConv', 'ARMAConv', 'SGConv',
           'SSGConv', 'TAGConv', 'APPNP', 'MixHopConv', 'SignedConv',
           'DirGNNConv', 'AntiSymmetricConv', 'HypergraphConv', 'WLConv',
           'MeshCNNConv', 'SimpleConv', 'GCN2Conv', 'PointGNNConv',
           'DNAConv', 'PANConv', 'PointNetConv', 'DynamicEdgeConv',
           'PPFConv', 'PointTransformerConv', 'GravNetConv', 'GMMConv',
           'SplineConv', 'NNConv', 'CGConv', 'FeaStConv', 'XConv']
