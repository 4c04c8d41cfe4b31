from .mlp import MLP
from .basic_gnn import (BasicGNN, GAT, GCN, GraphSAGE, GIN,
                        basic_gnn_inference)

__all__ = ['MLP', 'BasicGNN', 'GAT', 'GCN', 'GraphSAGE', 'GIN',
           'basic_gnn_inference']
