from .mlp import MLP
from .basic_gnn import (BasicGNN, GAT, GCN, GraphSAGE, GIN,
                        basic_gnn_inference)
from .node2vec import random_walk

__all__ = ['MLP', 'BasicGNN', 'GAT', 'GCN', 'GraphSAGE', 'GIN',
           'basic_gnn_inference', 'random_walk']
