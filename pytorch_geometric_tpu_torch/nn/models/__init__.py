from .mlp import MLP
from .basic_gnn import (BasicGNN, EdgeCNN, GAT, GCN, GraphSAGE, GIN, PNA,
                        basic_gnn_inference)
from .node2vec import random_walk

__all__ = ['MLP', 'BasicGNN', 'GAT', 'GCN', 'GraphSAGE', 'GIN', 'PNA',
           'EdgeCNN',
           'basic_gnn_inference', 'random_walk']
