from .mlp import MLP
from .basic_gnn import BasicGNN, GAT, GCN, GraphSAGE, GIN

__all__ = ['MLP', 'BasicGNN', 'GAT', 'GCN', 'GraphSAGE', 'GIN']
