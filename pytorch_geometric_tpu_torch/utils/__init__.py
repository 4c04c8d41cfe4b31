from .coalesce import (coalesce, contains_isolated_nodes, is_undirected,
                       remove_isolated_nodes, sort_edge_index, to_undirected)
from .core import (cumsum, degree, index_sort, lexsort, one_hot,
                   scatter_normalize)
from .dense import dense_to_sparse, to_dense_adj, to_dense_batch
from .loop import add_remaining_self_loops, add_self_loops, maybe_num_nodes
from .reorder import (apply_node_permutation, block_fill_stats,
                      cluster_order, degree_order, reverse_cuthill_mckee)
from .extra import ppr
# the reduction substrate at utils level, as the reference's
# torch_geometric/utils/__init__.py and the JAX package export it
from ..ops import (group_argsort, index2ptr, ptr2index, scatter,
                   scatter_argmax, segment, segment_logsumexp, softmax, spmm)

# the reference's name
get_ppr = ppr

__all__ = ['add_remaining_self_loops', 'add_self_loops', 'coalesce',
           'contains_isolated_nodes', 'is_undirected',
           'remove_isolated_nodes', 'sort_edge_index', 'to_undirected',
           'apply_node_permutation', 'block_fill_stats', 'cluster_order',
           'cumsum', 'degree', 'degree_order', 'dense_to_sparse', 'get_ppr',
           'index_sort', 'lexsort', 'maybe_num_nodes', 'one_hot', 'ppr',
           'reverse_cuthill_mckee', 'scatter_normalize', 'to_dense_adj',
           'to_dense_batch', 'scatter', 'scatter_argmax', 'group_argsort',
           'segment', 'segment_logsumexp', 'ptr2index', 'index2ptr',
           'softmax', 'spmm']
