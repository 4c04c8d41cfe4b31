from .loop import add_remaining_self_loops, add_self_loops, maybe_num_nodes
from .reorder import (apply_node_permutation, block_fill_stats,
                      cluster_order, degree_order, reverse_cuthill_mckee)
from .extra import ppr

# the reference's name
get_ppr = ppr

__all__ = ['add_remaining_self_loops', 'add_self_loops',
           'apply_node_permutation', 'block_fill_stats', 'cluster_order',
           'degree_order', 'get_ppr', 'maybe_num_nodes', 'ppr',
           'reverse_cuthill_mckee']
