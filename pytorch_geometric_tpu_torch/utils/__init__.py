from .loop import add_remaining_self_loops, add_self_loops, maybe_num_nodes
from .reorder import (apply_node_permutation, block_fill_stats,
                      degree_order, reverse_cuthill_mckee)

__all__ = ['add_remaining_self_loops', 'add_self_loops',
           'apply_node_permutation', 'block_fill_stats', 'degree_order',
           'maybe_num_nodes', 'reverse_cuthill_mckee']
