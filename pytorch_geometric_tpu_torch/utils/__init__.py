from .loop import add_remaining_self_loops, add_self_loops, maybe_num_nodes
from .reorder import degree_order

__all__ = ['add_remaining_self_loops', 'add_self_loops', 'degree_order',
           'maybe_num_nodes']
