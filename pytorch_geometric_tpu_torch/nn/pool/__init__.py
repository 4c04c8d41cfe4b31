from .glob import (avg_pool_neighbor_x, global_add_pool, global_max_pool,
                   global_mean_pool, max_pool_neighbor_x)

__all__ = ['global_add_pool', 'global_mean_pool', 'global_max_pool',
           'avg_pool_neighbor_x', 'max_pool_neighbor_x']
