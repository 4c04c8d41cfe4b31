from .glob import (avg_pool_neighbor_x, global_add_pool, global_max_pool,
                   global_mean_pool, max_pool_neighbor_x)
from .select import SelectOutput, SelectTopK, select_topk, filter_edges
from .topk_pool import TopKPooling, SAGPooling, PANPooling, PoolOutput
from .knn_index import (KNNIndex, KNNOutput, L2KNNIndex, MIPSKNNIndex,
                        ApproxL2KNNIndex, ApproxMIPSKNNIndex)
from .point import (knn, knn_graph, radius, radius_graph, fps, nearest,
                    voxel_grid, approx_knn, approx_knn_graph,
                    decimation_indices)
from .cluster_pool import (ASAPooling, ClusterPooling, EdgePooling,
                           MemPooling, avg_pool, avg_pool_x, graclus,
                           max_pool, max_pool_x)

__all__ = ['global_add_pool', 'global_mean_pool', 'global_max_pool',
           'avg_pool_neighbor_x', 'max_pool_neighbor_x',
           'SelectOutput', 'SelectTopK', 'select_topk', 'filter_edges',
           'TopKPooling', 'SAGPooling', 'PANPooling', 'PoolOutput',
           'knn', 'knn_graph', 'radius', 'radius_graph', 'fps', 'nearest',
           'voxel_grid', 'approx_knn', 'approx_knn_graph',
           'decimation_indices', 'KNNIndex', 'KNNOutput', 'L2KNNIndex',
           'MIPSKNNIndex', 'ApproxL2KNNIndex', 'ApproxMIPSKNNIndex',
           'ClusterPooling', 'graclus', 'avg_pool', 'max_pool', 'avg_pool_x', 'max_pool_x',
           'EdgePooling', 'ASAPooling', 'MemPooling']
