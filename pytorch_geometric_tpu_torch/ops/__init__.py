from .edge_dot import edge_dot, edge_dot_plain
from .edge_attention import (FlashLayout, build_hgt_flash_layouts,
                             build_union_flash_layout)
from .gat_fused import gat_aggregate, gat_mix, gat_mix_plain
from .grouped import (RaggedLayout, TypedLayout, build_ragged_layout,
                      build_typed_layout, grouped_matmul, typed_matmul)
from .sddmm import (edge_softmax, edge_softmax_aggregate,
                    multi_relation_softmax_aggregate, sddmm)
from .sampled import (sampled_add, sampled_div, sampled_mul, sampled_op,
                      sampled_sub)
from .scatter import group_argsort, scatter, scatter_argmax
from .segment import index2ptr, ptr2index, segment, segment_logsumexp
from .segment_max import segment_max_blocked, segment_max_plain
from .segment_spmm import segment_spmm, segment_spmm_plain
from .softmax import softmax
from .spmm import auto_dense_cap, spmm, spmm_regime

__all__ = ['FlashLayout', 'build_hgt_flash_layouts',
           'build_union_flash_layout', 'RaggedLayout', 'TypedLayout',
           'build_ragged_layout', 'build_typed_layout', 'grouped_matmul',
           'typed_matmul', 'gat_aggregate', 'gat_mix', 'gat_mix_plain', 'edge_dot',
           'edge_dot_plain', 'edge_softmax', 'edge_softmax_aggregate',
           'multi_relation_softmax_aggregate', 'sddmm', 'scatter',
           'scatter_argmax', 'group_argsort', 'ptr2index', 'index2ptr',
           'segment', 'segment_logsumexp', 'sampled_op', 'sampled_add',
           'sampled_sub', 'sampled_mul', 'sampled_div',
           'segment_max_blocked', 'segment_max_plain', 'segment_spmm',
           'segment_spmm_plain', 'softmax', 'spmm', 'spmm_regime',
           'auto_dense_cap']
