from .gat_fused import gat_aggregate, gat_mix, gat_mix_plain
from .scatter import scatter
from .segment import ptr2index, index2ptr
from .segment_max import segment_max_blocked, segment_max_plain
from .segment_spmm import segment_spmm, segment_spmm_plain
from .softmax import softmax
from .spmm import spmm, spmm_regime

__all__ = ['gat_aggregate', 'gat_mix', 'gat_mix_plain', 'scatter',
           'ptr2index', 'index2ptr', 'segment_max_blocked',
           'segment_max_plain', 'segment_spmm', 'segment_spmm_plain',
           'softmax', 'spmm', 'spmm_regime']
