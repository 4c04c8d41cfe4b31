from .norms import (BatchNorm, DiffGroupNorm, GraphNorm, GraphSizeNorm,
                    HeteroBatchNorm, HeteroLayerNorm, InstanceNorm, LayerNorm,
                    MeanSubtractionNorm, MsgNorm, PairNorm, RunningBatchNorm)

__all__ = [
    'BatchNorm', 'InstanceNorm', 'LayerNorm', 'GraphNorm', 'GraphSizeNorm',
    'PairNorm', 'MeanSubtractionNorm', 'MsgNorm', 'DiffGroupNorm',
    'HeteroBatchNorm', 'HeteroLayerNorm', 'RunningBatchNorm',
]

MessageNorm = MsgNorm  # the reference's name (norm/msg_norm.py)
__all__.append('MessageNorm')
