from .base import Aggregation
from .basic import (MaxAggregation, MeanAggregation, MinAggregation,
                    MulAggregation, PowerMeanAggregation, SoftmaxAggregation,
                    StdAggregation, SumAggregation, VarAggregation,
                    VariancePreservingAggregation)
from .multi import (DegreeScalerAggregation, MultiAggregation,
                    aggregation_resolver)
from .attention import AttentionalAggregation, DeepSetsAggregation, Set2Set

__all__ = [
    'Aggregation', 'aggregation_resolver',
    'SumAggregation', 'MeanAggregation', 'MaxAggregation', 'MinAggregation',
    'MulAggregation', 'VarAggregation', 'StdAggregation',
    'SoftmaxAggregation', 'PowerMeanAggregation',
    'VariancePreservingAggregation',
    'MultiAggregation', 'DegreeScalerAggregation',
    'AttentionalAggregation', 'Set2Set', 'DeepSetsAggregation',
]
