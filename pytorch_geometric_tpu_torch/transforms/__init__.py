"""Graph transforms. Counterpart of ``pytorch_geometric_tpu/transforms``:
``base.py``, ``features.py`` (the feature transforms and the positional
encodings) and ``geometric.py`` (the point-cloud and mesh transforms) are
ported; the rest of that package is not yet."""

from .base import BaseTransform, Compose
from .features import (AddLaplacianEigenvectorPE, AddRandomWalkPE, Constant,
                       FeaturePropagation, LocalDegreeProfile,
                       NormalizeFeatures, OneHotDegree, SVDFeatureReduction,
                       TargetIndegree)
from .geometric import (Cartesian, Center, Distance, GridSampling, KNNGraph,
                        NormalizeScale, Polar, RadiusGraph, RandomFlip,
                        RandomJitter, RandomRotate, RandomScale, RandomShear,
                        SamplePoints, Spherical)

__all__ = ['BaseTransform', 'Compose', 'NormalizeFeatures',
           'SVDFeatureReduction', 'Constant', 'OneHotDegree',
           'TargetIndegree', 'LocalDegreeProfile',
           'AddLaplacianEigenvectorPE', 'AddRandomWalkPE',
           'FeaturePropagation', 'Center', 'NormalizeScale', 'KNNGraph',
           'RadiusGraph', 'Distance', 'Cartesian', 'Polar', 'Spherical',
           'RandomJitter', 'RandomFlip', 'RandomRotate', 'RandomScale',
           'RandomShear', 'SamplePoints', 'GridSampling']
