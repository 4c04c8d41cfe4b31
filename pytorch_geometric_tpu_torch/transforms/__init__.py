"""Graph transforms. Counterpart of ``pytorch_geometric_tpu/transforms``:
``base.py`` and ``features.py`` (the feature transforms and the positional
encodings) are ported; the rest of that package is not yet."""

from .base import BaseTransform, Compose
from .features import (AddLaplacianEigenvectorPE, AddRandomWalkPE, Constant,
                       FeaturePropagation, LocalDegreeProfile,
                       NormalizeFeatures, OneHotDegree, SVDFeatureReduction,
                       TargetIndegree)

__all__ = ['BaseTransform', 'Compose', 'NormalizeFeatures',
           'SVDFeatureReduction', 'Constant', 'OneHotDegree',
           'TargetIndegree', 'LocalDegreeProfile',
           'AddLaplacianEigenvectorPE', 'AddRandomWalkPE',
           'FeaturePropagation']
