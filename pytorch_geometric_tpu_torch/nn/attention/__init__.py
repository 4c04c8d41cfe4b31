"""Linear and learned-query attention. Counterpart of
``pytorch_geometric_tpu/nn/attention``; ``MultiHeadDotProductAttention`` is
flax's module, which the JAX package's ``GPSConv`` and ``QFormer`` call."""

from .mha import MultiHeadDotProductAttention
from .performer import PerformerAttention
from .sgformer import SGFormerAttention
from .polynormer import PolynormerAttention
from .qformer import QFormer

__all__ = ['PerformerAttention', 'SGFormerAttention',
           'PolynormerAttention', 'QFormer', 'MultiHeadDotProductAttention']
