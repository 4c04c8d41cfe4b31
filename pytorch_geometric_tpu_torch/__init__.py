"""pytorch_geometric_tpu_torch — the PyTorch and CUDA port of
``pytorch_geometric_tpu``.

It keeps the JAX package's module paths and public names. Plain tensor code
is PyTorch; every TPU kernel of the JAX package becomes a kernel written by
hand for NVIDIA Hopper (``csrc/``), with a plain PyTorch version beside it
that serves CPU tensors and the tests. Entry points run on the card unless
the caller passes ``device='cpu'`` (see :mod:`.backend`).

This package imports ``torch`` and ``numpy`` only: nothing of JAX, flax or
the JAX package.
"""

__version__ = '0.1.0'

from . import backend
from .backend import default_device
from .edge_index import (CSR, EdgeIndex, WindowedCSC, build_windowed_csc,
                         from_numpy_coo)

__all__ = ['backend', 'default_device', 'CSR', 'EdgeIndex', 'WindowedCSC',
           'build_windowed_csc', 'from_numpy_coo']
