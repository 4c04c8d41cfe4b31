"""pytorch_geometric_tpu_torch — the PyTorch and CUDA port of
``pytorch_geometric_tpu``.

It keeps the JAX package's module paths and public names. Plain tensor code
is PyTorch; every TPU kernel of the JAX package becomes a kernel written by
hand for NVIDIA Hopper (``csrc/``), with a plain PyTorch version beside it
that serves CPU tensors and the tests. Entry points run on the card unless
the caller passes ``device='cpu'`` (see :mod:`.backend`).

This package imports ``torch`` and ``numpy`` only: nothing of JAX, flax or
the JAX package. Importing it loads no ``triton`` and starts no CUDA
context: the kernels are built at their first launch (``csrc``).
"""

__version__ = '0.1.0'

from . import backend
from . import transforms
from .backend import default_device
from .edge_index import (CSR, EdgeIndex, WindowedCSC, build_windowed_csc,
                         from_numpy_coo)
from .data import Batch, Data, Dataset, HeteroData, InMemoryDataset
from .compat import compile, is_compiling, is_torch_instance
from .experimental import debug, is_debug_enabled, set_debug
from . import ops
from . import utils
from . import nn
from . import experimental
from . import sampler
from . import loader
from . import datasets
from . import io

__all__ = ['backend', 'transforms', 'default_device', 'CSR', 'EdgeIndex',
           'WindowedCSC', 'build_windowed_csc', 'from_numpy_coo', 'Data',
           'Batch', 'HeteroData', 'Dataset', 'InMemoryDataset', 'compile',
           'is_compiling', 'is_torch_instance', 'debug', 'is_debug_enabled',
           'set_debug', 'ops', 'utils', 'nn', 'experimental', 'sampler',
           'loader', 'datasets', 'io', '__version__']
