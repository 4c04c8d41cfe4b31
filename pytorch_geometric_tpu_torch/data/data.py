"""Data: the homogeneous graph container.

Counterpart of ``pytorch_geometric_tpu/data/data.py``: named tensors plus
static sizes (``num_nodes``), with the same batching rules as conventions on
key names (the reference's defaults, ``torch_geometric/data/data.py:114-127``):

  * keys containing 'index' or named 'adj' increment by num_nodes and
    concatenate on the edge dim;
  * 'face' increments by num_nodes, concatenated on dim 1;
  * everything else concatenates on dim 0 with no increment.

Where the JAX package puts every value on the device (``jnp.asarray``), the
port stores tensors where they are: a tensor stays on its device and is not
copied, so a feature table on the card is not moved back to the host, nor a
host table to the card. Anything else (numpy arrays, lists, scalars) becomes
a host tensor with the dtype ``jnp.asarray`` gives it, 64-bit types narrowed
to 32 bits as JAX does by default (:func:`as_tensor`). ``edge_index`` may be
an :class:`EdgeIndex`, kept as it is.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..edge_index import EdgeIndex

# jnp.asarray's dtypes with 64-bit types off (JAX's default)
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32,
           np.dtype(np.complex128): np.complex64}


def as_tensor(value) -> torch.Tensor:
    """``value`` as a tensor: a tensor as it is (same device, no copy);
    anything else through numpy as a host tensor, its 64-bit dtype narrowed
    to 32 bits as ``jnp.asarray`` narrows it."""
    if isinstance(value, torch.Tensor):
        return value
    a = np.asarray(value)
    if a.dtype in _NARROW:
        a = a.astype(_NARROW[a.dtype])
    elif not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a)


def host(value) -> np.ndarray:
    """``value`` (a tensor on any device, an ``EdgeIndex``'s COO, or an
    array) as a numpy array."""
    if isinstance(value, EdgeIndex):
        value = value.coo
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _store_value(value):
    """What the store keeps for ``value``: an ``EdgeIndex`` as it is, an
    array-like as a tensor (:func:`as_tensor`), anything else (a string, an
    object) as it is."""
    if isinstance(value, (EdgeIndex, torch.Tensor)):
        return value
    try:
        return as_tensor(value)
    except (TypeError, ValueError, RuntimeError):
        return value


class Data:
    """A graph: named tensors + static sizes.

    Usage mirrors the reference::

        data = Data(x=x, edge_index=edge_index, y=y, num_nodes=N)
        data.x, data.edge_index, data.num_nodes
        data = data.replace(x=new_x)
    """

    def __init__(self, x=None, edge_index=None, edge_attr=None, y=None,
                 pos=None, num_nodes: Optional[int] = None, **kwargs):
        store: Dict[str, Any] = {}
        for key, value in (('x', x), ('edge_index', edge_index),
                           ('edge_attr', edge_attr), ('y', y), ('pos', pos),
                           *kwargs.items()):
            if value is not None:
                store[key] = _store_value(value)
        self._store = store
        self._num_nodes = num_nodes

    # -- attribute access ----------------------------------------------------
    def __getattr__(self, key: str):
        if key.startswith('_'):
            raise AttributeError(key)
        return object.__getattribute__(self, '_store').get(key)

    def __setattr__(self, key: str, value):
        # private fields and properties (num_nodes) use normal attribute
        # mechanics; everything else lands in the store, so batching and
        # __getitem__ see it
        if key.startswith('_') or isinstance(
                getattr(type(self), key, None), property):
            object.__setattr__(self, key, value)
            return
        store = object.__getattribute__(self, '_store')
        if value is None:
            store.pop(key, None)
        else:
            store[key] = _store_value(value)

    def __getitem__(self, key: str):
        return self._store.get(key)

    def __setitem__(self, key: str, value):
        setattr(self, key, value)

    def __delitem__(self, key: str):
        self._store.pop(key, None)

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def keys(self):
        return list(self._store.keys())

    def items(self):
        return self._store.items()

    def replace(self, **kwargs) -> 'Data':
        """Functional update (returns a new Data of the same fields)."""
        new = dict(self._store)
        num_nodes = kwargs.pop('num_nodes', self._num_nodes)
        for k, v in kwargs.items():
            if v is None:
                new.pop(k, None)
            elif isinstance(v, EdgeIndex) or hasattr(v, 'dtype'):
                new[k] = _store_value(v)
            else:
                new[k] = v
        obj = object.__new__(Data)
        obj._store = new
        obj._num_nodes = num_nodes
        return obj

    def to(self, device, non_blocking: bool = False) -> 'Data':
        """A copy of the same class and sizes with every tensor on
        ``device``; other values are shared. An ``EdgeIndex`` raises: its
        caches are built on their device, so rebuild it there
        (``EdgeIndex(ei.coo.to(device), ei.sparse_size).fill_cache()``)."""
        new = {}
        for k, v in self._store.items():
            if isinstance(v, EdgeIndex):
                raise TypeError(f'{k!r} is an EdgeIndex; rebuild it on '
                                f'{device}')
            new[k] = (v.to(device, non_blocking=non_blocking)
                      if isinstance(v, torch.Tensor) else v)
        obj = object.__new__(type(self))
        obj.__dict__.update(self.__dict__)
        obj._store = new
        return obj

    # -- sizes (reference data.py:170 num_nodes inference) -------------------
    @property
    def num_nodes(self) -> Optional[int]:
        if self._num_nodes is not None:
            return self._num_nodes
        for key in ('x', 'pos'):
            v = self._store.get(key)
            if v is not None:
                return int(v.shape[0])
        ei = self._store.get('edge_index')
        if isinstance(ei, EdgeIndex):
            return ei.num_src_nodes
        if ei is not None and ei.numel():
            return int(ei.max()) + 1
        return None

    @num_nodes.setter
    def num_nodes(self, value):
        self._num_nodes = None if value is None else int(value)

    @property
    def num_edges(self) -> int:
        ei = self._store.get('edge_index')
        if ei is None:
            return 0
        if isinstance(ei, EdgeIndex):
            return ei.num_edges
        return int(ei.shape[1])

    @property
    def num_node_features(self) -> int:
        x = self._store.get('x')
        return 0 if x is None or x.dim() < 2 else int(x.shape[-1])

    num_features = num_node_features

    @property
    def num_edge_features(self) -> int:
        ea = self._store.get('edge_attr')
        return 0 if ea is None or ea.dim() < 2 else int(ea.shape[-1])

    def __repr__(self):
        parts = []
        for k, v in sorted(self._store.items()):
            if hasattr(v, 'shape'):
                parts.append(f"{k}={list(v.shape)}")
            else:
                parts.append(f"{k}={v}")
        return f"{type(self).__name__}({', '.join(parts)})"

    # -- batching rules (reference data.py:114-127) ---------------------------
    @staticmethod
    def cat_dim(key: str, value) -> int:
        if isinstance(value, EdgeIndex) or 'index' in key or key == 'face':
            return 1 if (getattr(value, 'ndim', 2) == 2
                         or isinstance(value, EdgeIndex)) else 0
        return 0

    def inc(self, key: str, value) -> int:
        if isinstance(value, EdgeIndex) or 'index' in key or key == 'face':
            return self.num_nodes or 0
        return 0
