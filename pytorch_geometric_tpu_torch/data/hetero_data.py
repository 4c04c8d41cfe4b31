"""HeteroData: the typed graph container.

Counterpart of ``pytorch_geometric_tpu/data/hetero_data.py`` (reference
``torch_geometric/data/hetero_data.py:43``): typed node stores keyed by the
node type's string, typed edge stores keyed by ``(src, rel, dst)`` tuples,
``metadata()`` as ``(node_types, edge_types)``, a global store for
graph-level attributes, and ``to_homogeneous`` with the JAX package's type
offsets and ``node_type`` / ``edge_type`` vectors.

As with :class:`~.data.Data`, a value is stored where it lies: a tensor
stays on its device and is not copied; anything else becomes a host tensor
with ``jnp.asarray``'s dtype (:func:`.data.as_tensor`); an
:class:`EdgeIndex` is kept as it is. The JAX class is a pytree; this one is
a plain container.
"""

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .data import Data, _store_value, host
from ..edge_index import EdgeIndex

EdgeType = Tuple[str, str, str]


class _Store:
    """Attribute-dict view over a dict (node or edge store)."""

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, '_d', data)

    def __getattr__(self, key):
        d = object.__getattribute__(self, '_d')
        if key in d:
            return d[key]
        if key == 'num_nodes':
            x = d.get('x')
            return None if x is None else int(x.shape[0])
        if key == 'num_edges':
            ei = d.get('edge_index')
            if ei is None:
                return 0
            coo = ei.coo if isinstance(ei, EdgeIndex) else ei
            return int(coo.shape[1])
        return None

    def __setattr__(self, key, value):
        object.__getattribute__(self, '_d')[key] = _store_value(value)

    def __contains__(self, key):
        return key in object.__getattribute__(self, '_d')

    def get(self, key, default=None):
        return object.__getattribute__(self, '_d').get(key, default)

    def keys(self):
        return object.__getattribute__(self, '_d').keys()

    def items(self):
        return object.__getattribute__(self, '_d').items()


class HeteroData:
    """Typed graph: ``data['paper'].x``, ``data['paper', 'cites',
    'paper'].edge_index``.

    Usage mirrors the reference::

        data = HeteroData()
        data['paper'].x = x
        data['paper', 'cites', 'paper'].edge_index = ei
        data.metadata()  ->  (['paper'], [('paper', 'cites', 'paper')])
    """

    def __init__(self):
        object.__setattr__(self, '_node', {})
        object.__setattr__(self, '_edge', {})
        object.__setattr__(self, '_global', {})

    # graph-level attributes (``data.y = ...``) live in a global store, so
    # they take part in collation (reference ``hetero_data.py`` BaseStorage)
    def __setattr__(self, key, value):
        if key.startswith('_'):
            object.__setattr__(self, key, value)
        else:
            self._global[key] = value

    def __getattr__(self, key):
        if key.startswith('_'):
            raise AttributeError(key)
        g = object.__getattribute__(self, '_global')
        if key in g:
            return g[key]
        raise AttributeError(key)

    # -- store access -------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, str):
            return _Store(self._node.setdefault(key, {}))
        key = tuple(key)
        if len(key) == 2:
            key = (key[0], 'to', key[1])
        return _Store(self._edge.setdefault(key, {}))

    @property
    def node_types(self) -> List[str]:
        return list(self._node.keys())

    @property
    def edge_types(self) -> List[EdgeType]:
        return list(self._edge.keys())

    def metadata(self) -> Tuple[List[str], List[EdgeType]]:
        return self.node_types, self.edge_types

    @property
    def x_dict(self) -> Dict[str, torch.Tensor]:
        return {t: s.get('x') for t, s in self._node.items() if 'x' in s}

    @property
    def edge_index_dict(self) -> Dict[EdgeType, Any]:
        return {t: s.get('edge_index') for t, s in self._edge.items()
                if 'edge_index' in s}

    def collect(self, key: str) -> Dict:
        out = {}
        for t, s in self._node.items():
            if key in s:
                out[t] = s[key]
        for t, s in self._edge.items():
            if key in s:
                out[t] = s[key]
        return out

    def num_nodes_dict(self) -> Dict[str, int]:
        return {t: _Store(s).num_nodes for t, s in self._node.items()}

    # -- conversions (reference hetero_data.py:to_homogeneous) ---------------
    def to_homogeneous(self, node_attrs=('x',), add_node_type: bool = True,
                       add_edge_type: bool = True) -> Data:
        """One graph: node types stacked in ``node_types`` order (each
        type's ids offset by the counts before it), edge types in
        ``edge_types`` order, ``x`` concatenated when every type has one
        of one width, ``node_type`` / ``edge_type`` the type index of each
        node and edge (int32)."""
        ntypes = self.node_types
        offsets, cursor = {}, 0
        xs, tvec = [], []
        for i, t in enumerate(ntypes):
            n = _Store(self._node[t]).num_nodes
            offsets[t] = cursor
            cursor += n
            if 'x' in self._node[t]:
                xs.append(self._node[t]['x'])
            tvec.append(np.full(n, i, np.int32))
        coos, evec = [], []
        for j, (src, rel, dst) in enumerate(self.edge_types):
            coo = host(self._edge[(src, rel, dst)]['edge_index'])
            coos.append(coo + np.array([[offsets[src]], [offsets[dst]]]))
            evec.append(np.full(coo.shape[1], j, np.int32))
        kwargs = {}
        # features only when every type has them, of one width (the
        # reference skips mismatched attributes)
        if (xs and len(xs) == len(ntypes)
                and len({int(x.shape[-1]) for x in xs}) == 1):
            kwargs['x'] = torch.cat([_store_value(x) for x in xs], 0)
        if add_node_type:
            kwargs['node_type'] = np.concatenate(tvec)
        if add_edge_type and evec:
            kwargs['edge_type'] = np.concatenate(evec)
        ei = np.concatenate(coos, 1) if coos else None
        return Data(edge_index=ei, num_nodes=cursor, **kwargs)
