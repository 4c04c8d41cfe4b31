"""FeatureStore / GraphStore abstractions.

Counterpart of ``pytorch_geometric_tpu/data/stores.py`` (reference
``torch_geometric/data/feature_store.py:260`` with ``TensorAttr`` ``:46``,
and ``graph_store.py:101`` with ``EdgeAttr`` ``:53`` and ``EdgeLayout``
``:46``). They back remote or partitioned storage; the in-memory versions
double as the reference's test mocks (``testing/feature_store.py``,
``graph_store.py``). Where the JAX package keeps numpy arrays, the port
keeps tensors where they are: a feature table put on the card is read back
on the card, and the layout conversions run on the device of the stored
edges. Anything else becomes a host tensor of its numpy dtype, not
narrowed, as the JAX package's ``np.asarray`` keeps it.
"""

from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.array(value))


def _index(index, device):
    return _tensor(index).to(device).long()


@dataclass(frozen=True)
class TensorAttr:
    """(reference ``feature_store.py:46``)."""
    group_name: Optional[str] = None
    attr_name: Optional[str] = None
    index: Any = None

    def is_fully_specified(self) -> bool:
        return self.group_name is not None and self.attr_name is not None


class FeatureStore:
    """Abstract key-value tensor store (reference ``feature_store.py:260``).
    """

    def _put_tensor(self, tensor, attr: TensorAttr) -> bool:
        raise NotImplementedError

    def _get_tensor(self, attr: TensorAttr):
        raise NotImplementedError

    def _remove_tensor(self, attr: TensorAttr) -> bool:
        raise NotImplementedError

    # -- public API ---------------------------------------------------------
    def put_tensor(self, tensor, group_name=None, attr_name=None,
                   index=None) -> bool:
        return self._put_tensor(_tensor(tensor),
                                TensorAttr(group_name, attr_name, index))

    def get_tensor(self, group_name=None, attr_name=None, index=None):
        out = self._get_tensor(TensorAttr(group_name, attr_name, index))
        if out is None:
            raise KeyError((group_name, attr_name))
        return out

    def multi_get_tensor(self, attrs: List[TensorAttr]):
        return [self.get_tensor(a.group_name, a.attr_name, a.index)
                for a in attrs]

    def remove_tensor(self, group_name=None, attr_name=None) -> bool:
        return self._remove_tensor(TensorAttr(group_name, attr_name))

    def get_all_tensor_attrs(self) -> List[TensorAttr]:
        raise NotImplementedError

    def __getitem__(self, key: Tuple[str, str]):
        return self.get_tensor(*key)

    def __setitem__(self, key: Tuple[str, str], value):
        self.put_tensor(value, *key)


class InMemoryFeatureStore(FeatureStore):
    """Dict-backed store (reference ``testing/feature_store.py``): a put
    with an ``index`` writes those rows of the stored tensor in place."""

    def __init__(self):
        self._store: Dict[Tuple[str, str], torch.Tensor] = {}

    def _put_tensor(self, tensor, attr):
        key = (attr.group_name, attr.attr_name)
        if attr.index is not None:
            out = self._store[key]
            out[_index(attr.index, out.device)] = tensor.to(out.device)
        else:
            self._store[key] = tensor
        return True

    def _get_tensor(self, attr):
        out = self._store.get((attr.group_name, attr.attr_name))
        if out is not None and attr.index is not None:
            return out[_index(attr.index, out.device)]
        return out

    def _remove_tensor(self, attr):
        return self._store.pop((attr.group_name, attr.attr_name),
                               None) is not None

    def get_all_tensor_attrs(self):
        return [TensorAttr(g, a) for (g, a) in self._store]


class EdgeLayout(Enum):
    """(reference ``graph_store.py:46``)."""
    COO = 'coo'
    CSR = 'csr'
    CSC = 'csc'


@dataclass(frozen=True)
class EdgeAttr:
    """(reference ``graph_store.py:53``)."""
    edge_type: Any
    layout: EdgeLayout = EdgeLayout.COO
    is_sorted: bool = False
    size: Optional[Tuple[int, int]] = None


class GraphStore:
    """Abstract edge store (reference ``graph_store.py:101``)."""

    def _put_edge_index(self, edge_index, attr: EdgeAttr) -> bool:
        raise NotImplementedError

    def _get_edge_index(self, attr: EdgeAttr):
        raise NotImplementedError

    def put_edge_index(self, edge_index, edge_type, layout=EdgeLayout.COO,
                       is_sorted=False, size=None) -> bool:
        if isinstance(layout, str):
            layout = EdgeLayout(layout)
        return self._put_edge_index(
            edge_index, EdgeAttr(edge_type, layout, is_sorted, size))

    def get_edge_index(self, edge_type, layout=EdgeLayout.COO):
        if isinstance(layout, str):
            layout = EdgeLayout(layout)
        out = self._get_edge_index(EdgeAttr(edge_type, layout))
        if out is None:
            raise KeyError((edge_type, layout))
        return out

    def get_all_edge_attrs(self) -> List[EdgeAttr]:
        raise NotImplementedError

    # layout conversions (reference graph_store.py coo() / csr() / csc())
    def coo(self, edge_type):
        return self.get_edge_index(edge_type, EdgeLayout.COO)

    def _compressed(self, edge_type, key: int):
        """``(ptr, the other endpoint in key order, the stable order)``
        with ``key`` the row (0, CSR) or the column (1, CSC)."""
        coo = self.coo(edge_type)
        k, other = coo[key], coo[1 - key]
        order = torch.sort(k, stable=True).indices
        n = int(k.max()) + 1 if k.numel() else 0
        ptr = torch.searchsorted(k[order].contiguous(),
                                 torch.arange(n + 1, device=k.device,
                                              dtype=k.dtype))
        return ptr, other[order], order

    def csc(self, edge_type):
        return self._compressed(edge_type, 1)

    def csr(self, edge_type):
        return self._compressed(edge_type, 0)


class InMemoryGraphStore(GraphStore):
    """(reference ``testing/graph_store.py``): one edge tensor an edge
    type, read back in its stored layout."""

    def __init__(self):
        self._store: Dict[Any, Tuple[torch.Tensor, EdgeAttr]] = {}

    def _put_edge_index(self, edge_index, attr):
        self._store[attr.edge_type] = (_tensor(edge_index), attr)
        return True

    def _get_edge_index(self, attr):
        got = self._store.get(attr.edge_type)
        if got is None:
            return None
        ei, stored = got
        if (attr.layout == EdgeLayout.COO
                and stored.layout != EdgeLayout.COO):
            raise NotImplementedError
        return ei

    def get_all_edge_attrs(self):
        return [attr for (_, attr) in self._store.values()]
