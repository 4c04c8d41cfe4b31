"""Host-side (numpy) graph restructuring utilities.

Counterpart of ``pytorch_geometric_tpu/utils/coalesce.py`` (reference
``torch_geometric/utils/_coalesce.py``, ``undirected.py``,
``sort_edge_index.py``, ``isolated.py``). Utilities that change the number
of edges run on the host during data preparation, as in the JAX package:
the same numpy arithmetic, so every result is bitwise the JAX package's.
They take numpy arrays, tensors on any device or an ``EdgeIndex`` (its
COO) and return numpy arrays.
"""

from typing import Optional, Tuple

import numpy as np

from ..data.data import host


def sort_edge_index(edge_index, edge_attr=None, sort_by_row: bool = True):
    """Sort edges lexicographically (reference
    ``utils/sort_edge_index.py``)."""
    e = host(edge_index)
    keys = (e[1], e[0]) if sort_by_row else (e[0], e[1])
    perm = np.lexsort(keys)
    out = e[:, perm]
    if edge_attr is None:
        return out
    return out, host(edge_attr)[perm]


def coalesce(edge_index, edge_attr=None, num_nodes: Optional[int] = None,
             reduce: str = 'sum'):
    """Sort + deduplicate edges, reducing duplicate attributes
    (reference ``utils/_coalesce.py``); ``edge_attr`` may be one array or
    a list of them."""
    e = host(edge_index)
    if num_nodes is None:
        num_nodes = int(e.max()) + 1 if e.size else 0
    key = e[0].astype(np.int64) * num_nodes + e[1]
    order = np.argsort(key, kind='stable')
    key_sorted = key[order]
    uniq_mask = np.ones(len(key_sorted), bool)
    uniq_mask[1:] = key_sorted[1:] != key_sorted[:-1]
    out = e[:, order][:, uniq_mask]
    if edge_attr is None:
        return out
    seg = np.cumsum(uniq_mask) - 1
    if isinstance(edge_attr, (list, tuple)):
        return out, [_reduce_attr(host(a)[order], seg, uniq_mask, reduce)
                     for a in edge_attr]
    return out, _reduce_attr(host(edge_attr)[order], seg, uniq_mask, reduce)


def _reduce_attr(attr, seg, uniq_mask, reduce):
    n_out = int(uniq_mask.sum())
    if reduce in ('sum', 'add'):
        red = np.zeros((n_out,) + attr.shape[1:], attr.dtype)
        np.add.at(red, seg, attr)
    elif reduce == 'mean':
        red = np.zeros((n_out,) + attr.shape[1:], np.float64)
        np.add.at(red, seg, attr)
        cnt = np.bincount(seg, minlength=n_out)
        red = (red / cnt.reshape((-1,) + (1,) * (attr.ndim - 1))
               ).astype(attr.dtype)
    elif reduce == 'min':
        red = np.full((n_out,) + attr.shape[1:],
                      np.finfo(attr.dtype).max if attr.dtype.kind == 'f'
                      else np.iinfo(attr.dtype).max, attr.dtype)
        np.minimum.at(red, seg, attr)
    elif reduce == 'max':
        red = np.full((n_out,) + attr.shape[1:],
                      np.finfo(attr.dtype).min if attr.dtype.kind == 'f'
                      else np.iinfo(attr.dtype).min, attr.dtype)
        np.maximum.at(red, seg, attr)
    else:
        raise ValueError(f"Unknown reduce '{reduce}'")
    return red


def to_undirected(edge_index, edge_attr=None,
                  num_nodes: Optional[int] = None, reduce: str = 'sum'):
    """Symmetrise the graph (reference ``utils/undirected.py``).
    ``edge_attr`` may be a single array or a list of arrays."""
    e = host(edge_index)
    both = np.concatenate([e, e[::-1]], axis=1)
    if edge_attr is not None:
        if isinstance(edge_attr, (list, tuple)):
            edge_attr = [np.concatenate([host(a)] * 2, axis=0)
                         for a in edge_attr]
        else:
            edge_attr = np.concatenate([host(edge_attr)] * 2, axis=0)
    return coalesce(both, edge_attr, num_nodes, reduce)


def is_undirected(edge_index, num_nodes: Optional[int] = None) -> bool:
    e = coalesce(host(edge_index), None, num_nodes)
    et = coalesce(e[::-1], None, num_nodes)
    return e.shape == et.shape and bool(np.all(e == et))


def contains_isolated_nodes(edge_index, num_nodes: int) -> bool:
    e = host(edge_index)
    return bool(len(np.unique(e)) < num_nodes)


def remove_isolated_nodes(edge_index, num_nodes: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Relabel away isolated nodes (reference ``utils/isolated.py``).
    Returns (edge_index, node_mask, relabel_map).

    Reference semantics: isolation is decided from non-loop edges (a node
    with only self loops is isolated); surviving nodes keep at most their
    last self loop, re-appended after the non-loop edges."""
    e = host(edge_index)
    loop = e[0] == e[1]
    plain = e[:, ~loop]
    mask = np.zeros(num_nodes, bool)
    mask[plain.reshape(-1)] = True
    new_id = np.cumsum(mask) - 1
    # last self loop per surviving node, in node order
    loop_e = e[:, loop]
    last = np.full(num_nodes, -1, np.int64)
    last[loop_e[0]] = np.arange(loop_e.shape[1])
    keep = last[mask]
    keep = keep[keep >= 0]
    loops = loop_e[:, keep]
    out = np.concatenate([new_id[plain], new_id[loops]], axis=1)
    return out, mask, new_id
