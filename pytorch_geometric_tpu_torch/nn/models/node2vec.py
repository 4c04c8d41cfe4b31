"""Random walks over a graph's out-edges.

Counterpart of the walk sampler of ``pytorch_geometric_tpu/nn/models/
node2vec.py`` (``_CSR`` and ``random_walk``; reference
``torch.ops.pyg.random_walk``), which GraphSAINT's random-walk sampler
(``loader/graph_saint.py``) draws from. The walks run in the port's build of
``csrc/sampler.cpp`` (``random_walk``) where it builds, else in numpy; each
path draws the walks the JAX package's path of the same kind draws from the
same generator. The ``Node2Vec`` model itself is ROADMAP Queue 1, item 11.
"""

import ctypes

import numpy as np

from ... import csrc
from ...data.data import host


class _CSR:
    """Out-neighbours per node: ``ptr [N + 1]`` and ``col [E]``, the edges
    in a stable sort by source."""

    def __init__(self, edge_index, num_nodes: int):
        coo = host(edge_index)
        order = np.argsort(coo[0], kind='stable')
        self.col = coo[1][order]
        self.ptr = np.searchsorted(coo[0][order],
                                   np.arange(num_nodes + 1))
        self.num_nodes = num_nodes

    def sample_neighbor(self, rng, nodes):
        deg = self.ptr[nodes + 1] - self.ptr[nodes]
        off = rng.integers(0, np.maximum(deg, 1))
        nbr = self.col[self.ptr[nodes] + np.minimum(off, deg - 1)]
        return np.where(deg > 0, nbr, nodes)   # dead end: stay


def _random_walk_native(lib, csr: _CSR, rng, start, walk_length, p, q):
    rowptr = np.ascontiguousarray(csr.ptr, np.int64)
    col = np.ascontiguousarray(csr.col, np.int64)
    start_c = np.ascontiguousarray(start, np.int64)
    out = np.zeros((len(start_c), walk_length + 1), np.int64)

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    lib.random_walk(p64(rowptr), p64(col), ctypes.c_int64(csr.num_nodes),
                    p64(start_c), ctypes.c_int64(len(start_c)),
                    ctypes.c_int64(walk_length), ctypes.c_double(p),
                    ctypes.c_double(q),
                    ctypes.c_uint64(int(rng.integers(0, 2 ** 62))),
                    p64(out))
    return out


def random_walk(rng: np.random.Generator, edge_index, num_nodes: int,
                start: np.ndarray, walk_length: int,
                p: float = 1.0, q: float = 1.0) -> np.ndarray:
    """``[S, walk_length + 1]`` node2vec walks from the ``S`` nodes of
    ``start`` (a dead end stays put; ``p`` / ``q`` bias the steps by
    rejection sampling, three tries a step). Runs natively where
    ``csrc.WITH_NATIVE_SAMPLER``, else in numpy. ``edge_index`` may be a
    ``_CSR`` built once by a caller that walks the same graph often."""
    csr = (edge_index if isinstance(edge_index, _CSR)
           else _CSR(edge_index, num_nodes))
    if csrc.WITH_NATIVE_SAMPLER:
        return _random_walk_native(csrc.sampler_library(), csr, rng, start,
                                   walk_length, p, q)
    walks = np.empty((len(start), walk_length + 1), np.int64)
    walks[:, 0] = start
    cur = np.asarray(start)
    prev = cur.copy()
    for t in range(1, walk_length + 1):
        nxt = csr.sample_neighbor(rng, cur)
        if p != 1.0 or q != 1.0:
            # rejection sampling on the biased transition
            for _ in range(3):
                accept_prob = np.where(nxt == prev, 1.0 / p, 1.0 / q)
                accept_prob = np.maximum(accept_prob, 0.0)
                redo = rng.random(len(nxt)) > accept_prob
                if not redo.any():
                    break
                nxt = np.where(redo, csr.sample_neighbor(rng, cur), nxt)
        prev, cur = cur, nxt
        walks[:, t] = cur
    return walks
