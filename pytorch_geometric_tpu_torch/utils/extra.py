"""Additional graph utilities.

Counterpart of ``pytorch_geometric_tpu/utils/extra.py``; so far ``ppr``
(reference ``utils/ppr.py``), which the IBMB loaders (``loader/ibmb.py``)
rank auxiliary nodes by. The file's other utilities are ROADMAP Queue 1.
"""

from typing import Tuple

import numpy as np

from ..data.data import host


def ppr(edge_index, num_nodes: int, alpha: float = 0.15,
        eps: float = 1e-4) -> Tuple[np.ndarray, np.ndarray]:
    """Personalised PageRank of every node, by power iteration of ``alpha
    I + (1 - alpha) X P`` from ``X = I`` (``P`` the row-normalised
    adjacency; at most 50 steps, stopping once no entry moves by ``eps /
    10``), scores below ``eps`` zeroed: ``(coo [2, nnz], values [nnz])``
    on the host. Dense ``[N, N]``: for the small graphs IBMB's node-wise
    loader ranks."""
    coo = host(edge_index)
    n = num_nodes
    a = np.zeros((n, n))
    a[coo[0], coo[1]] = 1.0
    deg = np.maximum(a.sum(1, keepdims=True), 1)
    p = a / deg
    x = np.eye(n)
    for _ in range(50):
        x_new = alpha * np.eye(n) + (1 - alpha) * x @ p
        if np.abs(x_new - x).max() < eps * 0.1:
            x = x_new
            break
        x = x_new
    x[x < eps] = 0
    r, c = np.nonzero(x)
    return np.stack([r, c]), x[r, c]
