"""Node reorderings that concentrate edges into fewer 128x128 blocks
(host-side numpy).

Counterpart of ``pytorch_geometric_tpu/utils/reorder.py`` for what the
block-sparse cache needs: ``degree_order`` (hubs first) and the symmetrised
CSR it ranks by. ``reverse_cuthill_mckee`` and ``cluster_order`` are not
ported yet (no path of the port calls them).
"""

from typing import Tuple

import numpy as np

__all__ = ['degree_order']


def _sym_csr(coo: np.ndarray, n: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetrised, deduped CSR ``(indptr, cols, deg)`` of the union graph
    ``A + A^T`` without self loops. Padded endpoints (``>= n``) are
    dropped."""
    src = coo[0].astype(np.int64)
    dst = coo[1].astype(np.int64)
    valid = (src < n) & (dst < n)
    src, dst = src[valid], dst[valid]
    row = np.concatenate([src, dst])
    col = np.concatenate([dst, src])
    keep = row != col
    key = np.unique(row[keep] * n + col[keep])
    row, col = key // n, key % n
    indptr = np.searchsorted(row, np.arange(n + 1))
    return indptr, col, np.diff(indptr)


def degree_order(coo: np.ndarray, num_nodes: int) -> np.ndarray:
    """Hubs-first ordering: ``perm[new_pos] = old_id`` by descending
    symmetrised degree (stable, so ties keep their order)."""
    _, _, deg = _sym_csr(coo, num_nodes)
    return np.argsort(-deg, kind='stable')
