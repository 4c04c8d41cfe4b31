"""Node reorderings that concentrate edges into fewer 128x128 blocks
(host-side numpy).

Counterpart of ``pytorch_geometric_tpu/utils/reorder.py``: ``degree_order``
(hubs first, what the block-sparse cache tries), ``reverse_cuthill_mckee``,
``apply_node_permutation`` and ``block_fill_stats``, over the symmetrised
CSR they rank by. ``cluster_order`` waits for the streaming partitioner
(``loader/cluster.py``, ROADMAP Queue 1 item 8).
"""

from typing import Tuple

import numpy as np

__all__ = ['reverse_cuthill_mckee', 'degree_order',
           'apply_node_permutation', 'block_fill_stats']


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


def reverse_cuthill_mckee(coo: np.ndarray, num_nodes: int) -> np.ndarray:
    """``perm`` with ``perm[new_pos] = old_id`` in reverse Cuthill-McKee
    order (JAX ``utils/reorder.py:42-72``): a breadth-first search from the
    least-degree unvisited node of each component, neighbours in increasing
    degree (stable), the whole order reversed."""
    n = num_nodes
    indptr, cols, deg = _sym_csr(coo, n)
    visited = np.zeros(n, bool)
    perm = np.empty(n, np.int64)
    pos = 0
    for start in np.argsort(deg, kind='stable'):
        if visited[start]:
            continue
        visited[start] = True
        queue = [int(start)]
        qi = 0
        while qi < len(queue):
            node = queue[qi]
            qi += 1
            perm[pos] = node
            pos += 1
            nbrs = cols[indptr[node]:indptr[node + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(deg[nbrs], kind='stable')]
                visited[nbrs] = True
                queue.extend(int(x) for x in nbrs)
    return perm[::-1].copy()


def degree_order(coo: np.ndarray, num_nodes: int) -> np.ndarray:
    """Hubs-first ordering: ``perm[new_pos] = old_id`` by descending
    symmetrised degree (stable, so ties keep their order)."""
    _, _, deg = _sym_csr(coo, num_nodes)
    return np.argsort(-deg, kind='stable')


def apply_node_permutation(data, perm: np.ndarray):
    """Relabel a :class:`~pytorch_geometric_tpu_torch.data.Data` by ``perm``
    (``perm[new] = old``; JAX ``utils/reorder.py:91-110``): every node-dim
    value (first dimension ``num_nodes``, name not starting with
    ``edge_``) is permuted on its own device and the edge endpoints are
    rewritten; padded endpoints (``== num_nodes``) pass through. Returns
    ``(data, inv)`` with ``inv[old] = new``."""
    import torch
    n = data.num_nodes
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    ei = data.edge_index
    coo = ei.detach().cpu().numpy() if isinstance(ei, torch.Tensor) \
        else np.asarray(ei)
    inv_ext = np.concatenate([inv, [n]])
    new_coo = inv_ext[np.minimum(coo, n)].astype(coo.dtype)
    up = {'edge_index': (torch.as_tensor(new_coo, device=ei.device)
                         if isinstance(ei, torch.Tensor) else new_coo)}
    for k, v in data.items():
        if k == 'edge_index' or not hasattr(v, 'shape'):
            continue
        if (len(v.shape) >= 1 and v.shape[0] == n
                and not k.startswith('edge_')):
            up[k] = v[torch.as_tensor(perm, device=v.device)
                      if isinstance(v, torch.Tensor) else perm]
    return data.replace(**up), inv


def block_fill_stats(coo: np.ndarray, num_nodes: int, block: int = 128,
                     min_fill: int = 16) -> Tuple[float, float, int]:
    """``(captured_edge_fraction, mean_edges_per_nonempty_block,
    num_nonempty_blocks)`` of the ``block x block`` blocking of ``coo``:
    the block-sparse cache's profitability measure (JAX
    ``utils/reorder.py:113-131``). Padded endpoints are dropped."""
    src = coo[0].astype(np.int64)
    dst = coo[1].astype(np.int64)
    valid = (src < num_nodes) & (dst < num_nodes)
    src, dst = src[valid], dst[valid]
    if not len(src):
        return 0.0, 0.0, 0
    s_blocks = (num_nodes + block - 1) // block
    key = (dst // block) * s_blocks + (src // block)
    _, counts = np.unique(key, return_counts=True)
    captured = counts[counts >= min_fill].sum() / len(src)
    return float(captured), float(counts.mean()), int(len(counts))
