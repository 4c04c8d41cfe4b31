"""Global (graph-level) pooling.

Counterpart of ``pytorch_geometric_tpu/nn/pool/glob.py`` (reference
``nn/pool/glob.py:8-92``): each takes a static ``size`` (the number of
graphs) and an optional node ``mask``, so a padded batch pools as an
unpadded one; a padded node whose graph id is ``size`` is dropped. An
empty graph's max is 0.
"""

from typing import Optional

import torch

from ...ops import scatter


def global_add_pool(x: torch.Tensor, batch: Optional[torch.Tensor],
                    size: int = 1,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if batch is None:
        return x.sum(0, keepdim=True)
    return scatter(x, batch, size, 'sum', mask=mask)


def global_mean_pool(x: torch.Tensor, batch: Optional[torch.Tensor],
                     size: int = 1,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if batch is None:
        return x.mean(0, keepdim=True)
    return scatter(x, batch, size, 'mean', mask=mask)


def global_max_pool(x: torch.Tensor, batch: Optional[torch.Tensor],
                    size: int = 1,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if batch is None:
        return x.amax(0, keepdim=True)
    return scatter(x, batch, size, 'max', mask=mask)


def avg_pool_neighbor_x(data, flow: str = 'source_to_target'):
    """``data.x`` replaced by the mean over each node's in-neighbours and
    itself (reference ``nn/pool/avg_pool.py:96``)."""
    return _pool_neighbor_x(data, 'mean', flow)


def max_pool_neighbor_x(data, flow: str = 'source_to_target'):
    """``data.x`` replaced by the max over each node's in-neighbours and
    itself (reference ``nn/pool/max_pool.py:91``)."""
    return _pool_neighbor_x(data, 'max', flow)


def _pool_neighbor_x(data, reduce: str, flow: str):
    from ...utils.loop import add_self_loops
    n = data.num_nodes
    coo = data.edge_index
    coo = torch.as_tensor(coo.coo if hasattr(coo, 'coo') else coo)
    x = torch.as_tensor(data.x)
    coo, _ = add_self_loops(coo.to(x.device), None, num_nodes=n)
    row, col = (coo[0], coo[1]) if flow == 'source_to_target' \
        else (coo[1], coo[0])
    data.x = scatter(x[row.long().clamp(max=n - 1)],
                     col.long().clamp(max=n - 1), n, reduce)
    return data
