"""knn_interpolate (reference
``torch_geometric/nn/unpool/knn_interpolate.py``).

Counterpart of ``pytorch_geometric_tpu/nn/unpool.py``."""

from typing import Optional

import torch

from .pool.point import knn
from ..ops import scatter


def knn_interpolate(x: torch.Tensor, pos_x: torch.Tensor,
                    pos_y: torch.Tensor, k: int = 3,
                    batch_x: Optional[torch.Tensor] = None,
                    batch_y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-squared-distance weighted interpolation of ``x`` from the
    points ``pos_x`` onto ``pos_y``, over each target's ``k`` nearest
    sources (of its own cloud)."""
    ei, valid = knn(pos_x, pos_y, k, batch_x, batch_y)
    y_idx = ei[0]
    x_idx = ei[1].clamp(max=pos_x.shape[0] - 1)
    d2 = ((pos_x[x_idx] - pos_y[y_idx.clamp(max=pos_y.shape[0] - 1)])
          ** 2).sum(-1)
    w = 1.0 / d2.clamp(min=1e-16)
    w = torch.where(valid, w, 0)
    num = scatter(x[x_idx] * w[:, None], y_idx, pos_y.shape[0], 'sum')
    den = scatter(w, y_idx, pos_y.shape[0], 'sum')
    return num / den.clamp(min=1e-16)[:, None]
