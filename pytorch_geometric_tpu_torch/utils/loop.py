"""Self-loop utilities.

Counterpart of ``pytorch_geometric_tpu/utils/loop.py`` (``add_self_loops``,
``add_remaining_self_loops``) and of ``maybe_num_nodes`` from
``utils/core.py``.
"""

from typing import Optional, Tuple, Union

import torch

from ..edge_index import EdgeIndex


def maybe_num_nodes(edge_index, num_nodes: Optional[int] = None) -> int:
    """``num_nodes`` if given, else one past the largest index."""
    if num_nodes is not None:
        return num_nodes
    coo = edge_index.coo if isinstance(edge_index, EdgeIndex) else edge_index
    return int(coo.max()) + 1 if coo.numel() else 0


def _unwrap(edge_index):
    if isinstance(edge_index, EdgeIndex):
        return edge_index.coo, edge_index.sparse_size
    return edge_index, None


def add_self_loops(
        edge_index, edge_weight: Optional[torch.Tensor] = None,
        fill_value: Union[float, str] = 1.0,
        num_nodes: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Append ``(i, i)`` for every node; existing loops stay. The output
    has ``E + N`` edges, and ``edge_weight`` (if given) grows by ``N``
    entries of ``fill_value``."""
    coo, size = _unwrap(edge_index)
    n = maybe_num_nodes(coo if size is None else None,
                        num_nodes if num_nodes is not None
                        else (size[0] if size else None))
    loops = torch.arange(n, dtype=coo.dtype, device=coo.device)
    out = torch.cat([coo, torch.stack([loops, loops])], dim=1)
    if edge_weight is not None:
        loop_w = edge_weight.new_full((n,), fill_value)
        edge_weight = torch.cat([edge_weight, loop_w])
    return out, edge_weight


def add_remaining_self_loops(
        edge_index, edge_weight: Optional[torch.Tensor] = None,
        fill_value: float = 1.0, num_nodes: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append one self loop per node; the appended loop keeps the last
    existing loop's weight, or ``fill_value`` where the node had none.

    Static-shape variant, as in the JAX package: existing loops stay in
    place with weight 0 instead of being removed, so the output has
    ``E + N`` edges."""
    coo, size = _unwrap(edge_index)
    n = maybe_num_nodes(coo if size is None else None,
                        num_nodes if num_nodes is not None
                        else (size[0] if size else None))
    e = coo.shape[1]
    if edge_weight is None:
        edge_weight = torch.ones(e, dtype=torch.float32, device=coo.device)
    loop_mask = coo[0] == coo[1]
    pos = torch.arange(e, device=coo.device)
    idx = torch.where(loop_mask, coo[0].long(), n)
    last_pos = torch.full((n + 1,), -1, dtype=torch.long,
                          device=coo.device).scatter_reduce_(
        0, idx, torch.where(loop_mask, pos, -1), reduce='amax')[:n]
    has_loop = last_pos >= 0
    tail = (1,) * (edge_weight.dim() - 1)
    w_exist = edge_weight[last_pos.clamp(0, max(e - 1, 0))] if e else \
        edge_weight.new_zeros((n,) + edge_weight.shape[1:])
    loop_w = torch.where(has_loop.view((n,) + tail), w_exist,
                         torch.as_tensor(fill_value,
                                         dtype=edge_weight.dtype,
                                         device=coo.device))
    edge_weight = torch.where(loop_mask.view((e,) + tail), 0, edge_weight)
    loops = torch.arange(n, dtype=coo.dtype, device=coo.device)
    out = torch.cat([coo, torch.stack([loops, loops])], dim=1)
    return out, torch.cat([edge_weight, loop_w.to(edge_weight.dtype)])
