"""Select/Connect pooling with static shapes.

Counterpart of ``pytorch_geometric_tpu/nn/pool/select.py`` (reference
``torch_geometric/nn/pool/select/base.py`` (SelectOutput),
``select/topk.py:51`` (SelectTopK) and ``connect/filter_edges.py``). The
reference emits node subsets of varying length; here a selection keeps a
static ``k`` slots per graph with a validity mask, as in the JAX package:
unselected slots are masked out and edges touching them point at a dump
row. The top-k breaks ties to the lowest position, as ``jax.lax.top_k``
does.
"""

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..inits import glorot
from ...backend import resolve_device
from ...ops import softmax
from ...utils.dense import to_dense_batch


class SelectOutput(NamedTuple):
    """Static-shape selection result.

    node_index: ``[B*k]`` original node row per kept slot (clamped for
        invalid slots; use ``mask``).
    mask:       bool ``[B*k]`` slot validity.
    weight:     ``[B*k]`` selection score (gating multiplier).
    batch:      ``[B*k]`` graph id per slot.
    cluster_size: static int, ``k`` (slots per graph).
    """
    node_index: torch.Tensor
    mask: torch.Tensor
    weight: torch.Tensor
    batch: torch.Tensor
    cluster_size: int


def top_k(values: torch.Tensor, k: int):
    """The ``k`` largest of each row of ``values``, in order, ties to the
    lowest index, as ``jax.lax.top_k`` gives them (a stable sort keeps
    equal values in index order): ``(values, indices)``."""
    index = torch.sort(values, dim=-1, descending=True,
                       stable=True).indices[..., :k]
    return values.gather(-1, index), index


def select_topk(score: torch.Tensor, batch: torch.Tensor, batch_size: int,
                ratio: float, max_nodes_per_graph: int,
                min_score: Optional[float] = None,
                node_mask: Optional[torch.Tensor] = None) -> SelectOutput:
    """Per-graph top-k by score (reference ``select/topk.py:51``).

    ``k = ceil(ratio * max_nodes_per_graph)`` slots are kept per graph;
    slots beyond each graph's own ``ceil(ratio * n_g)`` (or at or below
    ``min_score``) are masked invalid: the reference's semantics with
    static shapes."""
    n = score.shape[0]
    L = max_nodes_per_graph
    k = max(1, math.ceil(ratio * L)) if min_score is None else L
    # dense [B, L] scores with -inf padding; the original row ids beside
    dense_score, valid = to_dense_batch(score[:, None], batch, batch_size, L,
                                        fill_value=-math.inf)
    dense_score = torch.where(valid, dense_score[..., 0], -math.inf)
    rows = torch.arange(n, device=score.device)
    dense_rows, _ = to_dense_batch(rows[:, None], batch, batch_size, L)
    dense_rows = dense_rows[..., 0]
    if node_mask is not None:
        dense_nm, _ = to_dense_batch(node_mask[:, None].int(), batch,
                                     batch_size, L)
        dense_score = torch.where(dense_nm[..., 0] > 0, dense_score,
                                  -math.inf)

    top_score, top_pos = top_k(dense_score, k)                  # [B, k]
    top_row = dense_rows.gather(1, top_pos)                     # [B, k]

    counts = valid.sum(1)                                       # [B]
    if min_score is None:
        per_graph_k = torch.ceil(ratio * counts.float()).int()
        slot = torch.arange(k, device=score.device)[None, :]
        keep = (slot < per_graph_k[:, None]) & torch.isfinite(top_score)
    else:
        keep = (top_score > min_score) & torch.isfinite(top_score)

    b = torch.arange(batch_size, device=score.device).repeat_interleave(k)
    return SelectOutput(
        node_index=top_row.reshape(-1),
        mask=keep.reshape(-1),
        weight=torch.where(keep, top_score, 0.0).reshape(-1),
        batch=b,
        cluster_size=k,
    )


def filter_edges(edge_index, select: SelectOutput, num_nodes: int):
    """Relabel edges onto kept slots; edges touching dropped nodes point at
    the dump row (reference ``connect/filter_edges.py``).

    Returns (new_edge_index [2, E], edge_mask [E])."""
    coo = edge_index.coo if hasattr(edge_index, 'coo') else edge_index
    coo = coo.long()
    new_n = select.node_index.shape[0]
    dev = coo.device
    # old node id -> new slot (or new_n when dropped)
    old2new = torch.full((num_nodes + 1,), new_n, dtype=torch.long,
                         device=dev)
    slot_ids = torch.arange(new_n, device=dev)
    src_rows = torch.where(select.mask, select.node_index.long(), num_nodes)
    old2new = old2new.index_put((src_rows,),
                                torch.where(select.mask, slot_ids, new_n))
    src = old2new[coo[0].clamp(max=num_nodes)]
    dst = old2new[coo[1].clamp(max=num_nodes)]
    keep = (src < new_n) & (dst < new_n)
    new_coo = torch.stack([torch.where(keep, src, new_n),
                           torch.where(keep, dst, new_n)])
    return new_coo, keep


class SelectTopK(nn.Module):
    """Learnable scoring + top-k selection (reference
    ``select/topk.py:51``): ``score = x w / |w|``, through ``tanh``
    (``act``) or, with ``min_score``, a softmax over each graph."""

    def __init__(self, in_channels: int, ratio: float = 0.5,
                 min_score: Optional[float] = None, act: str = 'tanh',
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.ratio = in_channels, ratio
        self.min_score, self.act = min_score, act
        self.weight = glorot((in_channels, 1), device, generator)

    def forward(self, x: torch.Tensor, batch: torch.Tensor, batch_size: int,
                max_nodes_per_graph: int,
                node_mask: Optional[torch.Tensor] = None) -> SelectOutput:
        w = self.weight
        score = (x @ w)[:, 0] / torch.linalg.vector_norm(w).clamp(min=1e-12)
        if self.min_score is None:
            score = torch.tanh(score) if self.act == 'tanh' else score
        else:
            score = softmax(score, batch, batch_size, mask=node_mask)
        return select_topk(score, batch, batch_size, self.ratio,
                           max_nodes_per_graph, self.min_score, node_mask)
