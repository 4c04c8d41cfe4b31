"""Segment softmax.

Counterpart of ``pytorch_geometric_tpu/ops/softmax.py`` (``softmax`` with
the semantics of ``_softmax_xla``). The JAX package leaves it to XLA, with
no Pallas kernel, so the port's is plain PyTorch on either device. The
fused route through the blocked layout (``edge_index=``, ``ops/sddmm.py``)
is not ported yet (ROADMAP Queue 1, item 7).
"""

from typing import Optional

import torch


def _expand(index: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return index.view((-1,) + (1,) * (like.dim() - 1)).expand_as(like)


def softmax(src: torch.Tensor, index: torch.Tensor, num_segments: int,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax of ``src`` (``[E]`` or ``[E, H]``) grouped by ``index``
    (e.g. GAT attention over the incoming edges of each destination).

    Masked edges (``mask == False``) get weight 0 and do not enter their
    segment's normalisation; the denominator takes ``+1e-16``, so an
    all-masked segment gives zeros, not NaN. As in the JAX package, an
    index past the last segment (a padded edge, ``index == num_segments``)
    enters no segment's max or sum, and its gathers are clamped to the last
    segment."""
    index = index.long()
    n = num_segments
    if mask is not None:
        index = torch.where(mask, index, num_segments)
        n = num_segments + 1
    # segment ops drop an index past the last segment: it lands in an extra
    # row, cut off below
    seg = torch.where(index < n, index, n)
    gather = index.clamp(max=n - 1)
    # the shift cancels in the quotient, so its gradient is exactly zero
    maxes = src.new_full((n + 1,) + src.shape[1:],
                         float('-inf')).scatter_reduce(
        0, _expand(seg, src), src.detach(), reduce='amax')[:n]
    maxes = torch.where(torch.isfinite(maxes), maxes, 0.0)
    out = torch.exp(src - maxes[gather])
    if mask is not None:
        out = torch.where(_expand(mask, out), out, 0.0)
    sums = src.new_zeros((n + 1,) + src.shape[1:]).index_add_(
        0, seg, out)[:n]
    return out / (sums[gather] + 1e-16)
