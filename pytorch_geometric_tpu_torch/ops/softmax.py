"""Segment softmax.

Counterpart of ``pytorch_geometric_tpu/ops/softmax.py`` (``softmax`` with
the semantics of ``_softmax_xla``). The JAX package leaves it to XLA, with
no Pallas kernel, so the port's is plain PyTorch on either device. Given an
``edge_index`` with the slot orders cached, ``[E, H]`` logits take the fused
route, ``ops/sddmm.py::edge_softmax`` (its denominators on the mix kernel),
under the JAX package's condition; ``backend.use_kernel_spmm`` plays its
``_use_pallas()`` there, and with the knob off a CUDA tensor on that route
raises (``ops/gat_fused.py::fused_ok``).
"""

from typing import Optional

import torch

from .gat_fused import fused_ok
from .sddmm import edge_softmax, fused_softmax_available


def _expand(index: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return index.view((-1,) + (1,) * (like.dim() - 1)).expand_as(like)


def softmax(src: torch.Tensor, index: torch.Tensor, num_segments: int,
            mask: Optional[torch.Tensor] = None,
            edge_index=None) -> torch.Tensor:
    """Softmax of ``src`` (``[E]`` or ``[E, H]``) grouped by ``index``
    (e.g. GAT attention over the incoming edges of each destination).

    Masked edges (``mask == False``) get weight 0 and do not enter their
    segment's normalisation; the denominator takes ``+1e-16``, so an
    all-masked segment gives zeros, not NaN. As in the JAX package, an
    index past the last segment (a padded edge, ``index == num_segments``)
    enters no segment's max or sum, and its gathers are clamped to the last
    segment.

    When ``edge_index`` (an ``EdgeIndex`` with the slot orders cached whose
    destinations are ``index``) is given, the softmax of ``[E, H]`` logits
    runs through :func:`ops.sddmm.edge_softmax`; with
    ``backend.use_kernel_spmm`` off that route raises for a CUDA tensor and
    a CPU tensor takes the plain one."""
    if (edge_index is not None and src.dim() == 2
            and fused_softmax_available(edge_index)
            and src.shape[0] == edge_index.blocked.inv_pos.shape[0]
            and fused_ok(edge_index, src)):
        return edge_softmax(edge_index, src, edge_mask=mask)
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
