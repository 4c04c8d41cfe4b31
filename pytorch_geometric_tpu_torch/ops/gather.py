"""Row gathers of narrow per-edge arrays.

``x[idx]`` on a CUDA tensor runs PyTorch's row-gather kernel, which moves
rows of a few floats far below the card's memory rate; the attention
glue's ``[E, H]`` gathers (logits, stabilisers, attention scores: a few
heads each) took most of a GAT forward that way (PERF.md, path C's
profile). :func:`take_rows` gathers such rows through a flat element
index instead; its gradient is the same accumulating ``index_put_`` as
``x[idx]``'s.
"""

import torch

# rows of at most this many elements take the flat index
NARROW = 16

# The share of the card's L2 that one slice of a gathered table may fill
# (the mix kernel's v, the dot kernel's a and b), from the slice-width sweep
# of chip_smoke.py (PERF.md): on an H100 (50 MiB of L2, two partitions) a
# 25.6 MB slice of v beat one of 12.8 MB, which re-reads the slot streams
# twice as often, and one of 51.2 MB, which does not stay resident.
MIX_L2_SHARE = 0.5


def _flat_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    w = x.shape[1]
    flat = idx[:, None] * w + torch.arange(w, device=idx.device)
    return x.reshape(-1)[flat.view(-1)].view(idx.shape[0], w)


class _TakeRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return _flat_take(x, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        grad = g.new_zeros((ctx.rows, g.shape[1])).index_put_(
            (idx,), g, accumulate=True)
        return grad, None


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 2-D ``x`` and a 1-D int64 ``idx`` of rows in
    range, differentiable in ``x``."""
    if x.dim() != 2 or x.shape[1] > NARROW:
        return x[idx]
    if torch.is_grad_enabled() and x.requires_grad:
        return _TakeRows.apply(x, idx)
    return _flat_take(x, idx)
