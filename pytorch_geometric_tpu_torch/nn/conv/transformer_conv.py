"""TransformerConv: graph transformer attention (Shi et al., UniMP).

Counterpart of ``pytorch_geometric_tpu/nn/conv/transformer_conv.py``:
multi-head attention over each destination's incoming edges with ``q =
W_q x_i``, ``k = W_k x_j`` (plus ``W_e e_ij`` with ``edge_dim``) and
``alpha = softmax(<q, k> / sqrt(C))``, then an optional root weight and
beta gate. Three branches, chosen as the JAX package chooses them
(``transformer_conv.py:48-84``):

  * fused: no ``edge_attr``, no attention weights asked for, and the slot
    orders cached (``fill_cache(blocked=True)``). The scores are
    ``ops.sddmm.sddmm`` (the per-edge dot kernel on the card, its backward
    two launches of the mix kernel over the slot orders) and the softmax
    and aggregation one ``ops.gat_fused.gat_aggregate`` (the mix kernel).
    ``backend.use_kernel_spmm`` plays the JAX package's ``_use_pallas()``:
    off, the CPU takes the wide branch and the card raises, as GATConv's
    ``_attend`` does;
  * wide: no ``edge_attr``, no weights asked for, no slot orders:
    ``ops.edge_attention.hetero_edge_attention_multi`` over the one
    relation, which multiplies by ``1 / sqrt(C)`` where the fused branch
    divides by ``sqrt(C)``, as the JAX package does. Past
    ``PGT_ATTN_WIDE_BYTES`` that op takes its online-softmax flash scan
    (the flash kernels on the card), as the JAX package's does;
  * explicit: ``edge_attr`` or ``return_attention_weights``: scores by
    :func:`ops.sddmm.gathered_dot`, ``ops.softmax``, and ``index_add_``.

The scores of the wide and explicit branches read clamped endpoints, as
the JAX package's do; the fused branch's score of an edge whose source or
destination is out of range is 0. Padded edges (both endpoints at the node
count, the repo's convention) are dropped either way; an edge whose only
source is out of range enters its destination's softmax denominator with
that score, where the JAX package reads the last source row.

``dropout``: the JAX conv takes it and never applies it; so does this one.
"""

import math
from typing import Optional, Tuple, Union

import torch

from ..inits import linear
from ..message_passing import MessagePassing
from ...backend import resolve_device
from ...edge_index import EdgeIndex
from ...ops.edge_attention import hetero_edge_attention_multi
from ...ops.gat_fused import fused_ok, gat_aggregate
from ...ops.sddmm import gathered_dot, sddmm
from .gat_conv import _split


class TransformerConv(MessagePassing):
    """Multi-head QKV attention over edges with optional edge features and
    a beta-gated skip. ``in_channels`` as a pair ``(src, dst)`` makes the
    conv bipartite. Parameter names follow the JAX package's
    (``lin_query``, ``lin_key``, ``lin_value``, ``lin_edge``, ``lin_skip``,
    ``lin_beta``), so ``convert.flax_to_state_dict`` carries its weights."""

    def __init__(self, in_channels: Union[int, Tuple[int, int]],
                 out_channels: int, heads: int = 1, concat: bool = True,
                 beta: bool = False, dropout: float = 0.0,
                 edge_dim: Optional[int] = None, root_weight: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        in_src, in_dst, _ = _split(in_channels)
        self.out_channels, self.heads = out_channels, heads
        self.concat = concat
        self.beta, self.dropout, self.root_weight = beta, dropout, root_weight
        hc = heads * out_channels
        kw = dict(device=device, generator=generator)
        self.lin_query = linear(in_dst, hc, **kw)
        self.lin_key = linear(in_src, hc, **kw)
        self.lin_value = linear(in_src, hc, **kw)
        self.lin_edge = (linear(edge_dim, hc, **kw) if edge_dim is not None
                         else None)
        out = hc if concat else out_channels
        self.lin_skip = linear(in_dst, out, **kw) if root_weight else None
        self.lin_beta = (linear(3 * out, 1, bias=False, **kw)
                         if root_weight and beta else None)

    def forward(self, x: Union[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]],
                edge_index, edge_attr: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None,
                return_attention_weights: bool = False):
        h, c = self.heads, self.out_channels
        x_src, x_dst = x if isinstance(x, tuple) else (x, x)
        n_src, n_dst = x_src.shape[0], x_dst.shape[0]
        q = self.lin_query(x_dst).view(n_dst, h, c)
        k = self.lin_key(x_src).view(n_src, h, c)
        v = self.lin_value(x_src).view(n_src, h, c)
        e = None
        if edge_attr is not None:
            if self.lin_edge is None:
                raise ValueError('TransformerConv got edge_attr but was '
                                 'built with edge_dim=None')
            e = self.lin_edge(edge_attr).view(-1, h, c)

        coo = edge_index.coo if isinstance(edge_index, EdgeIndex) \
            else edge_index
        src = coo[0].long().clamp(max=n_src - 1)
        dst = coo[1].long().clamp(max=n_dst - 1)
        plain = e is None and not return_attention_weights
        alpha = None
        if plain and fused_ok(edge_index, x_src):
            # <q[dst], k[src]> / sqrt(C): one launch of the dot kernel
            alpha = sddmm(edge_index, k, q) / math.sqrt(c)
            out = gat_aggregate(edge_index, alpha, v, edge_mask=edge_mask)
        elif plain:
            valid = (coo[0] < n_src) & (coo[1] < n_dst)
            if edge_mask is not None:
                valid = valid & edge_mask
            d_eff = torch.where(valid, dst, n_dst)
            p = torch.full((h,), 1.0 / math.sqrt(c), device=q.device)
            out = hetero_edge_attention_multi([k], [v], q, [p], [src],
                                              [d_eff], n_dst)
        else:
            if e is None:
                alpha = gathered_dot(q, k, dst, src) / math.sqrt(c)
            else:
                k_j = k[src] + e
                alpha = gathered_dot(q, k_j, dst, torch.arange(
                    k_j.shape[0], device=k_j.device)) / math.sqrt(c)
            alpha = self.edge_softmax(alpha, dst, n_dst, edge_mask)
            msg = v[src]
            if e is not None:
                msg = msg + e
            msg = msg * alpha[..., None]
            if edge_mask is not None:
                msg = torch.where(edge_mask[:, None, None], msg, 0.0)
            seg = dst if edge_mask is None else torch.where(edge_mask, dst,
                                                            n_dst)
            out = msg.new_zeros((n_dst + 1, h * c)).index_add_(
                0, seg, msg.reshape(-1, h * c))[:n_dst].view(n_dst, h, c)

        out = out.reshape(n_dst, h * c) if self.concat else out.mean(dim=1)
        if self.root_weight:
            x_r = self.lin_skip(x_dst)
            if self.beta:
                b = torch.sigmoid(self.lin_beta(
                    torch.cat([out, x_r, out - x_r], dim=-1)))
                out = b * x_r + (1 - b) * out
            else:
                out = out + x_r
        if return_attention_weights:
            return out, (coo, alpha)
        return out
