"""HeteroConv, HGTConv, HANConv: heterogeneous convolutions.

Counterpart of ``pytorch_geometric_tpu/nn/conv/hetero_conv.py`` (reference
``torch_geometric/nn/conv/hetero_conv.py:29``, ``hgt_conv.py:17``,
``han_conv.py``). Parameters and submodules carry the JAX package's names
(``conv_`` dropped for :class:`HeteroConv`'s ``convs``), so
``convert.flax_to_state_dict`` maps one onto the other. The JAX modules
infer their input widths at ``init``; these take them as ``in_channels``,
an int or a per-node-type dict.
"""

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..inits import constant, glorot, linear
from ...backend import resolve_device
from ...ops import scatter, softmax as segment_softmax

EdgeType = Tuple[str, str, str]


def _ekey(et: EdgeType) -> str:
    return '__'.join(et)


def _coo(ei) -> torch.Tensor:
    return ei.coo if hasattr(ei, 'coo') else ei


def _width(in_channels: Union[int, Dict[str, int]], t: str) -> int:
    return in_channels[t] if isinstance(in_channels, dict) else in_channels


def _rel_transform(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('nhd,hdf->nhf', x, w)`` (x ``[N, H, D]``, w ``[H, D, D]``)
    as one ``[N, H D] @ blockdiag(w)`` product. The batched einsum's weight
    gradient is a reduction over N with a ``D x D`` output a head, for
    which cuBLAS ran one 32x32-tile kernel for 18 ms a call at HGT's
    OGB-MAG shape (N = 1.1M, H = 4, D = 16; ``chip_smoke.py`` path N, H100
    80GB HBM3 at 700 W), 73 % of the training step; the block-diagonal
    product's is an ``[H D, H D]`` reduction, as a Linear layer's."""
    n, h, d = x.shape
    return (x.reshape(n, h * d) @ torch.block_diag(*w.unbind(0))).view(
        n, h, d)


class HeteroConv(nn.Module):
    """A dict of per-edge-type convs; each destination's results grouped by
    ``aggr`` (reference ``hetero_conv.py:29``): 'sum' / 'add', 'mean',
    'max', 'min' or 'cat'.

    ``convs``: edge type -> conv module, each called with ``((x_src,
    x_dst), edge_index, **kwargs)``; held in ``self.convs``, an
    ``nn.ModuleDict`` keyed ``'__'.join(edge_type)``."""

    def __init__(self, convs: Dict[EdgeType, nn.Module], aggr: str = 'sum'):
        super().__init__()
        if aggr not in ('sum', 'add', 'mean', 'max', 'min', 'cat'):
            raise ValueError(f"Unknown aggr '{aggr}'")
        self.edge_types = [tuple(et) for et in convs]
        self.convs = nn.ModuleDict({_ekey(et): c for et, c in convs.items()})
        self.aggr = aggr

    def forward(self, x_dict: Dict[str, torch.Tensor],
                edge_index_dict: Dict[EdgeType, Any],
                **kwargs_dict) -> Dict[str, torch.Tensor]:
        grouped: Dict[str, list] = {}
        for et in self.edge_types:
            if et not in edge_index_dict:
                continue
            src, _, dst = et
            if src not in x_dict or dst not in x_dict:
                continue
            kw = {k: v[et] for k, v in kwargs_dict.items() if et in v}
            out = self.convs[_ekey(et)]((x_dict[src], x_dict[dst]),
                                        edge_index_dict[et], **kw)
            grouped.setdefault(dst, []).append(out)
        result = {}
        for dst, outs in grouped.items():
            if len(outs) == 1:
                result[dst] = outs[0]
            elif self.aggr in ('sum', 'add'):
                result[dst] = sum(outs)
            elif self.aggr == 'mean':
                result[dst] = sum(outs) / len(outs)
            elif self.aggr == 'max':
                result[dst] = torch.stack(outs).amax(0)
            elif self.aggr == 'min':
                result[dst] = torch.stack(outs).amin(0)
            else:                                   # 'cat'
                result[dst] = torch.cat(outs, -1)
        return result


class HGTConv(nn.Module):
    """Heterogeneous Graph Transformer (reference ``hgt_conv.py:17``).

    Typed K / Q / V projections (``k_{t}``, ``q_{t}``, ``v_{t}``), per
    relation a transform of keys and values (``a_rel_{et}``, ``m_rel_{et}``
    ``[H, D, D]``, applied at the node level) and a prior (``p_rel_{et}``
    ``[H]``), ONE edge softmax per destination over the union of its
    incoming relations, the approximate GELU, a typed output projection
    (``out_{t}``) and a gated skip (``skip_{t}``).

    ``attn_path`` selects the union softmax, as in the JAX package:

    * ``'fused'`` (the default for raw COOs):
      ``ops.edge_attention.hetero_edge_attention_multi``, the wide op on
      the per-edge dot kernel within ``PGT_ATTN_WIDE_BYTES`` and the flash
      kernels past it, or always with a flash layout;
    * ``'blocked'`` (the default when every relation is an ``EdgeIndex``
      with slot orders, ``fill_cache(blocked=True)``):
      ``ops.sddmm.multi_relation_softmax_aggregate`` on the mix kernel;
    * ``'concat'``: per-relation gathers and one plain segment softmax.

    A ``flash_layouts`` entry for a destination type
    (``ops.edge_attention.build_hgt_flash_layouts``) always takes the fused
    route, over its presorted edges."""

    def __init__(self, in_channels: Union[int, Dict[str, int]],
                 out_channels: int,
                 metadata: Tuple[Tuple[str, ...], Tuple[EdgeType, ...]],
                 heads: int = 1, attn_path: Optional[str] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        node_types, edge_types = metadata
        self.node_types = tuple(node_types)
        self.edge_types = tuple(tuple(et) for et in edge_types)
        self.out_channels, self.heads = out_channels, heads
        self.attn_path = attn_path
        h, d = heads, out_channels // heads
        for t in self.node_types:
            f = _width(in_channels, t)
            for p in 'kqv':
                self.add_module(f'{p}_{t}', linear(f, h * d, device=device,
                                                   generator=generator))
        for et in self.edge_types:
            name = _ekey(et)
            for p in ('a_rel', 'm_rel'):
                self.register_parameter(f'{p}_{name}',
                                        glorot((h, d, d), device, generator))
            self.register_parameter(f'p_rel_{name}',
                                    constant((h,), 1.0, device))
        for t in self.node_types:
            if any(et[2] == t for et in self.edge_types):
                self.add_module(f'out_{t}', linear(h * d, out_channels,
                                                   device=device,
                                                   generator=generator))
                self.register_parameter(f'skip_{t}',
                                        constant((), 1.0, device))

    def forward(self, x_dict: Dict[str, torch.Tensor],
                edge_index_dict: Dict[EdgeType, Any],
                flash_layouts: Optional[Dict[str, Any]] = None
                ) -> Dict[str, torch.Tensor]:
        from ...ops.edge_attention import hetero_edge_attention_multi
        from ...ops.sddmm import (fused_softmax_available,
                                  multi_relation_softmax_aggregate)
        h = self.heads
        d_hid = self.out_channels // h
        k_dict, q_dict, v_dict = {}, {}, {}
        for t in self.node_types:
            if t not in x_dict:
                continue
            x = x_dict[t]
            k_dict[t] = getattr(self, f'k_{t}')(x).view(-1, h, d_hid)
            q_dict[t] = getattr(self, f'q_{t}')(x).view(-1, h, d_hid)
            v_dict[t] = getattr(self, f'v_{t}')(x).view(-1, h, d_hid)

        # relations grouped by destination type; the softmax spans the
        # union of a destination's incoming edges across ALL relations
        rels_by_dst: Dict[str, list] = {}
        for et in self.edge_types:
            src, _, dst = et
            if (et not in edge_index_dict or src not in k_dict
                    or dst not in q_dict):
                continue
            name = _ekey(et)
            rels_by_dst.setdefault(dst, []).append(
                (src, getattr(self, f'a_rel_{name}'),
                 getattr(self, f'm_rel_{name}'),
                 getattr(self, f'p_rel_{name}'), edge_index_dict[et]))

        out_dict = {}
        scale = math.sqrt(d_hid)
        for t in self.node_types:
            if t not in x_dict:
                continue
            n = x_dict[t].shape[0]
            if t not in rels_by_dst:
                out_dict[t] = x_dict[t]
                continue
            rels = rels_by_dst[t]
            path = self.attn_path
            if path is None:
                path = ('blocked'
                        if all(fused_softmax_available(r[4]) for r in rels)
                        else 'fused')
            if flash_layouts is not None and t in flash_layouts:
                path = 'fused'
            if path == 'fused':
                k_tabs, v_tabs, s_parts, d_parts, p_parts = \
                    [], [], [], [], []
                for (src, a_rel, m_rel, p_rel, ei) in rels:
                    coo = _coo(ei)
                    n_src = k_dict[src].shape[0]
                    # the relation transform at the NODE level (it
                    # commutes with the gather)
                    k_tabs.append(_rel_transform(k_dict[src], a_rel))
                    v_tabs.append(_rel_transform(v_dict[src], m_rel))
                    valid = (coo[0] < n_src) & (coo[1] < n)
                    s_parts.append(coo[0].clamp(max=n_src - 1))
                    d_parts.append(torch.where(valid,
                                               coo[1].clamp(max=n - 1), n))
                    p_parts.append(p_rel / scale)
                agg = hetero_edge_attention_multi(
                    k_tabs, v_tabs, q_dict[t], p_parts, s_parts, d_parts, n,
                    layout=(None if flash_layouts is None
                            else flash_layouts.get(t)))
                agg = agg.reshape(n, -1)
            else:
                per_rel = []
                for (src, a_rel, m_rel, p_rel, ei) in rels:
                    coo = _coo(ei)
                    n_src = k_dict[src].shape[0]
                    s = coo[0].long().clamp(max=n_src - 1)
                    d = coo[1].long().clamp(max=n - 1)
                    k = _rel_transform(k_dict[src], a_rel).index_select(0, s)
                    v = _rel_transform(v_dict[src], m_rel).index_select(0, s)
                    q = q_dict[t].index_select(0, d)
                    logit = (q * k).sum(-1) * p_rel / scale     # [E, H]
                    valid = (coo[0] < n_src) & (coo[1] < n)
                    per_rel.append((d, logit, v, valid, ei))
                if path == 'blocked':
                    # the union softmax across relations on the mix
                    # kernel (one shared stabiliser; ops/sddmm.py)
                    agg = multi_relation_softmax_aggregate(
                        [(p[4], p[1], p[2], p[3]) for p in per_rel], n)
                    agg = agg.reshape(n, -1)
                elif path == 'concat':
                    ds = torch.cat([p[0] for p in per_rel])
                    logits = torch.cat([p[1] for p in per_rel])
                    vs = torch.cat([p[2] for p in per_rel])
                    valid = torch.cat([p[3] for p in per_rel])
                    alpha = segment_softmax(logits, ds, n, mask=valid)
                    msg = vs * alpha[..., None]
                    agg = scatter(msg.reshape(msg.shape[0], -1), ds, n,
                                  'sum', mask=valid)
                else:
                    raise ValueError(f"Unknown attn_path '{path}' (choose "
                                     "from 'fused', 'blocked', 'concat')")
            out = getattr(self, f'out_{t}')(F.gelu(agg, approximate='tanh'))
            # gated skip (reference hgt_conv.py skip parameter)
            beta = torch.sigmoid(getattr(self, f'skip_{t}'))
            if x_dict[t].shape[-1] == self.out_channels:
                out = beta * out + (1 - beta) * x_dict[t]
            out_dict[t] = out
        return out_dict


class HANConv(nn.Module):
    """Heterogeneous attention network (reference ``han_conv.py``): per
    metapath GAT-style node attention (``proj_{t}``, ``att_src_{et}``,
    ``att_dst_{et}`` ``[1, H, D]``), then semantic attention across the
    metapaths into each destination type, with ``k_lin`` and ``q`` shared
    by every node type. A metapath whose ``E * H * D * 4`` bytes pass
    ``PGT_ATTN_WIDE_BYTES`` takes the GAT flash route
    (``ops.edge_attention.gat_flash_attention``, the flash kernels on the
    card); the others the plain segment softmax. A type no metapath
    reaches maps to None."""

    def __init__(self, in_channels: Union[int, Dict[str, int]],
                 out_channels: int,
                 metadata: Tuple[Tuple[str, ...], Tuple[EdgeType, ...]],
                 heads: int = 1, negative_slope: float = 0.2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        node_types, edge_types = metadata
        self.node_types = tuple(node_types)
        self.edge_types = tuple(tuple(et) for et in edge_types)
        self.out_channels, self.heads = out_channels, heads
        self.negative_slope = negative_slope
        h, d = heads, out_channels // heads
        for t in self.node_types:
            self.add_module(f'proj_{t}', linear(_width(in_channels, t),
                                                h * d, device=device,
                                                generator=generator))
        for et in self.edge_types:
            name = _ekey(et)
            for p in ('att_src', 'att_dst'):
                self.register_parameter(f'{p}_{name}',
                                        glorot((1, h, d), device, generator))
        self.k_lin = linear(h * d, out_channels, device=device,
                            generator=generator)
        self.q = glorot((1, out_channels), device, generator)

    def forward(self, x_dict: Dict[str, torch.Tensor],
                edge_index_dict: Dict[EdgeType, Any]
                ) -> Dict[str, Optional[torch.Tensor]]:
        from ...ops.edge_attention import gat_flash_attention, wide_bytes_cap
        h = self.heads
        d_hid = self.out_channels // h
        h_dict = {t: getattr(self, f'proj_{t}')(x).view(-1, h, d_hid)
                  for t, x in x_dict.items()}
        per_dst: Dict[str, list] = {}
        for et in self.edge_types:
            src, _, dst = et
            if et not in edge_index_dict or src not in h_dict:
                continue
            name = _ekey(et)
            a_src = getattr(self, f'att_src_{name}')
            a_dst = getattr(self, f'att_dst_{name}')
            coo = _coo(edge_index_dict[et])
            n_src, n_dst = h_dict[src].shape[0], h_dict[dst].shape[0]
            s = coo[0].long().clamp(max=n_src - 1)
            d = coo[1].long().clamp(max=n_dst - 1)
            e_src = (h_dict[src] * a_src).sum(-1)
            e_dst = (h_dict[dst] * a_dst).sum(-1)
            valid = (coo[0] < n_src) & (coo[1] < n_dst)
            if coo.shape[1] * h * d_hid * 4 > wide_bytes_cap():
                # a giant metapath: the online-softmax flash scan (additive
                # leaky_relu logits, GATConv's form)
                agg = gat_flash_attention(
                    e_src, e_dst, h_dict[src], s,
                    torch.where(valid, d, n_dst), n_dst,
                    negative_slope=self.negative_slope)
                agg = agg.reshape(n_dst, -1)
            else:
                logit = F.leaky_relu(e_src.index_select(0, s)
                                     + e_dst.index_select(0, d),
                                     self.negative_slope)
                alpha = segment_softmax(logit, d, n_dst, mask=valid)
                msg = h_dict[src].index_select(0, s) * alpha[..., None]
                agg = scatter(msg.reshape(msg.shape[0], -1), d, n_dst,
                              'sum', mask=valid)
            per_dst.setdefault(dst, []).append(F.relu(agg))

        # semantic attention (reference han_conv.py group())
        out_dict: Dict[str, Optional[torch.Tensor]] = {}
        for t in self.node_types:
            if t not in per_dst:
                out_dict[t] = None
                continue
            outs = torch.stack(per_dst[t], 0)              # [P, N, F]
            score = (self.q * torch.tanh(self.k_lin(outs)).mean(1)).sum(-1)
            beta = torch.softmax(score, 0)
            out_dict[t] = torch.einsum('p,pnf->nf', beta, outs)
        return out_dict
