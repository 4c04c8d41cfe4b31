"""Learnable set aggregations built on attention or an inner optimisation:
SetTransformer, GraphMultisetTransformer, LCM, PatchTransformer and
Equilibrium.

Counterpart of ``pytorch_geometric_tpu/nn/aggr/advanced.py`` (reference
``torch_geometric/nn/aggr/set_transformer.py``, ``gmt.py``, ``lcm.py``,
``patch_transformer.py`` and ``equilibrium.py``). The attention is flax's
``MultiHeadDotProductAttention`` as ``nn/attention/mha.py`` computes it,
and the LayerNorms are flax's (epsilon 1e-6); all plain PyTorch, as the JAX
package's are XLA.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .base import Aggregation
from ..attention.mha import MultiHeadDotProductAttention
from ..inits import glorot, gru_cell, linear
from ...backend import resolve_device


class _MAB(nn.Module):
    """Multi-head attention block, the Set Transformer's unit: ``h =
    ln1(q + att(q, kv))``, ``ln2(h + ff(relu(h)))``; ``kv_mask`` marks the
    valid keys."""

    def __init__(self, channels: int, heads: int = 4, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.att = MultiHeadDotProductAttention(channels, heads, **kw)
        self.ln1 = nn.LayerNorm(channels, eps=1e-6, device=device)
        self.ff = linear(channels, channels, **kw)
        self.ln2 = nn.LayerNorm(channels, eps=1e-6, device=device)

    def forward(self, q, kv, kv_mask=None):
        mask = None if kv_mask is None else kv_mask[:, None, None, :]
        h = self.ln1(q + self.att(q, kv, mask))
        return self.ln2(h + self.ff(F.relu(h)))


class SetTransformerAggregation(Aggregation):
    """``lin_in`` to ``channels``, ``num_encoder_blocks`` self-attention
    blocks (``sabs``), then pooling by attention from ``num_seed_points``
    learned seeds (``pma``), flattened to ``[dim_size, num_seed_points *
    channels]`` (reference ``set_transformer.py``)."""

    def __init__(self, in_channels: int, channels: int = 64,
                 num_seed_points: int = 1, heads: int = 4,
                 num_encoder_blocks: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.channels, self.num_seed_points = channels, num_seed_points
        self.lin_in = linear(in_channels, channels, **kw)
        self.sabs = nn.ModuleList([_MAB(channels, heads, **kw)
                                   for _ in range(num_encoder_blocks)])
        self.seed = glorot((num_seed_points, channels), device, generator)
        self.pma = _MAB(channels, heads, **kw)

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        dense, valid = self.to_dense(x, index, dim_size, mask,
                                     max_num_elements)
        h = self.lin_in(dense)
        for sab in self.sabs:
            h = sab(h, h, valid)
        q = self.seed[None].expand((dim_size,) + tuple(self.seed.shape))
        out = self.pma(q, h, valid)
        return out.reshape(dim_size, self.num_seed_points * self.channels)


class GraphMultisetTransformer(SetTransformerAggregation):
    """GMT (reference ``gmt.py``): the Set Transformer pooling with 4 seed
    points by default."""

    def __init__(self, in_channels: int, channels: int = 64,
                 num_seed_points: int = 4, heads: int = 4,
                 num_encoder_blocks: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, channels, num_seed_points, heads,
                         num_encoder_blocks, device, generator)


class LCMAggregation(Aggregation):
    """Learnable commutative monoid (reference ``lcm.py``): ``lin_in``,
    then a balanced binary reduction over the segment padded to a power of
    two, each pair of valid entries combined by a GRU cell (``combine``,
    the left one as hidden state), a lone valid entry passed on."""

    def __init__(self, in_channels: int, out_channels: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        c = out_channels or in_channels
        self.lin_in = linear(in_channels, c, device=device,
                             generator=generator)
        self.combine = gru_cell(c, c, device, generator)

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        dense, valid = self.to_dense(x, index, dim_size, mask,
                                     max_num_elements)
        h = torch.where(valid[..., None], self.lin_in(dense), 0.0)
        L = h.shape[1]
        L2 = 1 << max(1, math.ceil(math.log2(max(L, 1))))
        h = F.pad(h, (0, 0, 0, L2 - L))
        v = F.pad(valid, (0, L2 - L))
        while h.shape[1] > 1:
            a, b = h[:, 0::2], h[:, 1::2]
            va, vb = v[:, 0::2], v[:, 1::2]
            B, P, C = a.shape
            merged = self.combine(b.reshape(B * P, C),
                                  a.reshape(B * P, C)).reshape(B, P, C)
            both = va & vb
            h = torch.where(both[..., None], merged,
                            torch.where(va[..., None], a, b))
            v = va | vb
            h = torch.where(v[..., None], h, 0.0)
        return h[:, 0]


class PatchTransformerAggregation(Aggregation):
    """Each segment cut into patches of ``patch_size`` rows, each patch
    embedded (``patch_embed`` over its ``P * F`` values), one
    self-attention block over the patches (``enc``), the valid patches
    averaged (reference ``patch_transformer.py``)."""

    def __init__(self, in_channels: int, channels: int = 64,
                 patch_size: int = 8, heads: int = 4, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.patch_size = patch_size
        self.patch_embed = linear(patch_size * in_channels, channels, **kw)
        self.enc = _MAB(channels, heads, **kw)

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        dense, valid = self.to_dense(x, index, dim_size, mask,
                                     max_num_elements)
        B, L, Fw = dense.shape
        P = self.patch_size
        L2 = ((L + P - 1) // P) * P
        dense = F.pad(dense, (0, 0, 0, L2 - L))
        valid = F.pad(valid, (0, L2 - L))
        ph = dense.reshape(B, L2 // P, P * Fw)
        pv = valid.reshape(B, L2 // P, P).any(-1)
        h = self.patch_embed(ph)
        h = torch.where(pv[..., None], self.enc(h, h, pv), 0.0)
        return h.sum(1) / pv.sum(1, keepdim=True).clamp(min=1)


class EquilibriumAggregation(Aggregation):
    """Implicit aggregation by an inner energy minimisation (reference
    ``equilibrium.py``): ``y* = argmin_y sum_i E(x_i, y_seg(i)) + |y|^2 /
    2``, ``E`` the MLP ``potential_out(softplus(potential_hidden([x_i,
    y])))``, from ``y = 0`` by ``num_steps`` steps of gradient descent.

    Each step takes ``torch.autograd.grad`` of the energy (under a local
    ``torch.enable_grad``), with ``create_graph`` when the caller records
    gradients, so a training step differentiates through the unrolled
    steps, as ``jax.grad`` unrolled does. Under ``torch.no_grad`` the steps
    run all the same and the result is detached. Under
    ``torch.inference_mode`` autograd cannot run at all, and the call
    raises ``RuntimeError`` rather than returning anything else."""

    def __init__(self, in_channels: int, out_channels: int = 0,
                 num_steps: int = 10, grad_step: float = 0.1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.out_channels = out_channels or in_channels
        self.num_steps, self.grad_step = num_steps, grad_step
        kw = dict(device=device, generator=generator)
        self.potential_hidden = linear(in_channels + self.out_channels, 32,
                                       **kw)
        self.potential_out = linear(32, 1, **kw)

    def aggregate(self, x, index, dim_size, mask, max_num_elements):
        if torch.is_inference_mode_enabled():
            raise RuntimeError(
                'EquilibriumAggregation descends the gradient of its energy '
                'and so needs autograd, which torch.inference_mode turns '
                'off; call it under torch.no_grad instead')
        graph = torch.is_grad_enabled()
        if x.is_inference():
            x = x.clone()
        index = index.long()
        # a row outside [0, dim_size) (the sentinel) adds no energy
        inside = (index >= 0) & (index < dim_size)
        if mask is not None:
            inside = inside & mask
        idx = index.clamp(0, dim_size - 1)
        y = x.new_zeros((dim_size, self.out_channels))
        with torch.enable_grad():
            for _ in range(self.num_steps):
                if not y.requires_grad:
                    y = y.requires_grad_()
                z = torch.cat([x, y[idx]], -1)
                e = self.potential_out(F.softplus(
                    self.potential_hidden(z)))[:, 0]
                e = torch.where(inside, e, 0.0)
                energy = e.sum() + 0.5 * (y ** 2).sum()
                g, = torch.autograd.grad(energy, y, create_graph=graph)
                y = y - self.grad_step * g
        return y if graph else y.detach()
