"""Graph normalisation layers.

Counterpart of ``pytorch_geometric_tpu/nn/norm/norms.py`` (reference
``torch_geometric/nn/norm/``). Per-graph statistics go through
``ops.scatter`` with a static ``batch_size``; a ``mask`` marks the valid
(unpadded) node rows, so a padded batch normalises as an unpadded one.

The batch norms (:class:`RunningBatchNorm`, and :class:`BatchNorm` and
:class:`DiffGroupNorm` over it) follow flax's ``BatchNorm``, not
``torch.nn.BatchNorm1d``: the batch variance is E[x^2] - E[x]^2 clamped at
0 (flax's ``use_fast_variance``), and the running variance is updated with
that biased variance (``BatchNorm1d`` would use the unbiased one). They
take no mask: like the JAX package's, they normalise over every row they
are given, padded rows included. Training mode (``module.train()``) uses
and updates the batch statistics, flax's ``use_running_average=False``;
eval mode uses the running ones.
"""

from typing import Optional

import torch
from torch import nn

from ..inits import constant, linear
from ...backend import resolve_device
from ...ops import scatter


def _batch_or_zeros(x: torch.Tensor, batch: Optional[torch.Tensor]):
    if batch is None:
        return torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    return batch.long()


def _gather(stat: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """``stat[batch]`` as JAX indexes: a padded row's graph id may be
    ``batch_size``, past the end; it reads the last graph's statistic (the
    gather clamps), and no gradient flows back through it (the gather's
    transpose drops what lies out of range)."""
    inside = batch < stat.shape[0]
    out = stat[batch.clamp(0, stat.shape[0] - 1)]
    keep = inside.view((-1,) + (1,) * (out.dim() - 1))
    return torch.where(keep, out, out.detach())


class RunningBatchNorm(nn.Module):
    """Batch norm over dim 0 with flax ``BatchNorm``'s arithmetic: in
    training mode ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` over
    the batch's mean and fast variance, and the running statistics
    updated as ``(1 - momentum) * running + momentum * batch``; in eval mode
    the running statistics. ``momentum`` is torch's (the batch's weight):
    flax's default ``momentum=0.99`` is ``momentum=0.01`` here."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.01, affine: bool = True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.momentum = momentum
        if affine:
            self.weight = constant((num_features,), 1.0, device)
            self.bias = constant((num_features,), 0.0, device)
        else:
            self.weight = self.bias = None
        self.register_buffer('running_mean',
                             torch.zeros(num_features, device=device))
        self.register_buffer('running_var',
                             torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(0)
            var = ((x * x).mean(0) - mean * mean).clamp(min=0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - mean) * mul
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return (f'{self.running_mean.shape[0]}, eps={self.eps}, '
                f'momentum={self.momentum}, affine={self.weight is not None}')


class BatchNorm(nn.Module):
    """Batch norm over the node dimension (reference
    ``nn/norm/batch_norm.py:10``): :class:`RunningBatchNorm` as ``bn``
    with torch's ``momentum`` (the JAX package passes flax ``1 -
    momentum``)."""

    def __init__(self, in_channels: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True, device=None):
        super().__init__()
        self.in_channels = in_channels
        self.bn = RunningBatchNorm(in_channels, eps=eps, momentum=momentum,
                                   affine=affine, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class InstanceNorm(nn.Module):
    """Per-graph instance norm over each graph's nodes, channel by
    channel; ``affine`` adds ``weight`` and ``bias``."""

    def __init__(self, in_channels: int, eps: float = 1e-5,
                 affine: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.weight = (constant((in_channels,), 1.0, device) if affine
                       else None)
        self.bias = constant((in_channels,), 0.0, device) if affine else None

    def forward(self, x, batch=None, batch_size: int = 1,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch = _batch_or_zeros(x, batch)
        mean = scatter(x, batch, batch_size, 'mean', mask=mask)
        mean2 = scatter(x * x, batch, batch_size, 'mean', mask=mask)
        var = (mean2 - mean * mean).clamp(min=0)
        out = (x - _gather(mean, batch)) * torch.rsqrt(
            _gather(var, batch) + self.eps)
        if self.weight is not None:
            out = out * self.weight + self.bias
        return out


class _NodeLayerNorm(nn.Module):
    """flax's ``LayerNorm`` over the last axis (fast variance)."""

    def __init__(self, in_channels: int, eps: float, affine: bool, device):
        super().__init__()
        self.eps = eps
        self.weight = (constant((in_channels,), 1.0, device) if affine
                       else None)
        self.bias = constant((in_channels,), 0.0, device) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp(min=0)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - mean) * mul
        return y if self.bias is None else y + self.bias


class LayerNorm(nn.Module):
    """``mode='graph'``: normalise over all nodes and channels of each
    graph; ``mode='node'``: per node over its channels (``ln``)."""

    def __init__(self, in_channels: int, eps: float = 1e-5,
                 affine: bool = True, mode: str = 'graph', device=None):
        super().__init__()
        if mode not in ('graph', 'node'):
            raise ValueError(f"Unknown LayerNorm mode '{mode}'")
        device = resolve_device(device)
        self.eps = eps
        self.mode = mode
        if mode == 'node':
            self.ln = _NodeLayerNorm(in_channels, eps, affine, device)
            self.weight = self.bias = None
        else:
            self.weight = (constant((in_channels,), 1.0, device) if affine
                           else None)
            self.bias = (constant((in_channels,), 0.0, device) if affine
                         else None)

    def forward(self, x, batch=None, batch_size: int = 1,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.mode == 'node':
            return self.ln(x)
        batch = _batch_or_zeros(x, batch)
        mean_c = scatter(x, batch, batch_size, 'mean', mask=mask)
        mean2_c = scatter(x * x, batch, batch_size, 'mean', mask=mask)
        mean = mean_c.mean(-1, keepdim=True)
        var = (mean2_c.mean(-1, keepdim=True) - mean * mean).clamp(min=0)
        out = (x - _gather(mean, batch)) * torch.rsqrt(
            _gather(var, batch) + self.eps)
        if self.weight is not None:
            out = out * self.weight + self.bias
        return out


class GraphNorm(nn.Module):
    """``weight * (x - mean_scale * E[x]) / sqrt(Var + eps) + bias`` per
    graph, ``mean_scale`` learned."""

    def __init__(self, in_channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.mean_scale = constant((in_channels,), 1.0, device)
        self.weight = constant((in_channels,), 1.0, device)
        self.bias = constant((in_channels,), 0.0, device)

    def forward(self, x, batch=None, batch_size: int = 1,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch = _batch_or_zeros(x, batch)
        mean = scatter(x, batch, batch_size, 'mean', mask=mask)
        shifted = x - self.mean_scale * _gather(mean, batch)
        var = scatter(shifted * shifted, batch, batch_size, 'mean',
                      mask=mask)
        return (self.weight * shifted
                * torch.rsqrt(_gather(var, batch) + self.eps) + self.bias)


class GraphSizeNorm(nn.Module):
    """x / sqrt(|V_g|), the size at least 1."""

    def forward(self, x, batch=None, batch_size: int = 1,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch = _batch_or_zeros(x, batch)
        deg = scatter(x.new_ones(x.shape[0]), batch, batch_size, 'sum',
                      mask=mask)
        return x * _gather(deg.clamp(min=1.0).rsqrt(), batch)[:, None]


class PairNorm(nn.Module):
    """Centre each graph, then rescale to a constant mean squared norm
    ('PN'; ``scale_individually``: each row to norm ``scale``, 'PN-SI')."""

    def __init__(self, scale: float = 1.0, scale_individually: bool = False,
                 eps: float = 1e-5):
        super().__init__()
        self.scale = scale
        self.scale_individually = scale_individually
        self.eps = eps

    def forward(self, x, batch=None, batch_size: int = 1,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch = _batch_or_zeros(x, batch)
        mean = scatter(x, batch, batch_size, 'mean', mask=mask)
        xc = x - _gather(mean, batch)
        if self.scale_individually:
            norm = ((xc * xc).sum(-1, keepdim=True) + self.eps).sqrt()
            return self.scale * xc / norm
        msq = scatter((xc * xc).sum(-1), batch, batch_size, 'mean',
                      mask=mask)
        return self.scale * xc * _gather(torch.rsqrt(msq + self.eps),
                                         batch)[:, None]


class MeanSubtractionNorm(nn.Module):
    """x minus its graph's mean (the masked mean of all rows without
    ``batch``)."""

    def forward(self, x, batch=None, batch_size: int = 1,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if batch is None:
            if mask is not None:
                m = mask[:, None].to(x.dtype)
                mean = (x * m).sum(0) / m.sum().clamp(min=1)
            else:
                mean = x.mean(0)
            return x - mean
        batch = batch.long()
        mean = scatter(x, batch, batch_size, 'mean', mask=mask)
        return x - _gather(mean, batch)


class MsgNorm(nn.Module):
    """``msg / ||msg|| * ||x|| * scale`` (GENConv / DeeperGCN), ``scale`` a
    learned scalar with ``learn_scale``."""

    def __init__(self, learn_scale: bool = False, device=None):
        super().__init__()
        self.scale = (constant((1,), 1.0, resolve_device(device))
                      if learn_scale else None)

    def forward(self, x: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        msg_n = msg * torch.rsqrt(
            (msg * msg).sum(-1, keepdim=True).clamp(min=1e-12))
        out = msg_n * (x * x).sum(-1, keepdim=True).sqrt()
        return out if self.scale is None else out * self.scale


class DiffGroupNorm(nn.Module):
    """Group-wise batch norm with a soft cluster assignment: ``x + lamda *
    sum_g s_g * BN_g(s_g * x)``, ``s = softmax(lin(x))``; each ``BN_g`` a
    :class:`RunningBatchNorm` with flax's default momentum."""

    def __init__(self, in_channels: int, groups: int = 4,
                 lamda: float = 0.01, eps: float = 1e-5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.groups = groups
        self.lamda = lamda
        self.lin = linear(in_channels, groups, device=device,
                          generator=generator)
        self.norms = nn.ModuleList(
            RunningBatchNorm(in_channels, eps=eps, device=device)
            for _ in range(groups))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.softmax(self.lin(x), -1)
        out = torch.zeros_like(x)
        for g, norm in enumerate(self.norms):
            sg = s[:, g:g + 1]
            out = out + sg * norm(sg * x)
        return x + self.lamda * out


class HeteroBatchNorm(nn.Module):
    """Per-type batch norm over a flat node tensor and its type vector:
    each type's batch statistics (no running ones), a per-type affine."""

    def __init__(self, in_channels: int, num_types: int = 1,
                 eps: float = 1e-5, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_types = num_types
        self.eps = eps
        self.weight = constant((num_types, in_channels), 1.0, device)
        self.bias = constant((num_types, in_channels), 0.0, device)

    def forward(self, x: torch.Tensor,
                type_vec: torch.Tensor) -> torch.Tensor:
        type_vec = type_vec.long()
        mean = scatter(x, type_vec, self.num_types, 'mean')
        mean2 = scatter(x * x, type_vec, self.num_types, 'mean')
        var = (mean2 - mean * mean).clamp(min=0)
        out = (x - _gather(mean, type_vec)) * torch.rsqrt(
            _gather(var, type_vec) + self.eps)
        return out * self.weight[type_vec] + self.bias[type_vec]


class HeteroLayerNorm(nn.Module):
    """Layer norm over each row's channels (two-pass variance), then a
    per-type affine."""

    def __init__(self, in_channels: int, num_types: int = 1,
                 eps: float = 1e-5, device=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.weight = constant((num_types, in_channels), 1.0, device)
        self.bias = constant((num_types, in_channels), 0.0, device)

    def forward(self, x: torch.Tensor,
                type_vec: torch.Tensor) -> torch.Tensor:
        type_vec = type_vec.long()
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True)
        out = (x - mean) * torch.rsqrt(var + self.eps)
        return out * self.weight[type_vec] + self.bias[type_vec]
