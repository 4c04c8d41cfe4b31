"""XConv, PointCNN's X-transformed convolution.

Counterpart of ``pytorch_geometric_tpu/nn/conv/x_conv.py`` (reference
``torch_geometric/nn/conv/x_conv.py:22-166``). For each point: lift the K
nearest neighbours' relative positions through an MLP, learn a K x K
transform from them (two grouped full-width Conv1d stages), X-permute the
lifted and raw features and run a depthwise-separable convolution. All of
it is dense per-point ``[K, C]`` work; the neighbours come from
``nn/pool/point.py``'s ``knn`` (self included) or ``neighbor_idx``.

The layers keep the JAX package's flax names (``mlp1_lin0``,
``mlp1_bn0``, ``mlp2_conv0``, ``conv_dw``, ``conv_lin``, ...), so
``convert.py`` carries them, the batch norms' statistics included.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..inits import constant, linear
from ...backend import resolve_device


class _DepthwiseFull(nn.Module):
    """torch ``Conv1d(C, C*m, kernel_size=K, groups=C)`` on a length-K
    input (output length 1): ``out[n, c*m + j] = sum_s w[c*m + j, 0, s] *
    h[n, c, s] + b``. The JAX package's weight ``[C*m, 1, K]`` is torch's
    layout already. Initialised as flax's ``lecun_normal`` initialises it
    (fan in ``1 * C*m``)."""

    def __init__(self, channels: int, out_per_in: int, kernel_size: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.groups = channels
        shape = (channels * out_per_in, 1, kernel_size)
        std = math.sqrt(1.0 / shape[0]) / .87962566103423978
        w = torch.empty(shape)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        self.weight = nn.Parameter(w.to(device))
        self.bias = constant((shape[0],), 0.0, device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:      # [N, C, K]
        return F.conv1d(h, self.weight, self.bias, groups=self.groups)[..., 0]


class _BN(nn.Module):
    """The JAX package's batch norm of XConv: always the running statistics
    (``(h - mean) / sqrt(var + 1e-5) * weight + bias``), in training as in
    eval, and never updated; not ``BatchNorm1d``, which follows
    ``.train()``."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = constant((features,), 1.0, device)
        self.bias = constant((features,), 0.0, device)
        self.register_buffer('running_mean',
                             torch.zeros(features, device=device))
        self.register_buffer('running_var',
                             torch.ones(features, device=device))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        inv = torch.reciprocal(torch.sqrt(self.running_var + 1e-5))
        return (h - self.running_mean) * inv * self.weight + self.bias


class XConv(nn.Module):
    """Reference ``x_conv.py`` architecture: mlp1 (lift), mlp2 (the X
    transform through two grouped Conv1d), the depthwise-separable final
    conv. ``in_channels`` 0 means no ``x``. ``neighbor_idx``: optional
    precomputed ``[N, K]`` neighbour indices (each row's K nearest with
    itself, the reference's ``knn_graph(loop=True)``); without it the knn
    of ``nn/pool/point.py`` runs over ``K * dilation`` neighbours, every
    ``dilation``-th kept, and an invalid slot (a masked point, a cloud of
    fewer points) falls back to the centre point."""

    def __init__(self, in_channels: int, out_channels: int, dim: int = 3,
                 kernel_size: int = 8, hidden_channels: Optional[int] = None,
                 dilation: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        K = kernel_size
        self.in_channels, self.out_channels = in_channels, out_channels
        self.dim, self.kernel_size, self.dilation = dim, K, dilation
        if in_channels:
            hid = hidden_channels or max(in_channels // 4, 1)
        else:
            hid = hidden_channels or 1
        self.hidden = hid
        self.mlp1_lin0 = linear(dim, hid, **kw)
        self.mlp1_bn0 = _BN(hid, device)
        self.mlp1_lin1 = linear(hid, hid, **kw)
        self.mlp1_bn1 = _BN(hid, device)
        self.mlp2_lin0 = linear(K * dim, K * K, **kw)
        self.mlp2_bn0 = _BN(K * K, device)
        self.mlp2_conv0 = _DepthwiseFull(K, K, K, **kw)
        self.mlp2_bn1 = _BN(K * K, device)
        self.mlp2_conv1 = _DepthwiseFull(K, K, K, **kw)
        self.mlp2_bn2 = _BN(K * K, device)
        c = hid + in_channels
        m = int(math.ceil(out_channels / c))
        self.conv_dw = _DepthwiseFull(c, m, K, **kw)
        self.conv_lin = linear(c * m, out_channels, **kw)

    def forward(self, x: Optional[torch.Tensor], pos: torch.Tensor,
                batch: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                neighbor_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = pos.shape[0]
        K, dil = self.kernel_size, self.dilation
        if neighbor_idx is None:
            from ..pool.point import knn
            ei, valid = knn(pos, pos, K * dil, batch, batch, mask, mask)
            idx = ei[1].reshape(n, K * dil)
            vmask = valid.reshape(n, K * dil)
            if dil > 1:
                # the reference's edge_index[:, ::dilation]: at this layout
                # a row-major stride is a per-node stride
                idx, vmask = idx[:, ::dil], vmask[:, ::dil]
            centre = torch.arange(n, device=pos.device)[:, None]
            idx = torch.where(vmask, idx.clamp(max=n - 1), centre)
        else:
            idx = neighbor_idx.long()

        rel = pos[idx] - pos[:, None, :]                     # [N, K, D]

        # mlp1: Lin-ELU-BN-Lin-ELU-BN on [N*K, D] (reference :92-100)
        h = rel.reshape(n * K, self.dim)
        h = self.mlp1_bn0(F.elu(self.mlp1_lin0(h)))
        h = self.mlp1_bn1(F.elu(self.mlp1_lin1(h)))
        x_star = h.reshape(n, K, self.hidden)
        if x is not None:
            x_star = torch.cat([x_star, x[idx]], -1)
        x_star = x_star.transpose(1, 2)                      # [N, C, K]

        # mlp2: the K x K transform (reference :102-116)
        t = rel.reshape(n, K * self.dim)
        t = self.mlp2_bn0(F.elu(self.mlp2_lin0(t)))
        t = self.mlp2_conv0(t.reshape(n, K, K))
        t = self.mlp2_bn1(F.elu(t))
        t = self.mlp2_conv1(t.reshape(n, K, K))
        transform = self.mlp2_bn2(t).reshape(n, K, K)

        x_t = torch.matmul(x_star, transform)                # [N, C, K]

        # the depthwise-separable conv (reference :118-124)
        return self.conv_lin(self.conv_dw(x_t))
