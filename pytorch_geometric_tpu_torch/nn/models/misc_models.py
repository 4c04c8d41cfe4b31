"""The model zoo: JumpingKnowledge, DeepGraphInfomax, LightGCN,
LabelPropagation, CorrectAndSmooth, LINKX, PMLP, MaskLabel, MetaLayer,
NeuralFingerprint, DeepGCNLayer, GraphUNet, HeteroJumpingKnowledge,
ARLinkPredictor and the captum stubs.

Counterpart of ``pytorch_geometric_tpu/nn/models/misc_models.py``
(reference ``torch_geometric/nn/models/jumping_knowledge.py``,
``deep_graph_infomax.py``, ``lightgcn.py``, ``label_prop.py``,
``correct_and_smooth.py``, ``linkx.py``, ``pmlp.py``, ``mask_label.py``,
``meta.py``, ``neural_fingerprint.py``, ``deep_gcn_layer.py``,
``graph_unet.py``, ``attract_repel.py``).

Every propagation here is a gather and a scatter over the raw COO
(``MessagePassing``'s plain path), as in the JAX package: no port kernel
runs. Where the JAX code draws from an RNG key (``ARLinkPredictor``'s
dropout, ``MaskLabel.ratio_mask``), the port takes a ``torch.Generator``.
Submodules and parameters are named as the flax modules name theirs
(``lstm_f``, ``att``, ``weight``, ``edge_embed``, ``cat_lin1``, ``lins_i``
-> ``lins.i``, ``bias_i``, ``convs_i`` -> ``convs.i``, ``jk_{type}``,
``down_convs_i`` / ``down_convs_i_bias``, ``pools_i_weight`` ...),
so ``convert.flax_to_state_dict`` carries them across.
"""

from typing import Callable, Iterable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..aggr.attention import _LSTMCell
from ..conv.gcn_conv import gcn_norm
from ..conv.graph_conv import LGConv, MFConv, _WeightedGather, _coo
from ..inits import constant, embedding, glorot, linear
from ..norm.norms import RunningBatchNorm
from ..pool import global_add_pool
from ..pool.select import top_k
from ...backend import resolve_device
from ...ops import scatter
from .mlp import MLP


def _draw(shape, generator: Optional[torch.Generator], like: torch.Tensor,
          normal: bool = False) -> torch.Tensor:
    """Uniform (or standard normal) draws of ``shape`` from ``generator`` on
    the generator's own device, moved to ``like``'s device and dtype."""
    device = generator.device if generator is not None else like.device
    fn = torch.randn if normal else torch.rand
    return fn(shape, generator=generator, device=device,
              dtype=like.dtype).to(like.device)


class JumpingKnowledge(nn.Module):
    """Combine per-layer representations (reference
    ``jumping_knowledge.py``): ``'cat'``, ``'max'`` or ``'lstm'``. The lstm
    mode scores each layer with a bidirectional LSTM, two flax-style cells
    ``lstm_f`` and ``lstm_b`` of hidden size ``(num_layers * channels) //
    2`` (reference ``:58``, JAX ``misc_models.py:40-62``), and ``att`` over
    both directions; it needs ``channels`` and ``num_layers``."""

    def __init__(self, mode: str = 'cat', channels: Optional[int] = None,
                 num_layers: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ('cat', 'max', 'lstm'):
            raise ValueError(f"Unknown JK mode '{mode}'")
        self.mode, self.channels, self.num_layers = mode, channels, num_layers
        if mode == 'lstm':
            if channels is None or num_layers is None:
                raise ValueError("mode 'lstm' needs channels and num_layers")
            device = resolve_device(device)
            hidden = (num_layers * channels) // 2
            kw = dict(device=device, generator=generator)
            self.lstm_f = _LSTMCell(channels, hidden, **kw)
            self.lstm_b = _LSTMCell(channels, hidden, **kw)
            self.att = linear(2 * hidden, 1, **kw)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        if self.mode == 'cat':
            return torch.cat(list(xs), -1)
        if self.mode == 'max':
            return torch.stack(list(xs), 0).amax(0)
        x = torch.stack(list(xs), 1)                      # [N, L, F]
        n, L = x.shape[:2]
        zeros = x.new_zeros((n, self.lstm_f.features))
        cf = cb = (zeros, zeros)
        outs_f, outs_b = [], []
        for t in range(L):
            cf, of = self.lstm_f(cf, x[:, t])
            cb, ob = self.lstm_b(cb, x[:, L - 1 - t])
            outs_f.append(of)
            outs_b.append(ob)
        h = torch.cat([torch.stack(outs_f, 1),
                       torch.stack(outs_b[::-1], 1)], -1)
        alpha = torch.softmax(self.att(h)[..., 0], -1)    # [N, L]
        return (x * alpha[..., None]).sum(1)


class DeepGraphInfomax(nn.Module):
    """Deep Graph Infomax (reference ``deep_graph_infomax.py``): the
    encoder on the inputs and on ``corruption(*args)``, a summary
    (``sigmoid(z.mean(0))`` unless ``summary`` is given) and the bilinear
    discriminator ``z W s``. ``forward`` returns ``(pos_z, neg_z,
    summary)``; without ``corruption``, ``neg_z`` is ``pos_z``."""

    def __init__(self, hidden_channels: int, encoder: nn.Module,
                 summary: Optional[Callable] = None,
                 corruption: Optional[Callable] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.encoder = encoder
        self.summary = summary
        self.corruption = corruption
        self.weight = glorot((hidden_channels, hidden_channels),
                             resolve_device(device), generator)

    def forward(self, *args, **kwargs):
        pos_z = self.encoder(*args, **kwargs)
        if self.corruption is not None:
            cor = self.corruption(*args, **kwargs)
            cor = cor if isinstance(cor, tuple) else (cor,)
            neg_z = self.encoder(*cor, **kwargs)
        else:
            neg_z = pos_z
        s = (self.summary(pos_z, *args, **kwargs) if self.summary is not None
             else torch.sigmoid(pos_z.mean(0)))
        return pos_z, neg_z, s

    def discriminate(self, z, summary, sigmoid: bool = True):
        value = z @ self.weight @ summary
        return torch.sigmoid(value) if sigmoid else value

    def loss(self, pos_z, neg_z, summary) -> torch.Tensor:
        eps = 1e-15
        pos = self.discriminate(pos_z, summary)
        neg = self.discriminate(neg_z, summary)
        return -torch.log(pos + eps).mean() - torch.log(1 - neg + eps).mean()


class LightGCN(nn.Module):
    """LightGCN (reference ``lightgcn.py``): the node embedding table
    (``weight``, the flax module's own ``embedding``) propagated by
    ``num_layers`` LGConvs, the layers averaged with ``alpha`` (``1 / (L +
    1)`` each by default); ``forward`` scores ``label_index`` pairs ``[2,
    K]`` by their embeddings' dot product."""

    def __init__(self, num_nodes: int, embedding_dim: int,
                 num_layers: int = 2, alpha: Optional[Sequence[float]] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_nodes, self.embedding_dim = num_nodes, embedding_dim
        self.num_layers = num_layers
        alpha = (torch.full((num_layers + 1,), 1.0 / (num_layers + 1))
                 if alpha is None else torch.as_tensor(alpha,
                                                       dtype=torch.float32))
        self.register_buffer('alpha', alpha.to(device), persistent=False)
        w = torch.randn((num_nodes, embedding_dim), generator=generator)
        self.weight = nn.Parameter((0.1 * w).to(device))
        self.convs = nn.ModuleList(LGConv() for _ in range(num_layers))

    def get_embedding(self, edge_index,
                      edge_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        x = self.weight
        out = self.alpha[0] * x
        for i, conv in enumerate(self.convs):
            x = conv(x, edge_index, edge_mask=edge_mask)
            out = out + self.alpha[i + 1] * x
        return out

    def forward(self, edge_index, label_index,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        z = self.get_embedding(edge_index, edge_mask)
        return (z[label_index[0]] * z[label_index[1]]).sum(-1)

    @staticmethod
    def recommendation_loss(pos_scores, neg_scores, lambda_reg: float = 1e-4,
                            params: Optional[Iterable[torch.Tensor]] = None
                            ) -> torch.Tensor:
        """BPR loss (reference ``lightgcn.py:BPRLoss``), plus ``lambda_reg``
        times the squared norm of ``params`` when given."""
        loss = -F.logsigmoid(pos_scores - neg_scores).mean()
        if params is not None and lambda_reg > 0:
            loss = loss + lambda_reg * sum((p ** 2).sum() for p in params)
        return loss


class LabelPropagation(_WeightedGather):
    """Label propagation (reference ``label_prop.py``): ``num_layers``
    rounds of ``y <- alpha A_hat y + (1 - alpha) y_0``, each followed by
    ``post_step`` (by default a clip to ``[0, 1]``); ``A_hat`` the GCN
    normalisation without self loops, in ``y``'s dtype. ``label_mask``
    zeroes the unlabelled rows first. An ``EdgeIndex`` is stripped to its
    COO (``gcn_norm``) and every round is a gather and an ``index_add_``
    over the edges, as the JAX package's XLA scatter: no SpMM."""

    def __init__(self, num_layers: int = 3, alpha: float = 0.9):
        super().__init__()
        self.num_layers, self.alpha = num_layers, alpha

    def forward(self, y: torch.Tensor, edge_index,
                label_mask: Optional[torch.Tensor] = None,
                edge_weight: Optional[torch.Tensor] = None,
                post_step: Optional[Callable] = None) -> torch.Tensor:
        n = y.shape[0]
        if label_mask is not None:
            y = torch.where(label_mask[:, None], y, 0)
        coo, ew = gcn_norm(edge_index, edge_weight, n, add_self_loops=False,
                           dtype=y.dtype)
        res = (1 - self.alpha) * y
        out = y
        for _ in range(self.num_layers):
            out = self.propagate(coo, x=out, edge_weight=ew, size=(n, n))
            out = self.alpha * out + res
            out = (post_step(out) if post_step is not None
                   else out.clamp(0.0, 1.0))
        return out


class CorrectAndSmooth:
    """Correct & Smooth post-processing (reference
    ``correct_and_smooth.py``), a plain callable without parameters.

    ``correct`` propagates the training rows' error ``y_true - y_soft``:
    with ``autoscale`` each hop clips it to ``[-1, 1]`` and the result is
    scaled per node to the training rows' mean error (a scale past 1000 or
    not finite becomes 1); without, each hop re-pins the training rows to
    their error (the reference's ``fix_input``, in place of
    LabelPropagation's clip) and the result is scaled by ``scale``.
    ``smooth`` propagates ``y_true`` on the training rows and the corrected
    ``y_soft`` elsewhere. ``y_true`` is ``[N, C]`` (one-hot), as
    ``y_soft``."""

    def __init__(self, num_correction_layers: int = 10,
                 correction_alpha: float = 0.8,
                 num_smoothing_layers: int = 10,
                 smoothing_alpha: float = 0.8, scale: float = 1.0,
                 autoscale: bool = True):
        self.num_correction_layers = num_correction_layers
        self.correction_alpha = correction_alpha
        self.num_smoothing_layers = num_smoothing_layers
        self.smoothing_alpha = smoothing_alpha
        self.scale = scale
        self.autoscale = autoscale

    def correct(self, y_soft, y_true, train_mask, edge_index,
                edge_weight=None):
        err = torch.where(train_mask[:, None], y_true - y_soft, 0)
        lp = LabelPropagation(self.num_correction_layers,
                              self.correction_alpha)
        if self.autoscale:
            sm = lp(err, edge_index, edge_weight=edge_weight,
                    post_step=lambda x: x.clamp(-1.0, 1.0))
            numel = train_mask.sum().clamp(min=1)
            sigma = err.abs().sum() / numel
            scale = sigma / sm.abs().sum(-1, keepdim=True).clamp(min=1e-30)
            scale = torch.where((scale > 1000) | ~torch.isfinite(scale), 1.0,
                                scale)
            return y_soft + scale * sm
        sm = lp(err, edge_index, edge_weight=edge_weight,
                post_step=lambda x: torch.where(train_mask[:, None], err, x))
        return y_soft + self.scale * sm

    def smooth(self, y_soft, y_true, train_mask, edge_index):
        y = torch.where(train_mask[:, None], y_true, y_soft)
        return LabelPropagation(self.num_smoothing_layers,
                                self.smoothing_alpha)(y, edge_index)

    def __call__(self, y_soft, y_true, train_mask, edge_index):
        out = self.correct(y_soft, y_true, train_mask, edge_index)
        return self.smooth(out, y_true, train_mask, edge_index)


class LINKX(nn.Module):
    """LINKX (reference ``linkx.py``): ``MLP_A(A) + MLP_X(x)`` into
    ``final_mlp``. ``A``'s side is a sparse Linear, ``A @ edge_embed +
    edge_bias`` as one scatter over the edges (then ReLU, ``edge_norm`` and
    ``edge_mlp`` when ``num_edge_layers > 1``); ``W [h_A | h_X]`` is
    ``cat_lin1(h_A) + cat_lin2(h_X)``. Batch norms use batch statistics in
    training mode and running ones in eval mode. Without ``in_channels``
    the node side is left out (``x`` is ``None``)."""

    def __init__(self, num_nodes: int, in_channels: Optional[int],
                 hidden_channels: int, out_channels: int,
                 num_layers: int = 1, num_edge_layers: int = 1,
                 num_node_layers: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_nodes = num_nodes
        h = hidden_channels
        kw = dict(device=device, generator=generator)
        self.edge_embed = nn.Parameter(
            (0.02 * torch.randn((num_nodes, h), generator=generator))
            .to(device))
        self.edge_bias = constant((h,), 0.0, device)
        self.num_edge_layers = num_edge_layers
        if num_edge_layers > 1:
            self.edge_norm = RunningBatchNorm(h, device=device)
            self.edge_mlp = MLP(h, [h] * (num_edge_layers - 1),
                                norm='batch_norm', act_first=True, **kw)
        self.cat_lin1 = linear(h, h, **kw)
        if in_channels is not None:
            self.node_mlp = MLP(in_channels, [h] * num_node_layers,
                                norm='batch_norm', act_first=True, **kw)
            self.cat_lin2 = linear(h, h, **kw)
        self.final_mlp = MLP(h, [h] * (num_layers - 1) + [out_channels],
                             norm='batch_norm', act_first=True, **kw)

    def forward(self, x: Optional[torch.Tensor], edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        coo = _coo(edge_index)
        n = self.num_nodes
        w_src = self.edge_embed[coo[0].long().clamp(max=n - 1)]
        if edge_weight is not None:
            w_src = w_src * edge_weight[:, None]
        out = scatter(w_src, coo[1].long().clamp(max=n - 1), n, 'sum',
                      mask=edge_mask) + self.edge_bias
        if self.num_edge_layers > 1:
            out = self.edge_mlp(self.edge_norm(torch.relu(out)))
        out = out + self.cat_lin1(out)
        if x is not None:
            xx = self.node_mlp(x)
            out = out + xx + self.cat_lin2(xx)
        return self.final_mlp(torch.relu(out))


class PMLP(nn.Module):
    """PMLP (reference ``pmlp.py``): an MLP in training; with ``use_conv``
    each Linear (``lins.i``, no bias) is followed by the mean over the
    node's in-neighbours and itself (``SimpleConv(aggr='mean',
    combine_root='self_loop')``) before its bias ``bias_i``. The hidden
    layers normalise by the batch's statistics (no affine, no running
    statistics, reference ``pmlp.py:61``) and take a ReLU. ``dropout`` is
    kept for the signature and, as in the JAX package, not applied. An edge
    at the padding sentinel is clamped to the last node, as there."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, num_layers: int = 2,
                 dropout: float = 0.0, norm: bool = True,
                 use_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_layers, self.dropout, self.norm = num_layers, dropout, norm
        self.use_bias = use_bias
        widths = ([in_channels] + [hidden_channels] * (num_layers - 1)
                  + [out_channels])
        self.lins = nn.ModuleList(
            linear(i, o, bias=False, device=device, generator=generator)
            for i, o in zip(widths[:-1], widths[1:]))
        if use_bias:
            for i, o in enumerate(widths[1:]):
                self.register_parameter(f'bias_{i}',
                                        constant((o,), 0.0, device))

    def forward(self, x, edge_index=None,
                use_conv: bool = False) -> torch.Tensor:
        for i, lin in enumerate(self.lins):
            x = lin(x)
            if use_conv and edge_index is not None:
                n = x.shape[0]
                coo = _coo(edge_index)
                s = coo[0].long().clamp(max=n - 1)
                d = coo[1].long().clamp(max=n - 1)
                total = scatter(x[s], d, n, 'sum')
                count = scatter(x.new_ones((coo.shape[1], 1)), d, n, 'sum')
                x = (total + x) / (count + 1.0)
            if self.use_bias:
                x = x + getattr(self, f'bias_{i}')
            if i < self.num_layers - 1:
                if self.norm:
                    mean = x.mean(0, keepdim=True)
                    var = x.var(0, unbiased=False, keepdim=True)
                    x = (x - mean) * torch.rsqrt(var + 1e-5)
                x = torch.relu(x)
        return x


class MaskLabel(nn.Module):
    """UniMP's label embedding (reference ``mask_label.py``): ``emb(y)``
    on the rows of ``mask``, added to ``x`` (``'add'``) or concatenated."""

    def __init__(self, num_classes: int, out_channels: int,
                 method: str = 'add', device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.method = method
        self.emb = embedding(num_classes, out_channels,
                             device=resolve_device(device),
                             generator=generator)

    def forward(self, x, y, mask) -> torch.Tensor:
        emb = torch.where(mask[:, None], self.emb(y.clamp(min=0)), 0)
        if self.method == 'add':
            return x + emb
        return torch.cat([x, emb], -1)

    @staticmethod
    def ratio_mask(mask: torch.Tensor, ratio: float,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """``mask`` with each entry kept with probability ``1 - ratio``."""
        return mask & (_draw(mask.shape, generator,
                             torch.empty(0, device=mask.device)) > ratio)


class MetaLayer(nn.Module):
    """Edge, node and global update block (reference ``meta.py``):
    ``edge_model(x_src, x_dst, edge_attr, u, batch[src])``, then
    ``node_model(x, coo, edge_attr, u, batch)``, then ``global_model(x,
    coo, edge_attr, u, batch)``; each is optional. Returns ``(x,
    edge_attr, u)``."""

    def __init__(self, edge_model: Optional[nn.Module] = None,
                 node_model: Optional[nn.Module] = None,
                 global_model: Optional[nn.Module] = None):
        super().__init__()
        self.edge_model = edge_model
        self.node_model = node_model
        self.global_model = global_model

    def forward(self, x, edge_index, edge_attr=None, u=None, batch=None,
                batch_size: int = 1,
                edge_mask: Optional[torch.Tensor] = None):
        coo = _coo(edge_index)
        n = x.shape[0]
        src = coo[0].long().clamp(max=n - 1)
        dst = coo[1].long().clamp(max=n - 1)
        if self.edge_model is not None:
            eb = None if batch is None else batch[src]
            edge_attr = self.edge_model(x[src], x[dst], edge_attr, u, eb)
        if self.node_model is not None:
            x = self.node_model(x, coo, edge_attr, u, batch)
        if self.global_model is not None:
            u = self.global_model(x, coo, edge_attr, u, batch)
        return x, edge_attr, u


class NeuralFingerprint(nn.Module):
    """Duvenaud's fingerprints (reference ``neural_fingerprint.py``): per
    layer ``x = sigmoid(MFConv(x))`` and ``softmax(lins[i](x))`` (no bias)
    summed over each graph into the ``[batch_size, out_channels]``
    fingerprint."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, num_layers: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.out_channels = out_channels
        kw = dict(device=device, generator=generator)
        self.convs = nn.ModuleList(
            MFConv(in_channels if i == 0 else hidden_channels,
                   hidden_channels, **kw) for i in range(num_layers))
        self.lins = nn.ModuleList(
            linear(hidden_channels, out_channels, bias=False, **kw)
            for _ in range(num_layers))

    def forward(self, x, edge_index, batch=None, batch_size: int = 1,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = x.new_zeros((batch_size, self.out_channels))
        for conv, lin in zip(self.convs, self.lins):
            x = torch.sigmoid(conv(x, edge_index))
            y = torch.softmax(lin(x), -1)
            out = out + global_add_pool(y, batch, batch_size, mask=node_mask)
        return out


class DeepGCNLayer(nn.Module):
    """Pre- or post-activation residual block (reference
    ``deep_gcn_layer.py``): ``'res+'`` is ``x + conv(act(norm(x)))``;
    ``'res'``, ``'dense'`` and ``'plain'`` apply ``conv``, ``norm`` and
    ``act`` in that order and then add ``x``, concatenate it in front, or
    neither. ``dropout`` is kept for the signature and, as in the JAX
    package, not applied."""

    def __init__(self, conv: nn.Module, norm: Optional[nn.Module] = None,
                 act: Callable = torch.relu, block: str = 'res+',
                 dropout: float = 0.0):
        super().__init__()
        self.conv, self.norm = conv, norm
        self.act, self.block, self.dropout = act, block, dropout

    def forward(self, x, *args, **kwargs) -> torch.Tensor:
        if self.block == 'res+':
            h = x if self.norm is None else self.norm(x)
            return x + self.conv(self.act(h), *args, **kwargs)
        h = self.conv(x, *args, **kwargs)
        if self.norm is not None:
            h = self.norm(h)
        h = self.act(h)
        if self.block == 'res':
            return x + h
        if self.block == 'dense':
            return torch.cat([x, h], -1)
        return h


class GraphUNet(nn.Module):
    """Graph U-Net (reference ``graph_unet.py``): GCN layers and top-k
    pooling down ``depth`` levels, the adjacency augmented to ``(A +
    I)^2`` (self loops removed) before each pool, then unpooling by scatter
    and a skip sum (or concatenation) up.

    As in the JAX package, the levels run on dense adjacencies: the
    augmented ``A^2`` has data-dependent sparsity, so each level is one
    ``[n_l, n_l]`` matrix product and pooling is a row and column gather,
    each level's size ``ceil(ratio^l N)`` static; U-Nets run on modest
    graphs. The GCN layers are the reference's ``GCNConv(improved=True)``
    (missing self loops filled with 2). The pooling score is ``x p /
    |p|`` and its top-k breaks ties to the lowest node, as
    ``jax.lax.top_k`` does; the kept rows are gated by ``tanh`` of their
    score. One graph: ``batch`` is ignored, as there."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, depth: int = 3, pool_ratio: float = 0.5,
                 sum_res: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        H = hidden_channels
        self.hidden_channels, self.out_channels = H, out_channels
        self.depth, self.pool_ratio, self.sum_res = depth, pool_ratio, sum_res

        def conv(name, fan_in, out_ch):
            setattr(self, name, linear(fan_in, out_ch, bias=False, **kw))
            setattr(self, f'{name}_bias', constant((out_ch,), 0.0, device))

        conv('down_convs_0', in_channels, H)
        for i in range(1, depth + 1):
            self.register_parameter(f'pools_{i - 1}_weight', nn.Parameter(
                torch.rand((1, H), generator=generator).to(device)))
            conv(f'down_convs_{i}', H, H)
        for i in range(depth):
            conv(f'up_convs_{i}', H if sum_res else 2 * H,
                 H if i < depth - 1 else out_channels)

    @staticmethod
    def _gcn_agg(A, h):
        """Dense GCN aggregation ``D^-1/2 A_hat D^-1/2 h``: ``A_hat`` keeps
        existing self-loop weights and fills missing ones with 2 (the
        reference's ``GCNConv(improved=True)``)."""
        n = A.shape[0]
        diag = torch.diagonal(A)
        fill = torch.where(diag == 0, 2.0, 0.0)
        Ah = A + torch.eye(n, dtype=A.dtype, device=A.device) * fill
        deg = Ah.sum(1)
        dinv = torch.where(deg > 0, deg.rsqrt(), 0.0)
        return (dinv[:, None] * Ah * dinv[None, :]) @ h

    def _conv(self, name, A, x):
        return self._gcn_agg(A, getattr(self, name)(x)) + getattr(
            self, f'{name}_bias')

    def forward(self, x, edge_index,
                edge_weight: Optional[torch.Tensor] = None,
                batch: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        del batch                         # one graph, dense
        n = x.shape[0]
        coo = _coo(edge_index)
        w = x.new_ones(coo.shape[1]) if edge_weight is None else edge_weight
        if edge_mask is not None:
            w = torch.where(edge_mask, w, 0.0)
        src = coo[0].long().clamp(max=n - 1)
        dst = coo[1].long().clamp(max=n - 1)
        # transposed adjacency: A[i, j] sums the weights of the edges j -> i,
        # so the aggregation is one row-major product
        A = x.new_zeros((n, n)).index_put((dst, src), w, accumulate=True)

        x = F.relu(self._conv('down_convs_0', A, x))
        xs, adjs, perms = [x], [A], []
        cur_x, cur_A, cur_n = x, A, n
        for i in range(1, self.depth + 1):
            # augment: (A + I)^2 with the self loops removed
            eye = torch.eye(cur_n, dtype=x.dtype, device=x.device)
            A1 = cur_A * (1 - eye) + eye
            A2 = (A1 @ A1) * (1 - eye)
            pw = getattr(self, f'pools_{i - 1}_weight')
            score = (cur_x * pw).sum(-1) / torch.linalg.vector_norm(
                pw).clamp(min=1e-12)
            k = max(int(-(-self.pool_ratio * cur_n // 1)), 1)
            # ties to the lowest node, as jax.lax.top_k breaks them
            perm = top_k(score, k)[1]
            cur_x = cur_x[perm] * torch.tanh(score[perm])[:, None]
            cur_A = A2[perm][:, perm]
            cur_n = k
            cur_x = F.relu(self._conv(f'down_convs_{i}', cur_A, cur_x))
            perms.append(perm)
            if i < self.depth:
                xs.append(cur_x)
                adjs.append(cur_A)

        for i in range(self.depth):
            j = self.depth - 1 - i
            res, A_j, perm = xs[j], adjs[j], perms[j]
            up = torch.zeros_like(res).index_put((perm,), cur_x)
            cur_x = res + up if self.sum_res else torch.cat([res, up], -1)
            cur_x = self._conv(f'up_convs_{i}', A_j, cur_x)
            if i < self.depth - 1:
                cur_x = F.relu(cur_x)
        return cur_x


class HeteroJumpingKnowledge(nn.Module):
    """A JumpingKnowledge per node type (reference
    ``jumping_knowledge.py:103``), ``jk_{type}``. In lstm mode each takes
    ``num_layers``, the length of the lists it is given (the JAX package
    reads that length at the call)."""

    def __init__(self, types: Sequence[str], mode: str = 'cat',
                 channels: Optional[int] = None,
                 num_layers: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.types = list(types)
        for t in self.types:
            self.add_module(f'jk_{t}', JumpingKnowledge(
                mode, channels, num_layers, device=device,
                generator=generator))

    def forward(self, xs_dict):
        return {t: getattr(self, f'jk_{t}')(xs_dict[t]) for t in self.types}


class ARLinkPredictor(nn.Module):
    """Attract-repel link predictor (reference
    ``nn/models/attract_repel.py:5``): ``num_layers - 1`` ReLU Linears
    (``lins``, dropout in training mode drawn from ``generator``), then the
    attract and repel heads, ``attract_ratio`` of the output width to the
    first; the score of an edge is ``sigmoid(<a_i, a_j> - <r_i, r_j>)``."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: Optional[int] = None, num_layers: int = 2,
                 dropout: float = 0.0, attract_ratio: float = 0.5,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dropout = dropout
        kw = dict(device=device, generator=generator)
        self.lins = nn.ModuleList(
            linear(in_channels if i == 0 else hidden_channels,
                   hidden_channels, **kw) for i in range(num_layers - 1))
        out = out_channels or hidden_channels
        a = int(out * attract_ratio)
        last = hidden_channels if num_layers > 1 else in_channels
        self.lin_attract = linear(last, a, **kw)
        self.lin_repel = linear(last, out - a, **kw)

    def encode(self, x, generator: Optional[torch.Generator] = None):
        h = x
        for lin in self.lins:
            h = torch.relu(lin(h))
            if self.dropout > 0 and self.training:
                keep = 1.0 - self.dropout
                h = h * (_draw(h.shape, generator, h) < keep) / keep
        return self.lin_attract(h), self.lin_repel(h)

    def forward(self, x, edge_index,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        attract, repel = self.encode(x, generator)
        coo = _coo(edge_index)
        src, dst = coo[0].long(), coo[1].long()
        score = ((attract[src] * attract[dst]).sum(-1)
                 - (repel[src] * repel[dst]).sum(-1))
        return torch.sigmoid(score)

    @staticmethod
    def calculate_r_fraction(attract_emb, repel_emb):
        r2 = (repel_emb ** 2).sum()
        a2 = (attract_emb ** 2).sum()
        return r2 / (a2 + r2).clamp(min=1e-12)


def to_captum_model(*args, **kwargs):
    """The reference's captum bridge (``nn/models/captum.py``): not
    bound by the port or the JAX package."""
    raise ImportError('to_captum_model requires captum, which this package '
                      'does not bind')


def to_captum_input(*args, **kwargs):
    raise ImportError('to_captum_input requires captum, which this package '
                      'does not bind')


def captum_output_to_dicts(*args, **kwargs):
    raise ImportError('captum_output_to_dicts requires captum, which this '
                      'package does not bind')
