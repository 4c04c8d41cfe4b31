"""The port's model zoo (``nn/models/misc_models.py``) and autoencoders
(``nn/models/autoencoder.py``) against the JAX package's, on the CPU, at
small widths: JumpingKnowledge in its three modes and per node type,
DeepGraphInfomax with a fixed corruption permutation, LightGCN and its BPR
loss, LabelPropagation, CorrectAndSmooth in both arms, LINKX (eval and
training statistics), PMLP with and without its propagation, MaskLabel,
MetaLayer, NeuralFingerprint, DeepGCNLayer in its four blocks,
ARLinkPredictor, the captum stubs, the inner-product decoder, GAE, VGAE,
ARGA and ARGVA (VGAE's and ARGVA's noise and ARGA's real samples one
tensor handed to both); each on a raw COO, a raw COO with padded edges and
an edge mask, and an ``EdgeIndex`` where the model takes a graph, with edge
weights where it takes them; ``convert.py``'s JumpingKnowledge cells; and
``chip_smoke.py``'s path Z pipeline (the MLP base predictor, three Adam
steps, softmax, Correct & Smooth at path Z's settings) at 0.001 of
ogbn-products' shape against the JAX package's MLP, optax and
CorrectAndSmooth.

Tolerances: outputs within 1e-5 * max(1, max|ref|), gradients within 1e-4
of each gradient's largest entry (``_torch_parity``); path Z's corrected
and smoothed outputs within 1e-4 * max(1, max|ref|), its limit on the
card."""

import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (close, compare, edge_variant, graph,
                           init_variables, j, t)
from pytorch_geometric_tpu.nn import conv as jconv
from pytorch_geometric_tpu.nn import models as jmodels
from pytorch_geometric_tpu.ops import scatter as jscatter
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import conv, models
from pytorch_geometric_tpu_torch.nn.inits import linear
from pytorch_geometric_tpu_torch.nn.norm.norms import RunningBatchNorm
from pytorch_geometric_tpu_torch.ops import scatter

ROOT = Path(__file__).resolve().parents[1]
N, E, F, PAD, H, K = 26, 90, 12, 4, 8, 5
X, COO, MASK, W = graph(2, N, E, F, PAD)
CPU = dict(device='cpu')
VARIANTS = ['coo', 'coo mask', 'EdgeIndex']


def _edges(variant, weighted=False):
    return edge_variant(variant, COO, MASK, W, N, E, weighted)


def _kw(kw):
    return ({k: j(v) for k, v in kw.items()}, {k: t(v) for k, v in kw.items()})


# -- JumpingKnowledge ---------------------------------------------------------
@pytest.mark.parametrize('mode', ['cat', 'max', 'lstm'])
def test_jumping_knowledge_matches_jax(mode):
    """Three layers' representations ``[3, N, F]``; lstm mode's two cells
    and attention."""
    xs = np.random.default_rng(3).standard_normal((3, N, F)).astype(
        np.float32)
    compare(jmodels.JumpingKnowledge(mode=mode, channels=F, num_layers=3),
            models.JumpingKnowledge(mode, F, 3, **CPU), xs)


@pytest.mark.parametrize('mode', ['cat', 'lstm'])
def test_hetero_jumping_knowledge_matches_jax(mode):
    rng = np.random.default_rng(4)
    xs = {'a': rng.standard_normal((2, N, F)).astype(np.float32),
          'b': rng.standard_normal((2, 7, F)).astype(np.float32)}
    compare(jmodels.HeteroJumpingKnowledge(types=('a', 'b'), mode=mode,
                                           channels=F),
            models.HeteroJumpingKnowledge(('a', 'b'), mode, F, 2, **CPU),
            None, ({k: jnp.asarray(v) for k, v in xs.items()},),
            ({k: t(v) for k, v in xs.items()},))


def test_convert_jumping_knowledge_cells_round_trip():
    """JK's ``lstm_f`` / ``lstm_b`` (flax ``LSTMCell``s, four gates each)
    load strictly and give back the flax arrays, gates stacked i, f, g,
    o."""
    xs = jnp.ones((3, N, F))
    v = init_variables(jmodels.JumpingKnowledge(mode='lstm', channels=F,
                                                num_layers=3), 0, xs)
    tm = models.JumpingKnowledge('lstm', F, 3, **CPU)
    sd = flax_to_state_dict(v)
    tm.load_state_dict(sd)
    assert set(sd) == set(tm.state_dict())
    hidden = 3 * F // 2
    got = tm.state_dict()
    for cell in ('lstm_f', 'lstm_b'):
        p = v['params'][cell]
        for i, g in enumerate('ifgo'):
            rows = slice(i * hidden, (i + 1) * hidden)
            np.testing.assert_array_equal(
                got[f'{cell}.weight_ih'][rows].numpy(),
                np.asarray(p['i' + g]['kernel']).T)
            np.testing.assert_array_equal(
                got[f'{cell}.bias_hh'][rows].numpy(),
                np.asarray(p['h' + g]['bias']))


# -- DeepGraphInfomax, LightGCN -----------------------------------------------
@pytest.mark.parametrize('variant', VARIANTS)
def test_deep_graph_infomax_matches_jax(variant):
    """A GCNConv encoder, the corruption a fixed row permutation of x:
    ``pos_z``, ``neg_z``, the summary and the loss (the weight's gradient
    through it)."""
    perm = np.random.default_rng(5).permutation(N)
    je, te, kw = _edges(variant)
    jkw, tkw = _kw(kw)
    jm = jmodels.DeepGraphInfomax(
        hidden_channels=H, encoder=jconv.GCNConv(out_channels=H),
        corruption=lambda x, ei, **k: (x[perm], ei))
    tm = models.DeepGraphInfomax(
        H, conv.GCNConv(F, H, **CPU),
        corruption=lambda x, ei, **k: (x[t(perm)], ei), **CPU)

    def jrun(m, x, ei, **k):
        pos, neg, s, w = m(x, ei, **k)
        return pos, neg, s, jmodels.DeepGraphInfomax.loss(pos, neg, s, w)

    def trun(x, ei, **k):
        pos, neg, s = tm(x, ei, **k)
        return pos, neg, s, tm.loss(pos, neg, s)

    compare(jm, tm, X, (je,), (te,), jkw=jkw, tkw=tkw, method=jrun,
            tmethod=trun)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('alpha', [None, (0.5, 0.3, 0.2)])
def test_lightgcn_matches_jax(alpha, variant):
    """The scores of 20 pairs and the BPR loss with its L2 term."""
    rng = np.random.default_rng(6)
    pairs = rng.integers(0, N, (2, 20)).astype(np.int32)
    neg = rng.integers(0, N, (2, 20)).astype(np.int32)
    je, te, kw = _edges(variant)
    jkw, tkw = _kw(kw)
    jm = jmodels.LightGCN(num_nodes=N, embedding_dim=H, num_layers=2,
                          alpha=alpha)
    tm = models.LightGCN(N, H, 2, alpha, **CPU)

    def jrun(m, ei, lab, nl, **k):
        pos, ng = m(ei, lab, **k), m(ei, nl, **k)
        return pos, jmodels.LightGCN.recommendation_loss(
            pos, ng, 1e-2, m.variables['params'])

    def trun(ei, lab, nl, **k):
        pos, ng = tm(ei, lab, **k), tm(ei, nl, **k)
        return pos, models.LightGCN.recommendation_loss(pos, ng, 1e-2,
                                                        tm.parameters())

    compare(jm, tm, None, (je, jnp.asarray(pairs), jnp.asarray(neg)),
            (te, t(pairs), t(neg)), jkw=jkw, tkw=tkw, method=jrun,
            tmethod=trun)


# -- LabelPropagation, CorrectAndSmooth ---------------------------------------
def _labels(seed, c=K):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N, c)).astype(np.float32)
    y_soft = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    y_true = np.eye(c, dtype=np.float32)[rng.integers(0, c, N)]
    train = rng.random(N) < 0.4
    return y_soft.astype(np.float32), y_true, train


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('masked', [False, True])
def test_label_propagation_matches_jax(masked, variant):
    y_soft, _, train = _labels(7)
    je, te, kw = _edges(variant, weighted=True)
    kw.pop('edge_mask', None)
    if masked:
        kw['label_mask'] = train
    jkw, tkw = _kw(kw)
    compare(jmodels.LabelPropagation(num_layers=4, alpha=0.7),
            models.LabelPropagation(4, 0.7), y_soft, (je,), (te,),
            jkw=jkw, tkw=tkw)


@pytest.mark.parametrize('variant', ['coo', 'EdgeIndex'])
@pytest.mark.parametrize('cs', [
    dict(autoscale=True),
    dict(autoscale=False, scale=2.0),
    dict(num_correction_layers=50, correction_alpha=1.0,
         num_smoothing_layers=50, smoothing_alpha=0.8, autoscale=False,
         scale=20.0)], ids=['autoscale', 'fixed scale', 'path Z'])
def test_correct_and_smooth_matches_jax(cs, variant):
    """``correct`` (both arms), ``smooth`` and the whole call."""
    y_soft, y_true, train = _labels(8)
    je, te, _ = _edges(variant)
    jcs, tcs = jmodels.CorrectAndSmooth(**cs), models.CorrectAndSmooth(**cs)
    ja = (jnp.asarray(y_soft), jnp.asarray(y_true), jnp.asarray(train), je)
    ta = (t(y_soft), t(y_true), t(train), te)
    corrected = jcs.correct(*ja)
    close(tcs.correct(*ta), corrected, 'correct')
    close(tcs.smooth(t(np.asarray(corrected)), *ta[1:]),
          jcs.smooth(corrected, *ja[1:]), 'smooth')
    close(tcs(*ta), jcs(*ja), 'correct and smooth')


def test_correct_weighted_matches_jax():
    y_soft, y_true, train = _labels(9)
    for autoscale in (True, False):
        jcs = jmodels.CorrectAndSmooth(autoscale=autoscale, scale=3.0)
        tcs = models.CorrectAndSmooth(autoscale=autoscale, scale=3.0)
        close(tcs.correct(t(y_soft), t(y_true), t(train), t(COO[:, :E]),
                          t(W[:E])),
              jcs.correct(jnp.asarray(y_soft), jnp.asarray(y_true),
                          jnp.asarray(train), jnp.asarray(COO[:, :E]),
                          jnp.asarray(W[:E])))


# -- LINKX, PMLP, MaskLabel ---------------------------------------------------
@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('layers,train', [((1, 1, 1), False),
                                          ((2, 2, 2), True),
                                          ((3, 2, 1), False)])
def test_linkx_matches_jax(layers, train, variant):
    """``(num_layers, num_edge_layers, num_node_layers)``; in training mode
    the batch statistics and their running updates too."""
    nl, ne, nn_ = layers
    je, te, kw = _edges(variant, weighted=True)
    jkw, tkw = _kw(kw)
    jkw['deterministic'] = not train
    compare(jmodels.LINKX(num_nodes=N, hidden_channels=H, out_channels=K,
                          num_layers=nl, num_edge_layers=ne,
                          num_node_layers=nn_),
            models.LINKX(N, F, H, K, nl, ne, nn_, **CPU), X, (je,), (te,),
            jkw=jkw, tkw=tkw, train=train)


def test_linkx_without_features_matches_jax():
    compare(jmodels.LINKX(num_nodes=N, hidden_channels=H, out_channels=K,
                          num_edge_layers=2),
            models.LINKX(N, None, H, K, num_edge_layers=2, **CPU), None,
            (None, jnp.asarray(COO), None, jnp.asarray(MASK)),
            (None, t(COO), None, t(MASK)))


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('use_conv', [False, True])
def test_pmlp_matches_jax(use_conv, variant):
    """The padded COO's sentinel edges clamp to the last node in both
    packages' propagation."""
    je, te, _ = _edges(variant)
    if variant == 'coo mask':
        je, te = jnp.asarray(COO), t(COO)
    compare(jmodels.PMLP(hidden_channels=H, out_channels=K, num_layers=3),
            models.PMLP(F, H, K, num_layers=3, **CPU), X, (je,), (te,),
            jkw={'use_conv': use_conv}, tkw={'use_conv': use_conv})


@pytest.mark.parametrize('method', ['add', 'concat'])
def test_mask_label_matches_jax(method):
    rng = np.random.default_rng(10)
    y = rng.integers(-1, K, N).astype(np.int32)
    mask = rng.random(N) < 0.5
    width = F if method == 'add' else 6
    compare(jmodels.MaskLabel(num_classes=K, out_channels=width,
                              method=method),
            models.MaskLabel(K, width, method, **CPU), X,
            (jnp.asarray(y), jnp.asarray(mask)), (t(y), t(mask)))


def test_mask_label_ratio_mask_draws_from_the_generator():
    mask = torch.rand(4000, generator=torch.Generator().manual_seed(0)) < 0.6
    a = models.MaskLabel.ratio_mask(mask, 0.3,
                                    torch.Generator().manual_seed(1))
    b = models.MaskLabel.ratio_mask(mask, 0.3,
                                    torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not (a & ~mask).any()
    assert abs(float(a.sum() / mask.sum()) - 0.7) < 0.05


# -- MetaLayer, NeuralFingerprint, DeepGCNLayer -------------------------------
class _JEdge(fnn.Module):
    @fnn.compact
    def __call__(self, src, dst, edge_attr, u, batch):
        return fnn.Dense(H, name='lin')(jnp.concatenate(
            [src, dst, edge_attr, u[batch]], -1))


class _JNode(fnn.Module):
    @fnn.compact
    def __call__(self, x, coo, edge_attr, u, batch):
        agg = jscatter(edge_attr, jnp.minimum(coo[1], x.shape[0] - 1),
                       x.shape[0], 'mean')
        return fnn.Dense(F, name='lin')(jnp.concatenate([x, agg], -1))


class _JGlobal(fnn.Module):
    @fnn.compact
    def __call__(self, x, coo, edge_attr, u, batch):
        return fnn.Dense(4, name='lin')(jnp.concatenate(
            [u, jscatter(x, batch, u.shape[0], 'mean')], -1))


class _Edge(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = linear(2 * F + 3 + 4, H, device='cpu')

    def forward(self, src, dst, edge_attr, u, batch):
        return self.lin(torch.cat([src, dst, edge_attr, u[batch]], -1))


class _Node(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = linear(F + H, F, device='cpu')

    def forward(self, x, coo, edge_attr, u, batch):
        agg = scatter(edge_attr, coo[1].long().clamp(max=x.shape[0] - 1),
                      x.shape[0], 'mean')
        return self.lin(torch.cat([x, agg], -1))


class _Global(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = linear(4 + F, 4, device='cpu')

    def forward(self, x, coo, edge_attr, u, batch):
        return self.lin(torch.cat([u, scatter(x, batch, u.shape[0], 'mean')],
                                  -1))


def test_meta_layer_matches_jax():
    """Edge, node and global models over two graphs: the new x, edge
    features and globals."""
    rng = np.random.default_rng(11)
    ea = rng.standard_normal((E, 3)).astype(np.float32)
    u = rng.standard_normal((2, 4)).astype(np.float32)
    batch = np.repeat(np.arange(2), N // 2).astype(np.int32)
    coo = COO[:, :E]
    compare(jmodels.MetaLayer(edge_model=_JEdge(), node_model=_JNode(),
                              global_model=_JGlobal()),
            models.MetaLayer(_Edge(), _Node(), _Global()), X,
            tuple(jnp.asarray(a) for a in (coo, ea, u, batch)),
            tuple(t(a) for a in (coo, ea, u, batch)))


@pytest.mark.parametrize('variant', ['coo', 'EdgeIndex'])
def test_neural_fingerprint_matches_jax(variant):
    """Three graphs, one padded node slot masked out of the pooling."""
    batch = np.repeat(np.arange(3), [9, 9, 8]).astype(np.int32)
    node_mask = np.ones(N, bool)
    node_mask[-1] = False
    je, te, _ = _edges(variant)
    compare(jmodels.NeuralFingerprint(hidden_channels=H, out_channels=K,
                                      num_layers=2),
            models.NeuralFingerprint(F, H, K, num_layers=2, **CPU), X,
            (je, jnp.asarray(batch), 3, jnp.asarray(node_mask)),
            (te, t(batch), 3, t(node_mask)))


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('block,train', [('res+', True), ('res+', False),
                                         ('res', True), ('dense', False),
                                         ('plain', True)])
def test_deep_gcn_layer_matches_jax(block, train, variant):
    """A GCNConv with a batch norm (flax's ``BatchNorm``, batch statistics
    in training mode) and ReLU."""
    je, te, kw = _edges(variant, weighted=True)
    jkw, tkw = _kw(kw)
    jm = jmodels.DeepGCNLayer(conv=jconv.GCNConv(out_channels=F),
                              norm=fnn.BatchNorm(use_running_average=not
                                                 train),
                              block=block)
    tm = models.DeepGCNLayer(conv.GCNConv(F, F, **CPU),
                             RunningBatchNorm(F, device='cpu'), block=block)
    compare(jm, tm, X, (je,), (te,), jkw=jkw, tkw=tkw, train=train)


# -- ARLinkPredictor, captum --------------------------------------------------
@pytest.mark.parametrize('layers,ratio', [(2, 0.5), (3, 0.25), (1, 0.5)])
def test_ar_link_predictor_matches_jax(layers, ratio):
    """Eval mode: the scores, the two embeddings and their repel
    fraction."""
    coo = COO[:, :E]
    jm = jmodels.ARLinkPredictor(in_channels=F, hidden_channels=H,
                                 num_layers=layers, attract_ratio=ratio,
                                 dropout=0.3)
    tm = models.ARLinkPredictor(F, H, num_layers=layers, attract_ratio=ratio,
                                dropout=0.3, **CPU)

    def jrun(m, x, ei):
        a, r = m.encode(x)
        return (m(x, ei), a, r,
                jmodels.ARLinkPredictor.calculate_r_fraction(a, r))

    def trun(x, ei):
        a, r = tm.encode(x)
        return tm(x, ei), a, r, tm.calculate_r_fraction(a, r)

    compare(jm, tm, X, (jnp.asarray(coo),), (t(coo),), method=jrun,
            tmethod=trun)


def test_ar_link_predictor_dropout_draws_from_the_generator():
    tm = models.ARLinkPredictor(F, H, num_layers=3, dropout=0.5, **CPU)
    tm.train()
    runs = [tm(t(X), t(COO[:, :E]), torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                              runs[2])
    tm.eval()
    assert torch.equal(tm(t(X), t(COO[:, :E])),
                       tm(t(X), t(COO[:, :E]),
                          torch.Generator().manual_seed(1)))


@pytest.mark.parametrize('name', ['to_captum_model', 'to_captum_input',
                                  'captum_output_to_dicts'])
def test_captum_stubs_raise_as_jax(name):
    for mod in (jmodels, models):
        with pytest.raises(ImportError, match='captum'):
            getattr(mod, name)(None)


# -- autoencoders -------------------------------------------------------------
class _JVEnc(fnn.Module):
    @fnn.compact
    def __call__(self, x, ei, edge_mask=None):
        h = fnn.relu(jconv.GCNConv(out_channels=H, name='conv')(
            x, ei, edge_mask=edge_mask))
        return (jconv.GCNConv(out_channels=H, name='conv_mu')(
                    h, ei, edge_mask=edge_mask),
                jconv.GCNConv(out_channels=H, name='conv_logstd')(
                    h, ei, edge_mask=edge_mask))


class _VEnc(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = conv.GCNConv(F, H, **CPU)
        self.conv_mu = conv.GCNConv(H, H, **CPU)
        self.conv_logstd = conv.GCNConv(H, H, **CPU)

    def forward(self, x, ei, edge_mask=None):
        h = torch.relu(self.conv(x, ei, edge_mask=edge_mask))
        return (self.conv_mu(h, ei, edge_mask=edge_mask),
                self.conv_logstd(h, ei, edge_mask=edge_mask))


class _JDisc(fnn.Module):
    @fnn.compact
    def __call__(self, z):
        return fnn.Dense(1, name='lin_1')(fnn.relu(
            fnn.Dense(H, name='lin_0')(z)))[:, 0]


class _Disc(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lins = torch.nn.ModuleList([linear(H, H, device='cpu'),
                                         linear(H, 1, device='cpu')])

    def forward(self, z):
        return self.lins[1](torch.relu(self.lins[0](z)))[:, 0]


NEG = np.random.default_rng(12).integers(0, N, (2, 40)).astype(np.int32)
KEY = jax.random.PRNGKey(3)
NOISE = np.asarray(jax.random.normal(KEY, (N, H)))


def test_inner_product_decoder_matches_jax():
    z = np.random.default_rng(13).standard_normal((N, H)).astype(np.float32)
    jd, td = jmodels.InnerProductDecoder, models.InnerProductDecoder()
    for sig in (True, False):
        close(td(t(z), t(COO[:, :E]), sig),
              jd.decode(jnp.asarray(z), jnp.asarray(COO[:, :E]), sig))
        close(td.decode_all(t(z), sig), jd.decode_all(jnp.asarray(z), sig))


@pytest.mark.parametrize('variant', VARIANTS)
def test_gae_matches_jax(variant):
    """The embeddings and the reconstruction loss over given negatives."""
    je, te, kw = _edges(variant)
    jkw, tkw = _kw(kw)
    pos = COO[:, :E]

    def jrun(m, x, ei, **k):
        z = m.encode(x, ei, **k)
        return z, m.recon_loss(z, jnp.asarray(pos), jnp.asarray(NEG))

    def trun(x, ei, **k):
        z = tm.encode(x, ei, **k)
        return z, tm.recon_loss(z, t(pos), t(NEG))

    tm = models.GAE(conv.GCNConv(F, H, **CPU))
    compare(jmodels.GAE(encoder=jconv.GCNConv(out_channels=H)), tm, X, (je,),
            (te,), jkw=jkw, tkw=tkw, method=jrun, tmethod=trun)


@pytest.mark.parametrize('variant', VARIANTS)
def test_vgae_matches_jax(variant):
    """One noise tensor for both: the JAX side draws it from ``KEY`` and
    the port is handed it. ``z``, ``mu``, ``logstd`` and the KL and
    reconstruction losses."""
    je, te, kw = _edges(variant)
    jkw, tkw = _kw(kw)

    def jrun(m, x, ei, **k):
        z, mu, logstd = m(KEY, x, ei, **k)
        return (z, mu, logstd, m.kl_loss(mu, logstd),
                m.recon_loss(z, jnp.asarray(COO[:, :E]), jnp.asarray(NEG)))

    def trun(x, ei, **k):
        z, mu, logstd = tm(x, ei, noise=t(NOISE), **k)
        return (z, mu, logstd, tm.kl_loss(mu, logstd),
                tm.recon_loss(z, t(COO[:, :E]), t(NEG)))

    tm = models.VGAE(_VEnc())
    compare(jmodels.VGAE(encoder=_JVEnc()), tm, X, (je,), (te,), jkw=jkw,
            tkw=tkw, method=jrun, tmethod=trun)


def test_vgae_noise_draws_from_the_generator():
    tm = models.VGAE(_VEnc())
    runs = [tm(t(X), t(COO[:, :E]),
               generator=torch.Generator().manual_seed(s))[0]
            for s in (4, 4, 5)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                              runs[2])


@pytest.mark.parametrize('variational', [False, True])
def test_arga_argva_match_jax(variational):
    """ARGA's embeddings, or ARGVA's ``(z, mu, logstd)`` and KL loss, and
    the regulariser and discriminator losses; the discriminator's real
    samples and ARGVA's noise one tensor for both."""
    real_key = jax.random.PRNGKey(4)
    real = np.asarray(jax.random.normal(real_key, (N, H)))
    coo = jnp.asarray(COO[:, :E])

    def jrun(m, x, ei):
        if variational:
            z, mu, logstd = m(KEY, x, ei)
            extra = (mu, logstd, m.kl_loss(mu, logstd))
        else:
            z, extra = m(x, ei), ()
        return (z, *extra, m.reg_loss(z), m.discriminator_loss(real_key, z),
                m.recon_loss(z, coo, jnp.asarray(NEG)))

    def trun(x, ei):
        if variational:
            z, mu, logstd = tm(x, ei, noise=t(NOISE))
            extra = (mu, logstd, tm.kl_loss(mu, logstd))
        else:
            z, extra = tm(x, ei), ()
        return (z, *extra, tm.reg_loss(z),
                tm.discriminator_loss(z, noise=t(real)),
                tm.recon_loss(z, t(COO[:, :E]), t(NEG)))

    jcls, tcls = ((jmodels.ARGVA, models.ARGVA) if variational
                  else (jmodels.ARGA, models.ARGA))
    jenc = _JVEnc() if variational else jconv.GCNConv(out_channels=H)
    tenc = _VEnc() if variational else conv.GCNConv(F, H, **CPU)
    tm = tcls(tenc, _Disc())
    compare(jcls(encoder=jenc, discriminator=_JDisc()), tm, X, (coo,),
            (t(COO[:, :E]),), method=jrun, tmethod=trun)


# -- path Z's pipeline --------------------------------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_path_z_pipeline_matches_jax():
    """``chip_smoke.py``'s path Z at 0.001 of ogbn-products' shape (2,449
    nodes, 123,718 edges, X [N, 100], 47 classes, 197 training rows): the
    base MLP (100 -> 200 -> 200 -> 47, batch norm) from the same variables,
    3 full-batch Adam steps on the training rows (losses within 1e-5
    relative; dropout 0 here, as the two packages draw their masks from
    different generators), the eval-mode softmax from the JAX side's
    trained variables, then ``CorrectAndSmooth``
    at path Z's settings (50 correction hops at alpha 1.0 with scale 20, 50
    smoothing hops at 0.8) against the JAX package's MLP, optax and
    CorrectAndSmooth: the softmax within 1e-5 and the corrected and
    smoothed outputs within 1e-4 * max(1, max|ref|) (path Z's limit)."""
    cs = _chip_smoke()
    scale, steps, seed = 0.001, 3, 0
    n = int(cs.N_PRODUCTS * scale)
    coo = cs.products_graph(n, int(cs.E_PRODUCTS * scale), seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, cs.PR_F)).astype(np.float32)
    y = rng.integers(0, cs.PR_CLASSES, n)
    train = cs.cs_train_mask(torch, n, int(round(cs.PZ_TRAIN * scale)),
                             seed + 90, 'cpu')
    rows = train.nonzero()[:, 0]
    jm = jmodels.MLP(channel_list=[*cs.PZ_HIDDEN, cs.PR_CLASSES],
                     norm='batch_norm')
    variables = init_variables(jm, seed, jnp.asarray(x[:8]))
    tm = cs.cs_model(torch, 'cpu', seed, dropout=0.0)
    tm.load_state_dict(flax_to_state_dict(variables))
    losses = cs.cs_train(torch, tm, t(x), t(y), rows, steps, None)
    params, stats = variables['params'], variables['batch_stats']
    xt, yt = jnp.asarray(x[rows.numpy()]), jnp.asarray(y[rows.numpy()])

    def jloss(p, bs):
        logits, upd = jm.apply({'params': p, 'batch_stats': bs}, xt,
                               deterministic=False, mutable=['batch_stats'])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, yt).mean(), upd['batch_stats']

    opt = optax.adam(cs.PZ_LR)
    state = opt.init(params)
    step = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    for i in range(steps):
        (loss, stats), g = step(params, stats)
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        assert losses[i] == pytest.approx(float(loss), rel=1e-5)
    # the serving part from the JAX side's trained variables: Adam moves
    # the biases that the batch norms cancel by up to lr whatever the sign
    # of their rounding noise, which the eval-mode forward then shows
    trained = {'params': params, 'batch_stats': stats}
    tm.load_state_dict(flax_to_state_dict(trained))
    y_soft = jax.nn.softmax(jm.apply(trained, jnp.asarray(x)), -1)
    t_soft = cs.cs_soft(torch, tm, t(x))
    close(t_soft, y_soft, 'softmax')
    jcs = jmodels.CorrectAndSmooth(**cs.PZ_CS)
    y_true = jnp.asarray(np.eye(cs.PR_CLASSES, dtype=np.float32)[y])
    jtrain = jnp.asarray(train.numpy())
    corrected = jcs.correct(y_soft, y_true, jtrain, jnp.asarray(coo))
    smoothed = jcs.smooth(corrected, y_true, jtrain, jnp.asarray(coo))
    got = cs.cs_post(torch, models.CorrectAndSmooth(**cs.PZ_CS), t_soft,
                     t(y), train, t(coo))
    close(got[0], corrected, 'corrected', cs.PZ_TOL)
    close(got[1], smoothed, 'smoothed', cs.PZ_TOL)
    assert float(got[1].min()) >= 0 and float(got[1].max()) <= 1


def test_mlp_dropout_draws_from_a_given_generator():
    """The port's MLP draws its dropout masks from the generator
    ``forward`` is given (path Z's base steps); in eval mode, or without
    dropout, the generator changes nothing."""
    tm = models.MLP(F, [H, H, K], dropout=0.5, device='cpu',
                    generator=torch.Generator().manual_seed(0))
    x = t(X)
    runs = [tm(x, generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                              runs[2])
    tm.eval()
    assert torch.equal(tm(x), tm(x, generator=torch.Generator()))
