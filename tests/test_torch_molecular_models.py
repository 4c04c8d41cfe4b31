"""The port's ``nn/models/schnet.py``, ``dimenet.py`` and ``molecular.py``
against the JAX package's, on the CPU, each from the same numpy inputs and
the same flax variables (drawn with numpy, carried across by
``convert.flax_to_state_dict``) through ``tests/_torch_parity.py``'s
``compare``.

Tolerances: in float32 outputs within 1e-5 of max(1, max|ref|) and every
gradient within 1e-4 of its own largest (or 1e-6 of the largest of all
where it vanishes); the GRU cells' hidden reset and update biases, which
flax's cell lacks, are held on ``b_hn`` alone. SchNet (plain, dipole,
``atomref``, mean / std / scale, mean readout, a custom interaction graph,
padded atoms, ``z == 0`` rows, and a molecule with more atoms than
``max_num_neighbors``, whose radius graph is compared pair for pair) runs
in float32 without a position gradient: the JAX package's
``jnp.linalg.norm`` of a padded slot's zero offset gives NaN there.
DimeNet and DimeNet++ run in float64 on both sides (``jax.enable_x64``):
at float32 the l = 6 spherical Bessel recurrence near its series switch
moves a basis entry by ~1e-2 (the JAX package's arithmetic, copied), and a
narrow model's gradients sit up to 9.6e-5 of their own largest from
float64; in float64 the positions' gradient is held too. The basis
functions, ``triplets`` and ``prepare`` are held apart (``triplets`` and
``prepare`` bitwise). AttentiveFP runs over the raw COO (with and without
an edge mask) and over an ``EdgeIndex`` with the slot orders, the JAX side
on its Pallas route in interpret mode (``PGT_FORCE_PALLAS=1``) and the
port on its fused branch (a spy sees ``gat_aggregate`` called). SignedGCN
and its losses, RECT_L (raw COO and cached ``EdgeIndex``) and
``get_semantic_labels``, GroupAddRev in training mode (its groups
recomputed in the backward pass) and in eval mode.

The slice as a whole: ``chip_smoke.py::qm9_raw``'s molecules (path AE's
synthesizer) parsed by both packages' ``QM9``, batched by both
``DataLoader``s, DimeNet++'s interaction graph and triplets from
``prepare``, then 3 Adam steps (optax on the JAX side) of a narrow
DimeNet++ (float64) and SchNet (float32), the port evaluated at each
step's parameters: losses within 1e-5 relative, gradients within 1e-4 of
their own largest (1e-6 of the largest of all where one vanishes)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import close, compare, grad_close, graph, init_variables, t
from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu import datasets as jds
from pytorch_geometric_tpu.loader import DataLoader as JDataLoader
from pytorch_geometric_tpu.nn.conv import GCNConv as JGCNConv
from pytorch_geometric_tpu.nn.models import dimenet as jdn
from pytorch_geometric_tpu.nn.models import molecular as jmol
from pytorch_geometric_tpu.nn.models import schnet as jsn
from pytorch_geometric_tpu.nn.pool.point import radius_graph as jradius
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch import datasets as tds
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.loader import DataLoader
from pytorch_geometric_tpu_torch.nn.conv import GCNConv
from pytorch_geometric_tpu_torch.nn.models import dimenet as tdn
from pytorch_geometric_tpu_torch.nn.models import molecular as tmol
from pytorch_geometric_tpu_torch.nn.models import schnet as tsn
from pytorch_geometric_tpu_torch.nn.pool import radius_graph as tradius

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device='cpu')
NUMBERS = {'H': 1, 'C': 6, 'N': 7, 'O': 8, 'F': 9}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


CS = _chip_smoke()


def _molecules(count, seed):
    """``count`` of path AE's molecules: z, positions, molecule ids."""
    symbols, _, pos = CS.qm9_molecules(count, seed)
    z = np.array([NUMBERS[s] for mol in symbols for s in mol], np.int32)
    batch = np.repeat(np.arange(count), [len(s) for s in symbols])
    return z, np.concatenate(pos).astype(np.float32), batch.astype(np.int32)


Z, POS, BATCH = _molecules(3, 11)
SCHNET = dict(hidden_channels=16, num_filters=12, num_interactions=2,
              num_gaussians=10, cutoff=4.0, max_num_neighbors=6)


def _schnet_case(case):
    z, pos, batch, kw, mask = Z.copy(), POS, BATCH, {}, None
    if case == 'dipole':
        kw['dipole'] = True
    elif case == 'atomref':
        kw['atomref'] = np.linspace(-2.0, 2.0, 12).astype(np.float32)
    elif case == 'mean std scale':
        kw.update(mean=0.3, std=2.5, scale=0.5)
    elif case == 'readout mean':
        kw['readout'] = 'mean'
    elif case == 'z == 0':
        z[[0, 5]] = 0
    elif case == 'node mask':
        mask = np.ones(len(z), bool)
        mask[-4:] = False
    return z, pos, batch, kw, mask


@pytest.mark.parametrize('case', ['plain', 'dipole', 'atomref',
                                  'mean std scale', 'readout mean', 'z == 0',
                                  'node mask'])
def test_schnet_matches_jax(case):
    z, pos, batch, kw, mask = _schnet_case(case)
    jm = jsn.SchNet(**SCHNET, **kw)
    tm = tsn.SchNet(**SCHNET, **kw, **CPU)
    jkw = {} if mask is None else {'node_mask': jnp.asarray(mask)}
    tkw = {} if mask is None else {'node_mask': t(mask)}
    compare(jm, tm, None, jargs=(jnp.asarray(z), jnp.asarray(pos),
                                 jnp.asarray(batch), 3),
            targs=(t(z), t(pos), t(batch), 3), jkw=jkw, tkw=tkw)


def test_schnet_interaction_graph_matches_jax():
    """A callable interaction graph in place of the radius graph: every
    pair within a molecule, its distances, all valid."""
    same = BATCH[:, None] == BATCH[None]
    np.fill_diagonal(same, False)
    src, dst = np.nonzero(same)
    coo = np.stack([src, dst]).astype(np.int32)
    dist = np.linalg.norm(POS[src] - POS[dst], axis=-1).astype(np.float32)

    def jgraph(pos, batch):
        return (jnp.asarray(coo), jnp.asarray(dist),
                jnp.ones(len(src), bool))

    def tgraph(pos, batch):
        return t(coo), t(dist), torch.ones(len(src), dtype=torch.bool)

    compare(jsn.SchNet(**SCHNET, interaction_graph=jgraph),
            tsn.SchNet(**SCHNET, interaction_graph=tgraph, **CPU), None,
            jargs=(jnp.asarray(Z), jnp.asarray(POS), jnp.asarray(BATCH), 3),
            targs=(t(Z), t(POS), t(BATCH), 3))


@pytest.mark.parametrize('k', [4, 32])
def test_radius_graph_matches_jax_past_max_neighbours(k):
    """The fixed-k radius graph of SchNet at path AE's cutoff over
    molecules of more atoms than ``k`` (and fewer): the same valid pairs
    in both packages."""
    z, pos, batch = _molecules(6, 12)
    jc, jv = jradius(jnp.asarray(pos), 10.0, batch=jnp.asarray(batch),
                     max_num_neighbors=k)
    tc, tv = tradius(t(pos), 10.0, batch=t(batch), max_num_neighbors=k)
    want = set(map(tuple, np.asarray(jc)[:, np.asarray(jv)].T.tolist()))
    got = set(map(tuple, tc[:, tv].T.tolist()))
    assert got == want and len(got) > 0
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_gaussian_smearing_and_softplus_match_jax():
    d = np.linspace(0.0, 6.0, 41).astype(np.float32)
    close(tsn.GaussianSmearing(0.0, 5.0, 12)(t(d)),
          jsn.GaussianSmearing(0.0, 5.0, 12).apply({}, jnp.asarray(d)))
    close(tsn.ShiftedSoftplus()(t(d - 3)),
          jsn.ShiftedSoftplus().apply({}, jnp.asarray(d - 3)))
    np.testing.assert_array_equal(tsn.ATOMIC_MASSES, jsn.ATOMIC_MASSES)


# -- DimeNet ------------------------------------------------------------------
def test_triplets_and_prepare_match_jax_bitwise():
    z, pos, batch = _molecules(4, 13)
    got = tdn.DimeNet.prepare(pos, batch, 3.0)
    want = jdn.DimeNet.prepare(pos, batch, 3.0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    coo = got[0]
    for cap in (None, 50, 10 ** 5):
        for g, w in zip(tdn.triplets(coo, len(z), cap),
                        jdn.triplets(coo, len(z), cap)):
            np.testing.assert_array_equal(g, w)
    assert tdn.DimeNet.triplets is tdn.triplets


def test_bases_match_jax_in_float64():
    """The spherical Bessel functions across the series switch, the zonal
    harmonics, the envelope, and both basis layers, in float64, within
    1e-10 of max(1, max|ref|): the l = 6 recurrence multiplies a float64
    rounding by up to ~1e5 near the switch, and XLA's fused arithmetic
    rounds otherwise than PyTorch's."""
    x = np.concatenate([np.linspace(0.0, 0.49, 7), np.linspace(0.5, 12, 40)])
    angle = np.linspace(0.0, np.pi, 23)
    with jax.enable_x64(True):
        close(tdn._spherical_jn(t(x), 6),
              jax.jit(jdn._spherical_jn, static_argnums=1)(
                  jnp.asarray(x), 6), tol=1e-10)
        close(tdn._zonal_harmonics(t(angle), 6),
              jax.jit(jdn._zonal_harmonics, static_argnums=1)(
                  jnp.asarray(angle), 6), tol=1e-10)
        u = np.linspace(0.05, 1.2, 30)
        close(tdn.Envelope(5)(t(u)), jdn.Envelope(5).apply({}, jnp.asarray(u)),
              tol=1e-10)
        dist = np.linspace(0.9, 5.5, 12)
        jb = jdn.BesselBasisLayer(6, 5.0, 5)
        v = jb.init(jax.random.PRNGKey(0), jnp.asarray(dist))
        tb = tdn.BesselBasisLayer(6, 5.0, 5, **CPU).double()
        np.testing.assert_array_equal(tb.freq.detach().float().numpy(),
                                      np.asarray(v['params']['freq']))
        close(tb(t(dist)), jb.apply(v, jnp.asarray(dist)), tol=1e-10)
        idx = np.array([0, 3, 11, 5, 12], np.int32)
        close(tdn.SphericalBasisLayer(7, 6).double()(
                  t(dist), t(angle[:5]), t(idx)),
              jax.jit(jdn.SphericalBasisLayer(7, 6).apply)(
                  {}, jnp.asarray(dist), jnp.asarray(angle[:5]),
                  jnp.asarray(idx)), tol=1e-10)
    zeros, norms = tdn._bessel_zeros_and_norms(7, 6)
    jz, jnorm = jdn._bessel_zeros_and_norms(7, 6)
    np.testing.assert_array_equal(zeros, jz)
    np.testing.assert_array_equal(norms, jnorm)


DIME = dict(hidden_channels=16, out_channels=2, num_blocks=2,
            num_spherical=5, num_radial=4, cutoff=3.0)


def _dimenet_pair(pp, **over):
    kw = dict(DIME, **over)
    if pp:
        kw.update(int_emb_size=8, basis_emb_size=4, out_emb_channels=20)
        return jdn.DimeNetPlusPlus(**kw), tdn.DimeNetPlusPlus(**kw, **CPU)
    kw['num_bilinear'] = 3
    return jdn.DimeNet(**kw), tdn.DimeNet(**kw, **CPU)


@pytest.mark.parametrize('case', ['bilinear', 'bilinear edge mask', 'pp',
                                  'pp padded triplets', 'pp zeros output'])
def test_dimenet_matches_jax_in_float64(case):
    """Outputs, parameter gradients and the positions' gradient in
    float64. 'padded triplets' pads the triplet list (a padded slot's
    gradient is NaN in the JAX package's norm of a zero cross product, so
    that case holds no position gradient), 'zeros output' keeps the
    reference's zero output layers (the other cases draw them)."""
    pp = case.startswith('pp')
    init = 'zeros' if case == 'pp zeros output' else 'glorot'
    jm, tm = _dimenet_pair(pp, output_initializer=init)
    coo, kj, ji, tmask = jdn.DimeNet.prepare(POS, BATCH, DIME['cutoff'])
    padded = case == 'pp padded triplets'
    if padded:
        coo, kj, ji, tmask = jdn.DimeNet.prepare(POS, BATCH, DIME['cutoff'],
                                                 max_triplets=len(kj) + 9)
    edge_mask = None
    if case == 'bilinear edge mask':
        edge_mask = np.random.default_rng(1).random(coo.shape[1]) < 0.8
    jkw = {} if edge_mask is None else {'edge_mask': jnp.asarray(edge_mask)}
    tkw = {} if edge_mask is None else {'edge_mask': t(edge_mask)}
    host = (Z, coo, kj, ji, tmask, BATCH)
    with jax.enable_x64(True):
        tm = tm.double()
        if padded:
            compare(jm, tm, None, jargs=(jnp.asarray(Z), jnp.asarray(
                        POS.astype(np.float64))) + tuple(
                        jnp.asarray(a) for a in host[1:]) + (3,),
                    targs=(t(Z), t(POS.astype(np.float64))) + tuple(
                        t(a) for a in host[1:]) + (3,), jkw=jkw, tkw=tkw)
            return
        compare(jm, tm, POS.astype(np.float64),
                jargs=tuple(jnp.asarray(a) for a in host),
                targs=tuple(t(a) for a in host), jkw=jkw, tkw=tkw,
                method=lambda m, pos, z, c, a, b, msk, bt, **k: m(
                    z, pos, c, a, b, msk, bt, 3, **k),
                tmethod=lambda pos, z, c, a, b, msk, bt, **k: tm(
                    z, pos, c, a, b, msk, bt, 3, **k))


def test_dimenet_without_batch_sums_all():
    jm, tm = _dimenet_pair(False, output_initializer='glorot')
    coo, kj, ji, tmask = jdn.DimeNet.prepare(POS, None, DIME['cutoff'])
    host = (Z, POS, coo, kj, ji, tmask)
    compare(jm, tm, None, jargs=tuple(jnp.asarray(a) for a in host),
            targs=tuple(t(a) for a in host))


# -- AttentiveFP, SignedGCN, RECT_L, GroupAddRev ------------------------------
N, E, F, H = 40, 160, 6, 16
X, COO, MASK, W = graph(3, N, E, F, pad=4)
EA = np.random.default_rng(5).standard_normal((E + 4, 3)).astype(np.float32)
GB = np.sort(np.random.default_rng(6).integers(0, 3, N)).astype(np.int32)
GRU_B_HN = {k: slice(2 * H, 3 * H) for k in (
    'gru.bias_hh', 'atom_grus_0.bias_hh', 'atom_grus_1.bias_hh',
    'mol_gru.bias_hh')}


@pytest.mark.parametrize('variant', ['coo', 'coo mask', 'fused'])
def test_attentive_fp_matches_jax(variant, monkeypatch):
    monkeypatch.setenv('PGT_FORCE_PALLAS', '1')
    jm = jmol.AttentiveFP(in_channels=F, hidden_channels=H, out_channels=2,
                          edge_dim=3, num_layers=3, num_timesteps=2)
    tm = tmol.AttentiveFP(F, H, 2, 3, num_layers=3, **CPU)
    jkw, tkw = {}, {}
    if variant == 'fused':
        je = JEdgeIndex(jnp.asarray(COO[:, :E]), (N, N)).fill_cache(
            blocked=True)
        te = EdgeIndex(COO[:, :E], (N, N), **CPU).fill_cache(blocked=True)
        ea = EA[:E]
    elif variant == 'coo':
        je, te, ea = jnp.asarray(COO[:, :E]), t(COO[:, :E]), EA[:E]
    else:
        je, te, ea = jnp.asarray(COO), t(COO), EA
        jkw, tkw = {'edge_mask': jnp.asarray(MASK)}, {'edge_mask': t(MASK)}
    calls = []
    from pytorch_geometric_tpu_torch.nn.conv import gat_conv
    real = gat_conv.gat_aggregate
    monkeypatch.setattr(gat_conv, 'gat_aggregate',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    compare(jm, tm, X, jargs=(je, jnp.asarray(ea), jnp.asarray(GB), 3),
            targs=(te, t(ea), t(GB), 3), jkw=jkw, tkw=tkw,
            partial=GRU_B_HN)
    # two atom GATConvs, each on the fused branch over the slot orders
    assert len(calls) == (2 if variant == 'fused' else 0)


def test_signed_gcn_and_losses_match_jax():
    neg = np.random.default_rng(9).integers(0, N, (2, 90)).astype(np.int32)
    jm = jmol.SignedGCN(in_channels=F, hidden_channels=8, num_layers=3)
    tm = tmol.SignedGCN(F, 8, 3, **CPU)
    variables = compare(jm, tm, X, jargs=(jnp.asarray(COO[:, :E]),
                                          jnp.asarray(neg)),
                        targs=(t(COO[:, :E]), t(neg)))
    z = jm.apply(variables, jnp.asarray(X), jnp.asarray(COO[:, :E]),
                 jnp.asarray(neg))
    tz = tm(t(X), t(COO[:, :E]), t(neg)).detach()
    close(tmol.SignedGCN.pos_embedding_loss(tz, t(COO[:, :E])),
          jmol.SignedGCN.pos_embedding_loss(z, jnp.asarray(COO[:, :E])))
    close(tmol.SignedGCN.neg_embedding_loss(tz, t(neg)),
          jmol.SignedGCN.neg_embedding_loss(z, jnp.asarray(neg)))
    lin = torch.nn.Linear(32, 3)
    got = tmol.SignedGCN.discriminate(None, lambda p, f: lin(f), tz,
                                      t(neg))
    assert got.shape == (90, 3)


@pytest.mark.parametrize('variant', ['coo', 'cached'])
def test_rect_l_matches_jax(variant):
    if variant == 'cached':
        je = JEdgeIndex(jnp.asarray(COO[:, :E]), (N, N)).fill_cache()
        te = EdgeIndex(COO[:, :E], (N, N), **CPU).fill_cache()
    else:
        je, te = jnp.asarray(COO[:, :E]), t(COO[:, :E])
    compare(jmol.RECT_L(in_channels=F, hidden_channels=12),
            tmol.RECT_L(F, 12, **CPU), X, jargs=(je,), targs=(te,),
            jkw={'edge_weight': jnp.asarray(W[:E])},
            tkw={'edge_weight': t(W[:E])})
    y = np.random.default_rng(2).integers(0, 3, N)
    m = np.random.default_rng(3).random(N) < 0.5
    np.testing.assert_array_equal(
        tmol.RECT_L.get_semantic_labels(t(X), t(y), t(m)),
        jmol.RECT_L.get_semantic_labels(X, y, m))


@pytest.mark.parametrize('train', [True, False])
def test_group_add_rev_matches_jax(train):
    x = np.random.default_rng(4).standard_normal((N, 8)).astype(np.float32)
    jm = jmol.GroupAddRev(conv=JGCNConv(out_channels=4), num_groups=2)
    tm = tmol.GroupAddRev(GCNConv(4, 4, **CPU), num_groups=2)
    compare(jm, tm, x, jargs=(jnp.asarray(COO),), targs=(t(COO),),
            jkw={'edge_mask': jnp.asarray(MASK)},
            tkw={'edge_mask': t(MASK)}, train=train)
    with pytest.raises(ValueError, match='equal groups'):
        tm(t(x[:, :7]), t(COO))


# -- the slice as a whole -----------------------------------------------------
def _slice_batches(tmp_path):
    """Path AE's molecules through both packages' QM9 and DataLoader."""
    CS.qm9_raw(tmp_path, 12, seed=4)
    jb = next(iter(JDataLoader(jds.QM9(str(tmp_path)), batch_size=12,
                               pad=False)))
    tb = next(iter(DataLoader(tds.QM9(str(tmp_path)), batch_size=12,
                              pad=False)))
    for key in ('z', 'pos', 'batch', 'y', 'edge_index', 'edge_attr'):
        g, w = tb[key], jb[key]
        g, w = getattr(g, 'coo', g).numpy(), np.asarray(getattr(w, 'coo', w))
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    y = tb.y[:, CS.QM9_U0].double()
    y = ((y - y.mean()) / y.std()).numpy()
    return tb.z.numpy(), tb.pos.numpy(), tb.batch.numpy(), y


@pytest.mark.parametrize('model', ['dimenet++', 'schnet'])
def test_slice_trains_the_same_three_steps(tmp_path, model):
    z, pos, batch, y = _slice_batches(tmp_path)
    if model == 'dimenet++':
        kw = dict(hidden_channels=16, out_channels=1, num_blocks=2,
                  int_emb_size=8, basis_emb_size=4, out_emb_channels=24,
                  num_spherical=5, num_radial=4, cutoff=5.0,
                  output_initializer='glorot')
        jm, tm = jdn.DimeNetPlusPlus(**kw), tdn.DimeNetPlusPlus(**kw, **CPU)
        host = tdn.DimeNet.prepare(pos, batch, 5.0)
        pos, y = pos.astype(np.float64), y.astype(np.float64)
        tm = tm.double()
        x64 = jax.enable_x64(True)
    else:
        kw = dict(hidden_channels=16, num_filters=16, num_interactions=2,
                  num_gaussians=12, cutoff=10.0, max_num_neighbors=32)
        jm, tm = jsn.SchNet(**kw), tsn.SchNet(**kw, **CPU)
        host = ()
        y = y.astype(np.float32)
        x64 = jax.enable_x64(False)
    jargs = (z, pos) + tuple(host) + (batch,)
    with x64:
        ja = tuple(jnp.asarray(a) for a in jargs)
        ta = tuple(t(a) for a in jargs)
        variables = init_variables(jm, 0, *ja, 12)

        def jloss(p):
            out = jm.apply({'params': p}, *ja, 12)
            return jnp.abs(out.reshape(-1) - jnp.asarray(y)).mean()

        params = variables['params']
        tx = optax.adam(1e-3)
        opt = tx.init(params)
        grad_fn = jax.jit(jax.value_and_grad(jloss))
        for step in range(3):
            loss, g = grad_fn(params)
            tm.load_state_dict(flax_to_state_dict({'params': params}))
            tm.zero_grad(set_to_none=True)
            tl = (tm(*ta, 12).view(-1) - t(y)).abs().mean()
            tl.backward()
            np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-5,
                                       err_msg=f'loss, step {step}')
            jgrads = flax_to_state_dict({'params': g})
            floor = 1e-6 * max(float(v.abs().max()) for v in jgrads.values())
            for k, p in tm.named_parameters():
                grad_close(p.grad, jgrads[k].numpy(), f'{k}, step {step}',
                           floor)
            upd, opt = tx.update(g, opt)
            params = optax.apply_updates(params, upd)


@pytest.mark.parametrize('build', [
    lambda: tsn.SchNet(), lambda: tdn.DimeNet(), lambda: tdn.DimeNetPlusPlus(),
    lambda: tmol.AttentiveFP(4, 8, 1, 2), lambda: tmol.SignedGCN(4, 8),
    lambda: tmol.RECT_L(4, 8)],
    ids=['SchNet', 'DimeNet', 'DimeNetPlusPlus', 'AttentiveFP', 'SignedGCN',
         'RECT_L'])
def test_models_need_a_card_by_default(monkeypatch, build):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        build()
