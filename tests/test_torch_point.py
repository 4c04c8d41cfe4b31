"""The port's point family against the JAX package's, on the CPU:
``nn/pool/point.py`` (knn, knn_graph, radius, radius_graph, nearest, fps,
voxel_grid, the approximate aliases, decimation_indices) in the dense and
the tiled branch (the tiled one forced at small sizes by lowering both
packages' ``_DENSE_LIMIT`` and tile sizes, so several tiles merge),
``nn/pool/knn_index.py``, ``knn_interpolate``, the point convolutions of
``nn/conv/point_conv.py`` (each on a raw COO, a padded COO with an edge
mask and an ``EdgeIndex``) and ``XConv``; ties on duplicated and lattice
points going to the lowest index as the JAX package's do; ``fps``'s
refusals; and ``chip_smoke.py``'s DGCNN (path AA) at narrow widths over
three Adam steps against flax and optax, its edge MLPs' batch norms in
training mode.

Tolerances: outputs within 1e-5 * max(1, max|ref|), gradients within 1e-4
of each gradient's largest entry (``_torch_parity``); knn indices and
masks exact on inputs without near-ties; the DGCNN losses within 1e-4
relative each step."""

import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (close, compare, edge_variant, graph, grad_close,
                           init_variables, t)
from pytorch_geometric_tpu.nn import conv as jconv
from pytorch_geometric_tpu.nn import models as jmodels
from pytorch_geometric_tpu.nn import knn_interpolate as jknn_interpolate
from pytorch_geometric_tpu.nn.pool import glob as jglob
from pytorch_geometric_tpu.nn.pool import knn_index as jki
from pytorch_geometric_tpu.nn.pool import point as jpoint
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import conv, knn_interpolate
from pytorch_geometric_tpu_torch.nn.inits import linear
from pytorch_geometric_tpu_torch.nn.models import MLP
from pytorch_geometric_tpu_torch.nn.pool import knn_index as tki
from pytorch_geometric_tpu_torch.nn.pool import point as tpoint

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device='cpu')
N, CLOUDS = 60, 3


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _cloud(seed, n=N, dim=3, clouds=CLOUDS):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, dim)).astype(np.float32)
    batch = np.sort(rng.integers(0, clouds, n)).astype(np.int32)
    mask = rng.random(n) < 0.85
    return pos, batch, mask


@pytest.fixture(params=['dense', 'tiled'])
def branch(request, monkeypatch):
    """The dense branch as it is; the tiled branch forced at this size in
    both packages (query tiles of 16, candidate tiles of 24)."""
    if request.param == 'tiled':
        for mod in (jpoint, tpoint):
            monkeypatch.setattr(mod, '_DENSE_LIMIT', 64)
            monkeypatch.setattr(mod, '_QT', 16)
            monkeypatch.setattr(mod, '_XT', 24)
    return request.param


def _jit(fn, *static):
    """``fn`` jitted with ``static`` positional arguments; a new function
    each call, so a trace made under one branch's constants is not reused
    under the other's (op-by-op JAX took ~5x longer here)."""
    return jax.jit(lambda *a: fn(*a), static_argnums=static)


def _same(got, ref, what=''):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(ref), err_msg=what)


def _pair_same(got, ref, what=''):
    _same(got[0], ref[0], f'{what} indices')
    _same(got[1], ref[1], f'{what} mask')


# -- nn/pool/point.py ---------------------------------------------------------
def test_knn_family_matches_jax(branch):
    """knn (batched and masked, and k past a cloud's size), knn_graph
    (loop, flow, mask), radius, radius_graph, nearest."""
    pos, batch, mask = _cloud(1)
    pos_y, batch_y, mask_y = _cloud(2, n=40)
    jp, jb, jm = jnp.asarray(pos), jnp.asarray(batch), jnp.asarray(mask)
    tp, tb, tm = t(pos), t(batch), t(mask)
    jy, jby, jmy = jnp.asarray(pos_y), jnp.asarray(batch_y), \
        jnp.asarray(mask_y)
    ty, tby, tmy = t(pos_y), t(batch_y), t(mask_y)
    jknn = _jit(jpoint.knn, 2)
    jgraph = _jit(jpoint.knn_graph, 1, 3, 5)
    _pair_same(tpoint.knn(tp, ty, 5, tb, tby), jknn(jp, jy, 5, jb, jby),
               'knn')
    _pair_same(tpoint.knn(tp, ty, 7, tb, tby, tm, tmy),
               jknn(jp, jy, 7, jb, jby, jm, jmy), 'knn masked')
    _pair_same(tpoint.knn(tp, ty, 30, tb, tby),
               jknn(jp, jy, 30, jb, jby), 'knn k past a cloud')
    _pair_same(tpoint.knn(tp[:10], ty, 14), jknn(jp[:10], jy, 14),
               'knn k past n')
    for loop, flow in ((False, 'source_to_target'),
                       (True, 'target_to_source')):
        _pair_same(tpoint.knn_graph(tp, 6, tb, loop, tm, flow),
                   jgraph(jp, 6, jb, loop, jm, flow),
                   f'knn_graph {loop} {flow}')
    _pair_same(tpoint.radius(tp, ty, 1.1, tb, tby, 8),
               _jit(jpoint.radius, 2, 5)(jp, jy, 1.1, jb, jby, 8), 'radius')
    _pair_same(tpoint.radius_graph(tp, 1.0, tb, True, 8, tm),
               _jit(jpoint.radius_graph, 1, 3, 4)(jp, 1.0, jb, True, 8, jm),
               'radius_graph')
    _same(tpoint.nearest(ty, tp, tby, tb),
          _jit(jpoint.nearest)(jy, jp, jby, jb), 'nearest')
    # the approximate names are the exact search, in both packages
    _pair_same(tpoint.approx_knn(tp, ty, 5, tb, tby),
               tpoint.knn(tp, ty, 5, tb, tby), 'approx_knn')
    _pair_same(tpoint.approx_knn_graph(tp, 6, tb),
               tpoint.knn_graph(tp, 6, tb), 'approx_knn_graph')


@pytest.mark.parametrize('points', ['duplicated', 'lattice'])
def test_knn_ties_go_to_the_lowest_index(branch, points):
    """Duplicated points, and an integer lattice (every distance exact, so
    many equal): the port's neighbours are the JAX package's, each tie to
    the lowest index; in float64 too."""
    if points == 'duplicated':
        pos, batch, _ = _cloud(3)
        pos[20:40] = pos[:20]
        pos[40:50] = pos[0]
    else:
        g = np.arange(4, dtype=np.float32)
        pos = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
        batch = np.zeros(len(pos), np.int32)
    jp, tp = jnp.asarray(pos), t(pos)
    jgraph = _jit(jpoint.knn_graph, 1)
    for k in (1, 6, 13):
        want = jgraph(jp, k, jnp.asarray(batch))
        _pair_same(tpoint.knn_graph(tp, k, t(batch)), want, f'k {k}')
        _pair_same(tpoint.knn_graph(tp.double(), k, t(batch)), want,
                   f'k {k} float64')
    idx, valid = tpoint.knn_graph(tp, 6, t(batch))
    d = ((tp[idx[0]] - tp[idx[1]]) ** 2).sum(-1).view(-1, 6)
    nbr = idx[0].view(-1, 6)
    # within a row, equal distances in index order
    tie = (d[:, 1:] == d[:, :-1])
    assert bool((nbr[:, 1:] > nbr[:, :-1])[tie].all()) and bool(tie.any())


def test_fps_matches_jax_and_refuses_batches():
    pos, _, _ = _cloud(4)
    pos[10] = pos[3]
    for kw in ({}, {'ratio': 0.3}, {'num_samples': 17}):
        _same(tpoint.fps(t(pos), **kw), jpoint.fps(jnp.asarray(pos), **kw),
              str(kw))
    one = torch.zeros(N, dtype=torch.long)
    _same(tpoint.fps(t(pos), 0.5, one), jpoint.fps(jnp.asarray(pos), 0.5))
    with pytest.raises(NotImplementedError, match='several clouds'):
        tpoint.fps(t(pos), 0.5, t(_cloud(4)[1]))
    with pytest.raises(NotImplementedError, match='random_start'):
        tpoint.fps(t(pos), 0.5, random_start=True)


def test_voxel_grid_and_decimation_match_jax():
    pos, batch, _ = _cloud(5)
    for kw in ({}, {'batch': batch}, {'start': [-3.0, -3.0, -3.0]}):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: torch.as_tensor(np.asarray(v)) for k, v in kw.items()}
        _same(tpoint.voxel_grid(t(pos), 0.5, **tkw),
              jpoint.voxel_grid(jnp.asarray(pos), 0.5, **jkw), str(kw))
    _same(tpoint.voxel_grid(t(pos), [0.5, 1.0, 0.25]),
          jpoint.voxel_grid(jnp.asarray(pos), [0.5, 1.0, 0.25]))
    ptr = np.array([0, 7, 7 + 12, 7 + 12 + 1, 40])
    for factor in (1, 2, 5):
        for arg in (ptr, torch.as_tensor(ptr)):
            got = tpoint.decimation_indices(arg, factor, seed=3, **CPU)
            want = jpoint.decimation_indices(ptr, factor, seed=3)
            _same(got[0], want[0])
            _same(got[1], want[1])
    with pytest.raises(ValueError, match='decimation_factor'):
        tpoint.decimation_indices(ptr, 0.5, **CPU)


# -- nn/pool/knn_index.py -----------------------------------------------------
@pytest.mark.parametrize('name', ['L2KNNIndex', 'MIPSKNNIndex'])
def test_knn_index_matches_jax(name):
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((50, 8)).astype(np.float32)
    more = rng.standard_normal((20, 8)).astype(np.float32)
    q = rng.standard_normal((9, 8)).astype(np.float32)
    q[2] = emb[5]
    links = np.array([[0, 0, 3, 8], [1, 5, 60, 2]])
    ji, ti = getattr(jki, name)(emb), getattr(tki, name)(emb, **CPU)
    ji.add(more)
    ti.add(t(more))
    assert ti.numel == ji.numel == 70
    for k, ex in ((4, None), (6, links), (100, links)):
        want = ji.search(q, k, None if ex is None else jnp.asarray(ex))
        got = ti.search(q, k, ex)
        close(got.score, want.score, f'{name} k {k}')
        _same(got.index, want.index, f'{name} k {k}')
    close(ti.get_emb(), ji.get_emb())


@pytest.mark.parametrize('name', ['ApproxL2KNNIndex', 'ApproxMIPSKNNIndex'])
def test_approx_knn_index_matches_jax(name):
    """The subset drawn from the same seed; every row searched when the
    share reaches the whole index."""
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((80, 6)).astype(np.float32)
    q = rng.standard_normal((5, 6)).astype(np.float32)
    for cells, visit in ((100, 30), (10, 10)):
        ji = getattr(jki, name)(cells, visit, emb=emb, seed=4)
        ti = getattr(tki, name)(cells, visit, emb=emb, seed=4, **CPU)
        for _ in range(2):
            want, got = ji.search(q, 5), ti.search(q, 5)
            close(got.score, want.score)
            _same(got.index, want.index)


# -- knn_interpolate ----------------------------------------------------------
def test_knn_interpolate_matches_jax(branch):
    pos, batch, _ = _cloud(8)
    pos_y, batch_y, _ = _cloud(9, n=35)
    x = np.random.default_rng(10).standard_normal((N, 5)).astype(np.float32)

    def jf(xs):
        return jknn_interpolate(xs, jnp.asarray(pos), jnp.asarray(pos_y), 4,
                                jnp.asarray(batch), jnp.asarray(batch_y))

    cot = np.random.default_rng(11).standard_normal((35, 5)).astype(
        np.float32)
    ref, grad = jax.jit(lambda v, c: (jf(v), jax.vjp(jf, v)[1](c)[0]))(
        jnp.asarray(x), jnp.asarray(cot))
    tx = t(x).requires_grad_()
    out = knn_interpolate(tx, t(pos), t(pos_y), 4, t(batch), t(batch_y))
    close(out, ref)
    (out * t(cot)).sum().backward()
    grad_close(tx.grad, grad)


# -- nn/conv/point_conv.py and x_conv.py --------------------------------------
NP, EP, FP, PADP = 40, 150, 6, 5
XP, COOP, MASKP, WP = graph(12, NP, EP, FP, PADP)
POS = np.random.default_rng(13).standard_normal((NP, 3)).astype(np.float32)
NRM = np.random.default_rng(14).standard_normal((NP, 3)).astype(np.float32)
VARIANTS = ['coo', 'coo mask', 'EdgeIndex']


def _edges(variant):
    je, te, kw = edge_variant(variant, COOP, MASKP, WP, NP, EP)
    return je, te, ({k: jnp.asarray(v) for k, v in kw.items()},
                    {k: t(v) for k, v in kw.items()})


@pytest.mark.parametrize('variant', VARIANTS)
def test_point_net_conv_matches_jax(variant):
    je, te, (jkw, tkw) = _edges(variant)
    compare(jconv.PointNetConv(local_nn=jmodels.MLP(channel_list=[12, 10]),
                               global_nn=fnn.Dense(7)),
            conv.PointNetConv(MLP(FP + 3, [12, 10], **CPU),
                              linear(10, 7, **CPU)),
            XP, (jnp.asarray(POS), je), (t(POS), te), jkw=jkw, tkw=tkw)


@pytest.mark.parametrize('variant', VARIANTS)
def test_ppf_conv_matches_jax(variant):
    je, te, (jkw, tkw) = _edges(variant)
    compare(jconv.PPFConv(local_nn=jmodels.MLP(channel_list=[12, 9]),
                          aggr='mean'),
            conv.PPFConv(MLP(FP + 4, [12, 9], **CPU), aggr='mean'), XP,
            (jnp.asarray(POS), jnp.asarray(NRM), je),
            (t(POS), t(NRM), te), jkw=jkw, tkw=tkw)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('nets', ['default', 'attn_nn'])
def test_point_transformer_conv_matches_jax(nets, variant):
    je, te, (jkw, tkw) = _edges(variant)
    jk, tk = {}, {}
    if nets == 'attn_nn':
        jk = dict(pos_nn=jmodels.MLP(channel_list=[8, 8]),
                  attn_nn=fnn.Dense(8))
        tk = dict(pos_nn=MLP(3, [8, 8], **CPU), attn_nn=linear(8, 8, **CPU))
    compare(jconv.PointTransformerConv(out_channels=8, **jk),
            conv.PointTransformerConv(FP, 8, **tk, **CPU), XP,
            (jnp.asarray(POS), je), (t(POS), te), jkw=jkw, tkw=tkw)


def test_with_self_loops_matches_jax():
    coo = COOP.copy()
    coo[1, :6] = coo[0, :6]
    got = conv.point_conv._with_self_loops(t(coo), t(MASKP), NP)
    from pytorch_geometric_tpu.nn.conv.point_conv import \
        _with_self_loops as jwsl
    want = jwsl(jnp.asarray(coo), jnp.asarray(MASKP), NP)
    _same(got[0], want[0])
    _same(got[1], want[1])


@pytest.mark.parametrize('masked', [False, True])
def test_dynamic_edge_conv_matches_jax(branch, masked):
    """The JAX package's edge MLP with its batch norm reading the running
    statistics (``deterministic``), so the port's runs in eval mode."""
    pos, batch, mask = _cloud(15)
    x = np.concatenate([pos, pos[:, :2] ** 2], 1)
    jkw, tkw = {}, {}
    if masked:
        jkw, tkw = {'mask': jnp.asarray(mask)}, {'mask': t(mask)}
    compare(jconv.DynamicEdgeConv(
        nn=jmodels.MLP(channel_list=[12, 8], norm='batch_norm'), k=5),
        conv.DynamicEdgeConv(MLP(10, [12, 8], norm='batch_norm', **CPU), 5),
        x, (jnp.asarray(batch),), (t(batch),), jkw=jkw, tkw=tkw)


@pytest.mark.parametrize('masked', [False, True])
def test_grav_net_conv_matches_jax(masked):
    """A masked-out point has no valid neighbour: its mean and max
    aggregate to 0, as the JAX package's scatter gives an empty segment."""
    pos, batch, mask = _cloud(16)
    x = np.concatenate([pos, np.sin(pos)], 1)
    jkw, tkw = {}, {}
    if masked:
        jkw, tkw = {'mask': jnp.asarray(mask)}, {'mask': t(mask)}
    jm = jconv.GravNetConv(out_channels=7, space_dimensions=3,
                           propagate_dimensions=5, k=4)
    tm = conv.GravNetConv(6, 7, space_dimensions=3, propagate_dimensions=5,
                          k=4, **CPU)
    variables = compare(jm, tm, x, (jnp.asarray(batch),), (t(batch),),
                        jkw=jkw, tkw=tkw)
    if masked:
        # the masked points' output is lin_out1(x) + lin_out2(0)
        with torch.no_grad():
            out = tm(t(x), t(batch), t(mask))
            idle = tm.lin_out1(t(x)) + tm.lin_out2.bias
        off = ~t(mask)
        assert bool(off.any())
        np.testing.assert_allclose(out[off].numpy(), idle[off].numpy(),
                                   rtol=0, atol=1e-6)
    assert variables


@pytest.mark.parametrize('case', ['x', 'no x', 'dilation mask',
                                  'neighbor_idx'])
def test_x_conv_matches_jax(branch, case):
    """XConv in eval and training mode alike: its batch norms always read
    the running statistics (drawn away from 0 / 1 by ``compare``)."""
    pos, batch, mask = _cloud(17, n=48, clouds=2)
    x = np.random.default_rng(18).standard_normal((48, 6)).astype(
        np.float32)
    K = 5
    jkw, tkw = {}, {}
    c_in = 6
    jargs, targs = (jnp.asarray(pos), jnp.asarray(batch)), (t(pos), t(batch))
    dil = 1
    if case == 'no x':
        c_in, x = 0, None
    elif case == 'dilation mask':
        dil = 2
        jkw, tkw = {'mask': jnp.asarray(mask)}, {'mask': t(mask)}
    elif case == 'neighbor_idx':
        nb = np.random.default_rng(19).integers(0, 48, (48, K))
        nb[:, 0] = np.arange(48)
        jkw, tkw = ({'neighbor_idx': jnp.asarray(nb)},
                    {'neighbor_idx': t(nb)})
    jm = jconv.XConv(out_channels=9, dim=3, kernel_size=K, dilation=dil)
    tm = conv.XConv(c_in, 9, dim=3, kernel_size=K, dilation=dil, **CPU)
    if x is None:
        # x = None leads: the parameters' gradients only
        variables = compare(jm, tm, None, (None,) + jargs, (None,) + targs,
                            jkw=jkw, tkw=tkw)
    else:
        variables = compare(jm, tm, x, jargs, targs, jkw=jkw, tkw=tkw)
    tm.load_state_dict(flax_to_state_dict(variables))
    args = ((None, t(pos)) if x is None else (t(x), t(pos))) + (t(batch),)
    with torch.no_grad():
        _same(tm.train()(*args, **tkw), tm.eval()(*args, **tkw))


# -- path AA's model: three Adam steps ----------------------------------------
class _TrainMLP(fnn.Module):
    """The JAX package's MLP layers (``lin_i``, ``norm_i``) with its batch
    norms in training mode: what PyG's DGCNN runs, and the port's MLP in
    training mode."""
    channel_list: tuple
    norm: bool = True

    @fnn.compact
    def __call__(self, x):
        for i, ch in enumerate(self.channel_list):
            x = fnn.Dense(ch, name=f'lin_{i}')(x)
            if i == len(self.channel_list) - 1:
                break
            if self.norm:
                x = fnn.BatchNorm(use_running_average=False,
                                  name=f'norm_{i}')(x)
            x = fnn.relu(x)
        return x


class _JDGCNN(fnn.Module):
    """``chip_smoke.py::dgcnn_net`` in flax, without dropout."""
    k: int
    edge_mlp: tuple
    edge_mlp2: tuple
    lin: int
    head: tuple
    classes: int

    @fnn.compact
    def __call__(self, pos, batch, num_graphs):
        x1 = jconv.DynamicEdgeConv(nn=_TrainMLP(self.edge_mlp, parent=None),
                                   k=self.k,
                                   name='conv1')(pos, batch)
        x2 = jconv.DynamicEdgeConv(nn=_TrainMLP(self.edge_mlp2, parent=None),
                                   k=self.k,
                                   name='conv2')(x1, batch)
        out = fnn.Dense(self.lin, name='lin1')(jnp.concatenate([x1, x2], 1))
        out = jglob.global_max_pool(out, batch, num_graphs)
        out = jmodels.MLP(channel_list=[*self.head, self.classes],
                          name='mlp')(out)
        return jax.nn.log_softmax(out, -1)


def test_path_aa_steps_match_jax(monkeypatch):
    """Path AA's model at k 5, edge MLPs (6 -> 8 -> 8 -> 8, batch norm) and
    (16 -> 12), Linear 20 -> 24, head 24 -> 16 -> 8 -> 4, no dropout: three
    Adam steps (1e-3) on three batches of 4 clouds of 20 points each (the
    tiled branch, as on the card, forced here in several tiles), each
    step's loss and gradients held to
    flax's with the port at flax's parameters, and the running statistics
    after the steps."""
    for mod in (jpoint, tpoint):
        monkeypatch.setattr(mod, '_DENSE_LIMIT', 64)
        monkeypatch.setattr(mod, '_QT', 16)
        monkeypatch.setattr(mod, '_XT', 24)
    cs = _chip_smoke()
    dims = dict(k=5, edge_mlp=(8, 8, 8), edge_mlp2=(12,), lin=24,
                head=(16, 8), classes=4)
    clouds, points = 4, 20
    rng = np.random.default_rng(20)
    batches = []
    for _ in range(3):
        pos = rng.standard_normal((clouds * points, 3)).astype(np.float32)
        vec = np.repeat(np.arange(clouds), points).astype(np.int32)
        batches.append((pos, vec, rng.integers(0, 4, clouds)))
    jm = _JDGCNN(**dims)
    # drawn with numpy over the shapes, nothing compiled for init
    variables = init_variables(jm, 0, jnp.asarray(batches[0][0]),
                               jnp.asarray(batches[0][1]), clouds)
    tm = cs.dgcnn_net(torch, 'cpu', 0, dropout=0.0, **dims)

    def jloss(p, st, pos, vec, y):
        out, upd = jm.apply({'params': p, 'batch_stats': st}, pos, vec,
                            clouds, mutable=['batch_stats'])
        return -out[jnp.arange(clouds), y].mean(), upd['batch_stats']

    params, stats = variables['params'], variables['batch_stats']
    tm.load_state_dict(flax_to_state_dict(dict(variables)))
    tm.train()
    tx = optax.adam(1e-3)
    opt = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    for step, (pos, vec, y) in enumerate(batches):
        (loss, new_stats), g = grad_fn(params, stats, jnp.asarray(pos),
                                       jnp.asarray(vec), jnp.asarray(y))
        tm.load_state_dict(flax_to_state_dict({'params': params}),
                           strict=False)
        tm.zero_grad(set_to_none=True)
        tl = torch.nn.functional.nll_loss(tm(t(pos), t(vec), clouds),
                                          t(y).long())
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-4,
                                   err_msg=f'loss, step {step}')
        jgrads = flax_to_state_dict({'params': g})
        floor = 1e-6 * max(float(v.abs().max()) for v in jgrads.values())
        for k, p in tm.named_parameters():
            grad_close(p.grad, jgrads[k].numpy(), f'{k}, step {step}', floor)
        upd, opt = tx.update(g, opt)
        params, stats = optax.apply_updates(params, upd), new_stats
    want = flax_to_state_dict({'params': {}, 'batch_stats': stats})
    got = {k: v for k, v in tm.state_dict().items() if 'running' in k}
    assert set(got) == set(want) and got
    for k in want:
        close(got[k], want[k].numpy(), k)


def test_point_family_needs_a_card_by_default(monkeypatch):
    """With ``device=None`` the new modules' constructors need a card."""
    from pytorch_geometric_tpu_torch.nn import models, pool
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    builds = [lambda: conv.SplineConv(4, 4), lambda: conv.GMMConv(4, 4),
              lambda: conv.NNConv(4, 4, torch.nn.Identity()),
              lambda: conv.CGConv(4), lambda: conv.FeaStConv(4, 4),
              lambda: conv.PointTransformerConv(4, 4),
              lambda: conv.GravNetConv(4, 4), lambda: conv.XConv(4, 4),
              lambda: tki.L2KNNIndex(np.ones((3, 2), np.float32)),
              lambda: pool.TopKPooling(4), lambda: pool.SAGPooling(4),
              lambda: pool.PANPooling(4),
              lambda: models.GraphUNet(4, 8, 2),
              lambda: tpoint.decimation_indices([0, 4], 2)]
    for build in builds:
        with pytest.raises(RuntimeError, match='no CUDA card'):
            build()


def test_chip_smoke_knn_swap_check():
    """``chip_smoke.py::knn_swaps``, path AA's card-against-CPU knn check:
    a swap of two candidates at equal distance passes and is counted; a
    swap past the float32 error bound, or validity masks that differ,
    fail."""
    cs = _chip_smoke()
    pos = torch.tensor([[0., 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 3]])
    want = torch.tensor([[1, 2, 0, 2, 0, 1, 0, 1],
                         [0, 0, 1, 1, 2, 2, 3, 3]])
    valid = torch.ones(8, dtype=torch.bool)
    got = want.clone()
    got[0, :2] = torch.tensor([2, 1])          # |0-1| = |0-2|: a tie
    assert cs.knn_swaps(torch, pos, got, want, valid, valid, 2)[:2] == (2, 1)
    far = want.clone()
    far[0, 1] = 3                              # 9 against 1
    with pytest.raises(AssertionError, match='further apart'):
        cs.knn_swaps(torch, pos, far, want, valid, valid, 2)
    with pytest.raises(AssertionError, match='validity'):
        cs.knn_swaps(torch, pos, want, want, ~valid, valid, 2)
