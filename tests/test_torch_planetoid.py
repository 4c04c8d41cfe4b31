"""The port's ``datasets/planetoid.py`` against the JAX package's, on the
CPU, and the slice as a whole: a Planetoid-format graph through both
packages' parsers, ``NormalizeFeatures`` and the Kipf & Welling GCN.

The raw files are ``chip_smoke.py::planetoid_raw``'s (path AD's), written
at small shapes: pickled scipy CSR features, one-hot labels, a neighbour
dict salted with self loops and duplicate entries, a shuffled
``test.index``. Parsing is compared bitwise: x, y, the masks and the edge
order, dtypes included, for the Cora branch and CiteSeer's refill branch
(isolated test ids missing from ``tx``). The GCN's 3 Adam steps (first-
layer weight decay, dropout off) are held to the JAX package's GCN with
optax: losses within 1e-5 relative, each step's gradients within 1e-5 of
the largest; the JAX side runs its Pallas segment sum in interpret mode
(``PGT_FORCE_PALLAS=1``, its edge floor lowered to this graph's size)."""

import importlib
import importlib.util
import pickle
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu import datasets as jds
from pytorch_geometric_tpu.nn.conv.gcn_conv import gcn_norm as jgcn_norm
from pytorch_geometric_tpu.nn.models import GCN as JGCN
from pytorch_geometric_tpu.ops import spmm_regime as jspmm_regime
from pytorch_geometric_tpu.transforms import NormalizeFeatures as JNorm
from pytorch_geometric_tpu_torch import datasets as tds
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_under_test', ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


CS = _chip_smoke()
# published shapes cut down: nodes, features, classes, training rows, allx
# rows, isolated test ids (CiteSeer's refill), directed edges after parsing
SHAPES = {
    'cora': dict(nodes=260, features=90, classes=7, train=21, allx=160,
                 missing=0, edges=1000),
    'citeseer': dict(nodes=330, features=120, classes=6, train=18,
                     allx=200, missing=7, edges=900),
    'pubmed': dict(nodes=400, features=50, classes=3, train=9, allx=250,
                   missing=0, edges=1800)}


def _same_data(got, want, what=''):
    assert got.num_nodes == want.num_nodes, what
    assert sorted(got.keys()) == sorted(want.keys()), what
    for k in want.keys():
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f'{what} {k}')


def _raw(tmp_path, name, seed=3):
    """The raw files under ``tmp_path/jax`` and a copy under
    ``tmp_path/port``: each package processes into its own root."""
    shape = CS.planetoid_raw(str(tmp_path / 'jax'), name, seed,
                             SHAPES[name])
    shutil.copytree(tmp_path / 'jax', tmp_path / 'port')
    return shape


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_planetoid_matches_jax(tmp_path, name):
    """Both packages parse the same raw bytes to the same graph, bit for
    bit; the raw graph holds self loops and duplicates, which parsing
    removes; a second instance reads the port's processed file back."""
    shape = _raw(tmp_path, name)
    raw = tmp_path / 'jax' / name / 'raw'
    with open(raw / f'ind.{name}.graph', 'rb') as f:
        graph = pickle.load(f, encoding='latin1')
    entries = [(a, b) for a, nbrs in graph.items() for b in nbrs]
    assert any(a == b for a, b in entries)
    assert len(set(entries)) < len(entries)
    want = jds.Planetoid(str(tmp_path / 'jax'), name)[0]
    got = tds.Planetoid(str(tmp_path / 'port'), name)[0]
    _same_data(got, want, name)
    again = tds.Planetoid(str(tmp_path / 'port'), name)
    assert (tmp_path / 'port' / name / 'processed' / 'data.pt').exists()
    _same_data(again[0], want, f'{name} reloaded')
    assert got.num_nodes == shape['nodes']
    assert got.num_edges == shape['edges']
    assert int(got.train_mask.sum()) == shape['train']
    # the JAX package marks every id of the test range, the refilled
    # isolated ones too
    assert int(got.test_mask.sum()) == shape['test'] + shape['missing']
    missing = shape['missing_ids']
    assert len(missing) == shape['missing']
    if missing:
        assert not got.x[missing].any()
        coo = got.edge_index.numpy()
        assert not np.isin(coo, missing).any()
    assert again.num_classes == shape['classes']


def test_nell_reads_planetoid_files(tmp_path):
    """``NELL`` is ``Planetoid`` under the name ``nell.0.001``: the same
    graph as the JAX package's from the same files."""
    src = tmp_path / 'gen'
    CS.planetoid_raw(str(src), 'cora', 5, SHAPES['cora'])
    for pkg in ('jax', 'port'):
        raw = tmp_path / pkg / 'nell.0.001' / 'raw'
        raw.mkdir(parents=True)
        for f in (src / 'cora' / 'raw').iterdir():
            shutil.copy(f, raw / f.name.replace('.cora.', '.nell.0.001.'))
    want = jds.NELL(str(tmp_path / 'jax'))[0]
    got = tds.NELL(str(tmp_path / 'port'))[0]
    _same_data(got, want, 'nell')


def test_missing_raw_files_raise(tmp_path):
    """No download: both packages raise where the raw files are missing."""
    with pytest.raises(RuntimeError, match='no network egress'):
        jds.Planetoid(str(tmp_path / 'jax'), 'cora')
    with pytest.raises(RuntimeError, match='downloads nothing'):
        tds.Planetoid(str(tmp_path / 'port'), 'cora')


def test_planetoid_raw_published_shapes():
    """``planetoid_raw``'s table: the published node, feature, class,
    split and edge counts, and rows of allx plus tx plus the missing test
    ids adding up to the nodes."""
    assert CS.PLANETOID['cora']['edges'] == 10_556
    assert CS.PLANETOID['citeseer']['edges'] == 9104
    assert CS.PLANETOID['pubmed']['edges'] == 88_648
    for name, s in CS.PLANETOID.items():
        assert s['allx'] + 1000 + s['missing'] == s['nodes'], name
        assert s['train'] == 20 * s['classes'], name


STEPS = 3


def test_gcn_on_planetoid_steps_match_jax(tmp_path, monkeypatch):
    """The slice as a whole: a small Cora-format graph parsed by both
    packages, ``NormalizeFeatures``, the GCN normalisation computed once
    and carried as edge weights, ``GCN(F, 16, 2, classes)`` from the flax
    parameters; 3 Adam steps at lr 0.01 with weight decay 5e-4 on the
    first layer only, dropout off (the port's model built by
    ``chip_smoke.py::planetoid_gcn``, its optimizer by
    ``planetoid_opt``, its inputs by ``planetoid_inputs``) against the
    JAX GCN and optax on the CPU."""
    monkeypatch.setenv('PGT_FORCE_PALLAS', '1')
    monkeypatch.setattr(importlib.import_module(
        'pytorch_geometric_tpu.ops.spmm'), '_PALLAS_MIN_EDGES', 256)
    shape = _raw(tmp_path, 'cora', seed=11)
    jd = jds.Planetoid(str(tmp_path / 'jax'), 'cora', transform=JNorm())[0]
    td = tds.Planetoid(str(tmp_path / 'port'), 'cora',
                       transform=NormalizeFeatures())[0]
    n, f, c = shape['nodes'], shape['features'], shape['classes']
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x))

    coo, w = jgcn_norm(jnp.asarray(jd.edge_index), None, n)
    jei = JEdgeIndex(np.asarray(coo), (n, n)).fill_cache()
    assert jspmm_regime(jei, 16, has_edge_weight=True) == 'pallas'
    train = np.nonzero(np.asarray(jd.train_mask))[0]
    x, y = jnp.asarray(jd.x), jnp.asarray(jd.y)
    jm = JGCN(hidden_channels=16, num_layers=2, out_channels=c, dropout=0.5,
              conv_kwargs={'normalize': False, 'add_self_loops': False})
    params = jm.init(jax.random.PRNGKey(0), x, jei, edge_weight=w)

    def jloss(p):
        out = jm.apply(p, x, jei, edge_weight=w)
        return optax.softmax_cross_entropy_with_integer_labels(
            out[train], y[train]).mean()

    first = jax.tree_util.tree_map_with_path(
        lambda path, _: "['conv_0']" in jax.tree_util.keystr(path), params)
    assert sum(jax.tree_util.tree_leaves(first)) == 2
    tx = optax.chain(optax.add_decayed_weights(5e-4, first),
                     optax.adam(0.01))
    step = jax.jit(jax.value_and_grad(jloss))
    opt_state = tx.init(params)
    ref_losses, ref_grads = [], []
    for _ in range(STEPS):
        loss, g = step(params)
        ref_losses.append(float(loss))
        ref_grads.append(flax_to_state_dict(g))
        upd, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, upd)

    tm = CS.planetoid_gcn(torch, 'cpu', 0, f, c)
    tm.load_state_dict(flax_to_state_dict(jm.init(
        jax.random.PRNGKey(0), x, jei, edge_weight=w)))
    tm.eval()    # dropout off
    inputs = CS.planetoid_inputs(torch, td, 'cpu')
    np.testing.assert_allclose(inputs[2].numpy(), np.asarray(w), rtol=1e-6)
    opt = CS.planetoid_opt(torch, tm)
    for i in range(STEPS):
        opt.zero_grad(set_to_none=True)
        loss = CS.planetoid_loss(torch, tm, *inputs[:5])
        loss.backward()
        np.testing.assert_allclose(loss.item(), ref_losses[i], rtol=1e-5)
        largest = max(float(v.abs().max()) for v in ref_grads[i].values())
        for k, p in tm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), ref_grads[i][k],
                                       rtol=0, atol=1e-5 * largest,
                                       err_msg=f'step {i} {k}')
        opt.step()
    assert ref_losses[-1] < ref_losses[0]
