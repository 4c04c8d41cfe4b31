"""The heterogeneous slice end to end on the CPU: path N's model
(``chip_smoke.py``, ``benchmarks/hetero_bench.py:92-101``: HGTConv twice,
then a Linear on 'paper') on the bench's graph at 0.001 scale, built from
the JAX model's parameters, trained two Adam steps against optax, on raw
COOs (the fused route's wide op) and over ``build_hgt_flash_layouts``
(every type on the flash route). The JAX package's fused branches run
under ``PGT_FORCE_PALLAS=1``, the port's kernels as their plain versions.

Tolerances: the first step's gradients in float32 with ``rtol=1e-4``,
``atol=1e-5``; the losses with ``rtol=1e-5``."""

import sys
from pathlib import Path

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pytorch_geometric_tpu.nn import HGTConv as JHGT
from pytorch_geometric_tpu.ops import build_hgt_flash_layouts as j_layouts
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict
from pytorch_geometric_tpu_torch.nn import HGTConv
from pytorch_geometric_tpu_torch.nn.inits import linear
from pytorch_geometric_tpu_torch.ops import build_hgt_flash_layouts

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def force_pallas(monkeypatch):
    monkeypatch.setenv('PGT_FORCE_PALLAS', '1')


def _close(got, ref, what='', rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


def _check_grads(module, jgrads):
    ref = flax_to_state_dict(jgrads)
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(ref)
    for k, p in named.items():
        if p.grad is None:          # not reached by the loss
            np.testing.assert_array_equal(ref[k].numpy(), 0, err_msg=k)
        else:
            _close(p.grad, ref[k], f'grad of {k}')


class _JNet(fnn.Module):
    metadata: tuple
    hidden: int
    heads: int
    classes: int

    @fnn.compact
    def __call__(self, x_dict, ei_dict, flash_layouts=None):
        for _ in range(2):
            x_dict = JHGT(self.hidden, self.metadata, heads=self.heads)(
                x_dict, ei_dict, flash_layouts)
        return fnn.Dense(self.classes)(x_dict['paper'])


class _TNet(torch.nn.Module):
    """chip_smoke.py's path N model (``benchmarks/hetero_bench.py:92-101``),
    its submodules named as flax names them."""

    def __init__(self, f, metadata, hidden, heads, classes):
        super().__init__()
        self.HGTConv_0 = HGTConv(f, hidden, metadata, heads=heads,
                                 device='cpu')
        self.HGTConv_1 = HGTConv(hidden, hidden, metadata, heads=heads,
                                 device='cpu')
        self.Dense_0 = linear(hidden, classes, device='cpu')

    def forward(self, x_dict, ei_dict, flash_layouts=None):
        x_dict = self.HGTConv_0(x_dict, ei_dict, flash_layouts)
        x_dict = self.HGTConv_1(x_dict, ei_dict, flash_layouts)
        return self.Dense_0(x_dict['paper'])


@pytest.mark.parametrize('layouts', [False, True])
def test_path_n_model_trains_as_the_jax_package(layouts):
    """Path N's model (HGT x 2, then a Linear on 'paper') on
    ``hetero_bench.py``'s graph at 0.001 scale (1,937 nodes, 36,751 edges),
    hidden 32, 2 heads, two Adam 1e-3 steps, against optax: the losses of
    both steps and of the model after them, and the first step's
    gradients. With ``layouts`` every type takes the flash route over
    ``build_hgt_flash_layouts``."""
    sys.path.insert(0, str(ROOT / 'benchmarks'))
    try:
        import hetero_bench
    finally:
        sys.path.remove(str(ROOT / 'benchmarks'))
    nodes, edges, x, y = hetero_bench.build_mag_like(0.001, seed=0)
    meta = (tuple(nodes), tuple(edges))
    jfl = tfl = None
    if layouts:
        jfl = j_layouts(meta, edges, nodes)
        tfl = build_hgt_flash_layouts(meta, edges, nodes, device='cpu')
    jnet = _JNet(meta, 32, 2, 8)
    params = jnet.init(jax.random.PRNGKey(0), x, edges, jfl)
    tnet = _TNet(64, meta, 32, 2, 8)
    tnet.load_state_dict(flax_to_state_dict(params))
    tx = optax.adam(1e-3)
    opt = tx.init(params)

    def loss_fn(p):
        logits = jnet.apply(p, x, edges, jfl)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    topt = torch.optim.Adam(tnet.parameters(), lr=1e-3)
    tdict = {t: torch.from_numpy(v) for t, v in x.items()}
    tei = {k: torch.from_numpy(v) for k, v in edges.items()}
    ty = torch.from_numpy(y).long()
    for step in range(2):
        jloss, jgrads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(jgrads, opt)
        params = optax.apply_updates(params, updates)
        topt.zero_grad()
        tloss = F.cross_entropy(tnet(tdict, tei, tfl), ty)
        tloss.backward()
        if step == 0:
            _check_grads(tnet, jgrads)
        topt.step()
        _close(tloss, jloss, f'loss {step}', rtol=1e-5, atol=0)
    _close(F.cross_entropy(tnet(tdict, tei, tfl), ty), loss_fn(params),
           'loss after 2 steps', rtol=1e-5, atol=0)
