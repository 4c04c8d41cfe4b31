"""Helpers of the port's parity tests against the JAX package: a flax
module and the port's module of the same architecture run on the same numpy
inputs from the same variables (drawn with numpy, carried across by
``convert.flax_to_state_dict``), and their outputs and gradients compared.

Tolerances: outputs within 1e-5 * max(1, max|ref|); gradients (the input's
and every parameter's, of ``sum(out * cot)``) within 1e-4 of each
gradient's largest entry, or within 1e-6 of the largest gradient of all
where a gradient vanishes in exact arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pytorch_geometric_tpu.edge_index import EdgeIndex as JEdgeIndex
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.convert import flax_to_state_dict

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def close(got, ref, what='', tol=OUT_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    atol = tol * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


def grad_close(got, ref, what='', floor=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = max(GRAD_TOL * float(np.abs(ref).max(initial=0.0)), floor, 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def init_variables(jm, seed, *args, method=None, **kw):
    """Variables of ``jm``'s shapes drawn with numpy (``jax.eval_shape`` of
    ``jm.init``, nothing compiled): matrices normal with variance 1 /
    fan-in, vectors normal / 10 (norms' scales 1 + normal / 10), running
    means normal / 10, running variances uniform in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(seed), *args,
                                            method=method, **kw))
    rng = np.random.default_rng(seed + 100)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == 'var':
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif len(leaf.shape) < 2:
            v = rng.standard_normal(leaf.shape) * 0.1 + (name == 'scale')
        else:
            fan = int(np.prod(leaf.shape[:-1]))
            v = rng.standard_normal(leaf.shape) / np.sqrt(max(fan, 1))
        return jnp.asarray(v, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _leaves(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, (tuple, list)) else [out]


def compare(jm, tm, x, jargs=(), targs=(), jkw=None, tkw=None, train=False,
            variables=None, seed=0, method=None, tmethod=None, partial=None,
            out_tol=OUT_TOL):
    """The flax module ``jm`` and the port's ``tm`` on ``x`` (then
    ``jargs`` / ``targs``; ``x=None`` calls them on those alone), through
    ``method`` / ``tmethod`` when given: every output (a tuple's too), the
    gradients of ``sum(out * cot)`` for ``x`` and every parameter, and in
    ``train`` mode the updated batch statistics (``tmethod`` may be a
    callable of the port module's inputs). ``partial`` names a
    parameter whose gradient is held only on a slice (``{name: slice}``: a
    parameter the port's module has and flax's lacks in part). Returns the
    variables."""
    jkw, tkw = dict(jkw or {}), dict(tkw or {})
    xj = None if x is None else jnp.asarray(x)
    head = () if x is None else (xj,)
    if variables is None:
        variables = init_variables(jm, seed, *head, *jargs, method=method,
                                   **jkw)
    variables = dict(variables)
    variables.setdefault('params', {})
    rest = {k: v for k, v in variables.items() if k != 'params'}
    stats = train and 'batch_stats' in rest

    def japply(p, xs):
        v = {'params': p, **rest}
        args = (() if xs is None else (xs,)) + tuple(jargs)
        if stats:
            return jm.apply(v, *args, mutable=['batch_stats'],
                            method=method, **jkw)
        return jm.apply(v, *args, method=method, **jkw), None

    shapes = jax.eval_shape(lambda p, xs: japply(p, xs)[0],
                            variables['params'], xj)
    rng = np.random.default_rng(seed + 7)
    cots = [rng.standard_normal(s.shape).astype(np.float32)
            for s in _leaves(shapes)]

    def jloss(p, xs):
        out, upd = japply(p, xs)
        loss = sum((o * c).sum() for o, c in zip(_leaves(out), cots))
        return loss, (out, upd)

    x_float = x is not None and np.asarray(x).dtype.kind == 'f'
    argnums = (0, 1) if x_float else (0,)
    (_, (ref, upd)), grads = jax.jit(jax.value_and_grad(
        jloss, argnums, has_aux=True))(variables['params'], xj)
    jgp = grads[0]
    jgx = grads[1] if x_float else None
    tm.load_state_dict(flax_to_state_dict(variables))
    tm.train(train)
    tx = None if x is None else torch.from_numpy(
        np.array(x)).requires_grad_(x_float)
    fn = (tm if tmethod is None else
          tmethod if callable(tmethod) else getattr(tm, tmethod))
    out = fn(*(() if tx is None else (tx,)), *targs, **tkw)
    outs, refs = _leaves(out), _leaves(ref)
    assert len(outs) == len(refs)
    for i, (o, r) in enumerate(zip(outs, refs)):
        close(o, r, f'output {i}', out_tol)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    if loss.requires_grad:
        loss.backward()
    jgrads = flax_to_state_dict({'params': jgp})
    named = dict(tm.named_parameters())
    assert set(named) <= set(jgrads), sorted(set(named) - set(jgrads))
    assert set(jgrads) <= set(named) | {k for k, _ in tm.named_buffers()}, \
        sorted(set(jgrads) - set(named))
    scale = [float(g.abs().max()) for g in jgrads.values() if g.numel()]
    if tx is not None and tx.requires_grad:
        scale.append(float(np.abs(np.asarray(jgx)).max()))
        grad_close(tx.grad, jgx, 'grad x', 1e-6 * max(scale))
    floor = 1e-6 * max(scale, default=0.0)
    partial = partial or {}
    for k, p in named.items():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        want = jgrads[k].numpy()
        if k in partial:
            got, want = got[partial[k]], want[partial[k]]
        grad_close(got, want, k, floor)
    if stats:
        want = flax_to_state_dict({'params': {},
                                   'batch_stats': upd['batch_stats']})
        got = {k: v for k, v in tm.state_dict().items() if 'running' in k}
        assert set(got) == set(want) and got
        for k in want:
            close(got[k], want[k].numpy(), k)
    return variables


def graph(seed, n, e, f, pad=0):
    """A random graph: x ``[n, f]``, the COO (``pad`` extra edges at the
    sentinel ``n``), an edge mask (False on the padded edges and on a few
    random ones) and positive edge weights."""
    rng = np.random.default_rng(seed)
    coo = rng.integers(0, n, (2, e)).astype(np.int32)
    coo = np.concatenate([coo, np.full((2, pad), n, np.int32)], 1)
    mask = np.concatenate([rng.random(e) < 0.85, np.zeros(pad, bool)])
    x = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, e + pad).astype(np.float32)
    return x, coo, mask, w


def edge_variant(variant, coo, mask, w, n, e, weighted=False,
                 mask_name='edge_mask', cached=False):
    """``(JAX edges, port edges, keywords)`` of one edge variant of ``coo``
    (``e`` real edges over ``n`` nodes, then the padded ones): ``'coo'``
    the real edges; ``'coo mask'`` every edge, ``mask`` under
    ``mask_name`` (and the weights ``w`` when ``weighted``);
    ``'EdgeIndex'`` the real edges as each package's ``EdgeIndex``, its
    caches filled when ``cached`` (and the real edges' weights)."""
    kw = {}
    if variant == 'coo':
        return jnp.asarray(coo[:, :e]), t(coo[:, :e]), kw
    if variant == 'coo mask':
        kw[mask_name] = mask
        if weighted:
            kw['edge_weight'] = w
        return jnp.asarray(coo), t(coo), kw
    if weighted:
        kw['edge_weight'] = w[:e]
    je = JEdgeIndex(coo[:, :e], (n, n))
    te = EdgeIndex(coo[:, :e], (n, n), device='cpu')
    if cached:
        je, te = je.fill_cache(), te.fill_cache()
    return je, te, kw


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def j(a):
    return None if a is None else jnp.asarray(a)
