"""``compat.compile`` (the port's ``jax.jit``: a captured CUDA graph) on the
CPU, where it runs the function as it is, and the two capture hazards it
met, each under a mocked capture: an ``EdgeIndex`` without a size, and a
block layout without its row order. The captures themselves run on the
card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.compat import (
    is_torch_instance as jis_torch_instance)
from pytorch_geometric_tpu_torch import EdgeIndex, compat
from pytorch_geometric_tpu_torch.compat import (cache_key, is_compiling,
                                                is_torch_instance)
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import cache_gcn_norm
from pytorch_geometric_tpu_torch.nn.models import GCN
from pytorch_geometric_tpu_torch.ops import spmm
from pytorch_geometric_tpu_torch.ops.bsr_spmm import (BSR, bsr_matmul,
                                                      build_bsr_pair,
                                                      row_order,
                                                      transpose_bsr)


def _graph(n=300, e=3000, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, n // 128 + 1, e)
    coo = np.stack([np.clip(c * 128 + rng.integers(0, 128, e), 0, n - 1),
                    np.clip(c * 128 + rng.integers(0, 128, e), 0, n - 1)])
    return coo.astype(np.int32), rng


def test_cpu_tensors_run_eagerly_one_call_each():
    """On CPU tensors every call runs ``fn`` once and returns its result;
    nothing is captured."""
    calls = []

    def fn(x, scale, extra=None):
        calls.append(1)
        return {'y': x * scale, 'pair': (x.sum(), extra)}

    f = compat.compile(fn)
    x = torch.arange(6.0).view(2, 3)
    for i in range(5):
        out = f(x, i, extra='e')
        assert torch.equal(out['y'], x * i)
        assert out['pair'][1] == 'e'
    assert len(calls) == 5
    assert f.captures == 0 and f.replays == 0
    assert f.launches_per_replay == {} and f.replay_launches() == {}


def test_compiled_training_step_follows_eager_on_cpu():
    """A compiled GCN step over the CPU plain path takes the eager steps,
    bit for bit, call for call."""
    coo, rng = _graph()
    ei = EdgeIndex(coo, (300, 300), device='cpu').fill_cache()
    x = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 300))
    runs = []
    for wrap in (lambda f: f, compat.compile):
        model = GCN(8, 16, 2, 3, device='cpu',
                    generator=torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)

        def step(x, ei, y):
            opt.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(model(x, ei), y)
            loss.backward()
            opt.step()
            return loss.detach()

        step = wrap(step)
        runs.append([step(x, ei, y) for _ in range(5)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_key_follows_shape_dtype_and_non_tensor_arguments():
    x = torch.zeros(4, 3)
    ei = EdgeIndex(np.array([[0, 1], [1, 0]], np.int32), (2, 2),
                   device='cpu')
    base = cache_key((x, ei, 2), {'mode': 'sum'})
    assert base == cache_key((torch.ones(4, 3), ei, 2), {'mode': 'sum'})
    others = [
        cache_key((torch.zeros(5, 3), ei, 2), {'mode': 'sum'}),     # shape
        cache_key((x.double(), ei, 2), {'mode': 'sum'}),            # dtype
        cache_key((torch.zeros(4, 3, requires_grad=True), ei, 2),
                  {'mode': 'sum'}),                                  # grad
        cache_key((x, ei, 3), {'mode': 'sum'}),                     # value
        cache_key((x, ei, 2.0), {'mode': 'sum'}),                   # type
        cache_key((x, ei, 2), {'mode': 'mean'}),                    # kwarg
        cache_key((x, EdgeIndex(ei.coo, (2, 2)), 2), {'mode': 'sum'}),
        cache_key(([x], ei, 2), {'mode': 'sum'}),                   # tree
    ]
    for k in others:
        assert k != base
    with torch.no_grad():
        assert cache_key((x, ei, 2), {'mode': 'sum'}) != base
    with torch.inference_mode():
        assert cache_key((x, ei, 2), {'mode': 'sum'}) != base
    # a static tensor counts by identity
    assert cache_key((x,), static_argnums=(0,)) == cache_key(
        (x,), static_argnums=(0,))
    assert cache_key((x,), static_argnums=(0,)) != cache_key(
        (x.clone(),), static_argnums=(0,))
    # a dict's tensors take part by shape, in a fixed order
    assert cache_key(({'a': x, 'b': x[0]},)) != cache_key(
        ({'a': x[0], 'b': x},))


def test_unhashable_arguments_are_refused():
    """An argument that is neither a tensor, nor a tuple, list or dict, nor
    hashable is refused, as ``jit`` refuses an unhashable static argument;
    at a static position too, and before ``fn`` runs."""
    calls = []
    f = compat.compile(lambda a, b=None: calls.append(1),
                       static_argnums=(0,))
    for args, kwargs in (((np.zeros(3),), {}),
                         ((1,), {'b': np.zeros(3)}),
                         ((1,), {'b': [{'k': {3}}]})):
        with pytest.raises(TypeError, match='not hashable'):
            f(*args, **kwargs)
        with pytest.raises(TypeError, match='not hashable'):
            cache_key(args, kwargs, static_argnums=(0,))
    assert not calls


def test_identity_keys_die_with_their_objects():
    """A key that names a tensor or a module by identity holds no reference
    to it: its entry goes when the object dies, and a live one keeps its
    entry."""
    import gc
    import weakref
    f = compat.compile(lambda t, m: t, static_argnums=(0,))
    table, keep = torch.zeros(3), torch.nn.Linear(2, 2)
    for t, m in ((table, keep), (torch.ones(3), torch.nn.Linear(2, 2))):
        key, _, objs = compat._split((t, m), {}, f.static_argnums)
        f._new_capture(key, objs)
    del t, m, objs
    gone = torch.ones(1)
    ref = weakref.ref(gone)
    key, _, objs = compat._split((gone, keep), {}, f.static_argnums)
    f._new_capture(key, objs)
    del gone, objs
    gc.collect()
    assert ref() is None
    assert len(f._captures) == 1
    assert compat._split((table, keep), {}, f.static_argnums)[0] in \
        f._captures


def test_is_compiling_outside_a_capture():
    assert is_compiling() is False


def test_is_torch_instance_sees_through_the_wrapper():
    model = GCN(4, 8, 2, 2, device='cpu')
    compiled = compat.compile(model)
    assert not isinstance(compiled, GCN)
    assert is_torch_instance(compiled, GCN)
    assert is_torch_instance(model, GCN)
    assert not is_torch_instance(compiled, torch.nn.Linear)
    # the JAX package's rule: look through __wrapped__
    assert jis_torch_instance(compiled, GCN)
    # and the wrapped module runs as it is on the CPU
    ei = EdgeIndex(np.array([[0, 1, 2], [1, 2, 0]], np.int32), (3, 3),
                   device='cpu').fill_cache()
    x = torch.ones(3, 4)
    assert torch.equal(compiled(x, ei), model(x, ei))


def test_decorator_and_refusals():
    @compat.compile(warmup=1, static_argnums=(0,))
    def f(table, i):
        return table[i]

    assert f.warmup == 1 and f.static_argnums == {0}
    assert torch.equal(f(torch.arange(4), torch.tensor(2)), torch.tensor(2))
    with pytest.raises(ValueError, match='warmup'):
        compat.compile(lambda: 0, warmup=-1)


def test_launch_counts_name_every_kernel_arm():
    assert sorted(compat.launch_counts()) == sorted([
        'segment_spmm', 'segment_spmm_bf16', 'bsr_spmm', 'bsr_spmm_bf16',
        'gat_mix', 'gat_mix_bf16', 'segment_max', 'edge_dot',
        'edge_dot_bf16'])


@pytest.fixture
def capturing(monkeypatch):
    """A mocked capture: the port's probe says a stream captures."""
    monkeypatch.setattr(compat, 'is_compiling', lambda: True)


def test_unsized_edge_index_raises_under_capture(capturing):
    coo = torch.tensor([[0, 1, 2], [1, 2, 0]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match=r'pass sparse_size=\(num_src, '
                                           r'num_dst\)'):
        EdgeIndex(coo, device='cpu')
    # spmm builds one from a raw COO: the same message
    with pytest.raises(RuntimeError, match='sparse_size'):
        spmm(coo, torch.ones(3, 2))
    # a sized one needs no wait
    assert EdgeIndex(coo, (3, 3), device='cpu').sparse_size == (3, 3)


def test_unsized_edge_index_reads_its_size_eagerly():
    coo = torch.tensor([[0, 1, 5], [1, 2, 0]], dtype=torch.int32)
    assert EdgeIndex(coo, device='cpu').sparse_size == (6, 6)


@pytest.mark.parametrize('bf16', [False, True])
def test_block_layouts_carry_their_row_order(bf16):
    """Every layout the port builds carries ``order``, so the wrapper never
    reads ``row_ptr`` on the host: ``build_bsr_pair`` (forward and
    transposed), ``transpose_bsr`` and ``fill_cache``'s caches, bf16 blocks
    too."""
    coo, _ = _graph(600, 8000, seed=1)
    w = np.ones(coo.shape[1], np.float32)
    fwd, bwd, _ = build_bsr_pair(coo, w, 600, 600)
    ei = cache_gcn_norm(EdgeIndex(coo, (600, 600), device='cpu'),
                        block_sparse=True,
                        cache_dtype=torch.bfloat16 if bf16 else None)
    assert ei.bsr.vals.dtype == (torch.bfloat16 if bf16 else torch.float32)
    layouts = [fwd, bwd, transpose_bsr(fwd, 600), ei.bsr, ei.bsr_t,
               ei.flip().bsr]
    for layout in layouts:
        assert layout.order is not None
        assert layout.order.dtype == torch.int32
        np.testing.assert_array_equal(layout.order.numpy(),
                                      row_order(layout.row_ptr.numpy()))


def test_layout_without_order_raises_under_capture(capturing):
    coo, rng = _graph(600, 8000, seed=2)
    fwd, _, _ = build_bsr_pair(coo, np.ones(coo.shape[1], np.float32), 600,
                               600)
    x = torch.from_numpy(rng.standard_normal((600, 4)).astype(np.float32))
    with pytest.raises(RuntimeError, match='fill_cache'):
        bsr_matmul(BSR(fwd.vals, fwd.cols, fwd.row_ptr), x, 600)
    # with its order the layout runs (here: the plain version)
    assert bsr_matmul(fwd, x, 600).shape == (600, 4)
