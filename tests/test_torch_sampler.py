"""The port's neighbour samplers (``sampler/neighbor_sampler.py`` on the
port's build of ``csrc/sampler.cpp``) against the JAX package's, on the CPU.

The same graph and seeds, made from a numpy seed, go into both; every field
of every ``SamplerOutput`` must be equal, bit for bit and dtype for dtype:
``sample_from_nodes`` and ``sample_from_edges`` (binary and triplet
negatives), without and with replacement, disjoint, temporal (node and edge
times, 'uniform' and 'last'), weighted, and the bidirectional sampler. The
native and numpy paths draw different neighbours by design, so each is held
against its own counterpart: port-native against JAX-native, port-numpy
against JAX-numpy, with both packages' ``WITH_NATIVE_SAMPLER`` flags set.
Also: the sampler library builds from several processes at once."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pytorch_geometric_tpu.csrc as jcsrc
from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.sampler import (
    BidirectionalNeighborSampler as JBidirectional,
    EdgeSamplerInput as JEdgeInput, NegativeSampling as JNegative,
    NeighborSampler as JNeighborSampler, NodeSamplerInput as JNodeInput)
from pytorch_geometric_tpu_torch import csrc
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.sampler import (
    BidirectionalNeighborSampler, EdgeSamplerInput, NegativeSampling,
    NeighborSampler, NodeSamplerInput, NumNeighbors)

ROOT = Path(__file__).resolve().parents[1]
N, E = 120, 700


@pytest.fixture(params=['native', 'numpy'])
def path(request, monkeypatch):
    """Both packages on the native sampler, or both on their numpy one."""
    native = request.param == 'native'
    if native:
        assert jcsrc.WITH_NATIVE_SAMPLER and csrc.WITH_NATIVE_SAMPLER
    monkeypatch.setattr(jcsrc, 'WITH_NATIVE_SAMPLER', native)
    monkeypatch.setattr(csrc, 'WITH_NATIVE_SAMPLER', native)
    return request.param


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    coo = np.stack([rng.integers(0, N, E), rng.integers(0, N, E)])
    fields = dict(edge_index=coo.astype(np.int32),
                  node_time=rng.integers(0, 50, N).astype(np.float64),
                  edge_time=rng.integers(0, 50, E).astype(np.float64),
                  weight=rng.random(E) * (rng.random(E) < 0.9))
    return JData(num_nodes=N, **fields), Data(num_nodes=N, **fields), rng


def _outputs_equal(got, ref):
    for k, r in vars(ref).items():
        g = getattr(got, k)
        if r is None or isinstance(r, (int, list)):
            assert g == r, k
        elif isinstance(r, dict):
            assert sorted(g) == sorted(r), k
            for kk in r:
                a, b = np.asarray(g[kk]), np.asarray(r[kk])
                assert a.dtype == b.dtype, (k, kk)
                np.testing.assert_array_equal(a, b, err_msg=f'{k}.{kk}')
        else:
            assert g.dtype == r.dtype and g.shape == r.shape, k
            np.testing.assert_array_equal(g, r, err_msg=k)


NODE_CASES = {
    'uniform': {},
    'replace': {'replace': True},
    'disjoint': {'disjoint': True},
    'node_time_uniform': {'time_attr': 'node_time'},
    'node_time_last': {'time_attr': 'node_time', 'temporal_strategy': 'last'},
    'edge_time': {'time_attr': 'edge_time'},
    'weighted': {'weight_attr': 'weight'},
    'weighted_replace': {'weight_attr': 'weight', 'replace': True},
}


def _valid(out, coo, seeds):
    """The invariants of a batch: seeds first, every sampled edge a real
    edge of the graph with its recorded id, per-hop counts that add up."""
    np.testing.assert_array_equal(out.node[:len(seeds)], seeds)
    for k in np.nonzero(out.edge_mask)[0]:
        src, dst = out.node[out.row[k]], out.node[out.col[k]]
        assert coo[0, out.edge[k]] == src and coo[1, out.edge[k]] == dst
    assert sum(out.num_sampled_edges) == out.edge_mask.sum()
    assert sum(out.num_sampled_nodes) == out.node_mask.sum()


def test_numpy_replace_path_draws_per_row():
    """The numpy path with replacement: the JAX package's raises (its
    per-row bounds do not broadcast to ``(frontier, fanout)``); the port's
    draws ``fanout`` in-neighbours per frontier node, with repeats."""
    jdata, data, rng = _graph(1)
    seeds = np.unique(rng.integers(0, N, 6))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcsrc, 'WITH_NATIVE_SAMPLER', False)
        mp.setattr(csrc, 'WITH_NATIVE_SAMPLER', False)
        with pytest.raises(ValueError, match='broadcast'):
            JNeighborSampler(jdata, [4, 3], replace=True).sample_from_nodes(
                JNodeInput(node=seeds))
        out = NeighborSampler(data, [4, 3], replace=True,
                              seed=3).sample_from_nodes(
            NodeSamplerInput(node=seeds))
    _valid(out, np.asarray(jdata.edge_index), seeds)
    deg = np.diff(NeighborSampler(data, [1]).csc.colptr)[seeds]
    assert out.num_sampled_edges[0] == 4 * (deg > 0).sum()


# the numpy path with replacement is held by the test above: the JAX
# package's raises there
@pytest.mark.parametrize('path,case', [
    (p, c) for p in ('native', 'numpy') for c in sorted(NODE_CASES)
    if (p, c) != ('numpy', 'replace')], indirect=['path'])
def test_sample_from_nodes_matches_jax(path, case):
    jdata, data, rng = _graph(1)
    kw = NODE_CASES[case]
    jsampler = JNeighborSampler(jdata, [4, 3], seed=3, **kw)
    sampler = NeighborSampler(data, [4, 3], seed=3, **kw)
    assert sampler.disjoint == jsampler.disjoint
    for call in range(3):
        seeds = rng.integers(0, N, 6)
        time = (rng.integers(10, 50, 6).astype(np.float64)
                if case == 'edge_time' else None)
        # the loader's per-call seed on the odd calls, the sampler's own
        # generator on the even ones
        rng_seed = int(rng.integers(0, 2 ** 62)) if call % 2 else None
        ref = jsampler.sample_from_nodes(JNodeInput(node=seeds, time=time),
                                         rng_seed=rng_seed)
        got = sampler.sample_from_nodes(NodeSamplerInput(node=seeds,
                                                         time=time),
                                        rng_seed=rng_seed)
        _outputs_equal(got, ref)
        assert got.edge_mask.any()


@pytest.mark.parametrize('mode', [None, 'binary', 'triplet'])
def test_sample_from_edges_matches_jax(path, mode):
    jdata, data, rng = _graph(2)
    jsampler = JNeighborSampler(jdata, [3, 2], seed=4)
    sampler = NeighborSampler(data, [3, 2], seed=4)
    coo = np.asarray(jdata.edge_index)
    for _ in range(2):
        idx = rng.integers(0, E, 8)
        label = rng.integers(0, 2, 8).astype(np.float32)
        neg = (None if mode is None else (JNegative(mode, 1.5),
                                          NegativeSampling(mode, 1.5)))
        ref = jsampler.sample_from_edges(
            JEdgeInput(row=coo[0, idx], col=coo[1, idx], label=label),
            neg_sampling=None if neg is None else neg[0])
        got = sampler.sample_from_edges(
            EdgeSamplerInput(row=coo[0, idx], col=coo[1, idx], label=label),
            neg_sampling=None if neg is None else neg[1])
        _outputs_equal(got, ref)


def test_bidirectional_sampler_matches_jax(path):
    jdata, data, rng = _graph(3)
    jsampler = JBidirectional(jdata, [5, 2], seed=1)
    sampler = BidirectionalNeighborSampler(data, [5, 2], seed=1)
    np.testing.assert_array_equal(sampler.csc.row, jsampler.csc.row)
    seeds = rng.integers(0, N, 7)
    _outputs_equal(sampler.sample_from_nodes(NodeSamplerInput(node=seeds)),
                   jsampler.sample_from_nodes(JNodeInput(node=seeds)))


def test_sampler_takes_tensors_and_tuples():
    """The graph may come as a ``Data`` of tensors or an ``(edge_index,
    num_nodes)`` tuple; the CSC views are the JAX package's either way."""
    jdata, data, _ = _graph(4)
    coo = torch.tensor(np.asarray(jdata.edge_index), dtype=torch.int64)
    ref = JNeighborSampler(jdata, [2])
    for graph in (Data(edge_index=coo, num_nodes=N), (coo, N)):
        s = NeighborSampler(graph, [2])
        for a, b in zip(s._csc_c, ref._csc_c):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)


def test_budgets_and_refusals():
    nn = NumNeighbors([4, 3])
    assert nn.num_hops == 2
    assert nn.node_budget(5) == [5, 20, 60]
    assert nn.edge_budget(5) == [20, 60]
    _, data, _ = _graph(5)
    with pytest.raises(ValueError, match='temporal_strategy'):
        NeighborSampler(data, [2], temporal_strategy='first')
    with pytest.raises(ValueError, match='entries'):
        NeighborSampler(data.replace(bad=np.zeros(7)), [2], time_attr='bad')
    s = NeighborSampler(data, [2], time_attr='edge_time')
    with pytest.raises(ValueError, match='seed times'):
        s.sample_from_nodes(NodeSamplerInput(node=np.arange(3)))


def test_sampler_library_builds_from_several_processes(tmp_path):
    """Four processes build the library into an empty directory at once:
    each gets the same file, which loads, and no temporary file is left."""
    code = ('import sys, ctypes\n'
            'from pathlib import Path\n'
            'import pytorch_geometric_tpu_torch.csrc as c\n'
            'c.BUILD_DIR = Path(sys.argv[1])\n'
            'p = c.build_sampler()\n'
            'ctypes.CDLL(str(p)).neighbor_sample\n'
            'print(p)\n')
    procs = [subprocess.Popen([sys.executable, '-c', code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        Path(paths.pop()).name]


def test_without_gxx_the_samplers_take_numpy(monkeypatch, tmp_path):
    """No ``g++``: the library is ``None``, ``WITH_NATIVE_SAMPLER`` is
    False, nothing is left in the build directory, and a sampler draws the
    JAX package's numpy batch."""
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError('g++')

    monkeypatch.setattr(csrc, '_sampler', None)
    monkeypatch.setattr(csrc, '_sampler_tried', False)
    monkeypatch.setattr(csrc, 'BUILD_DIR', tmp_path)
    monkeypatch.delattr(csrc, 'WITH_NATIVE_SAMPLER', raising=False)
    monkeypatch.setattr(csrc.subprocess, 'run', no_compiler)
    assert csrc.sampler_library() is None
    assert not csrc.WITH_NATIVE_SAMPLER
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr(jcsrc, 'WITH_NATIVE_SAMPLER', False)
    jdata, data, rng = _graph(6)
    seeds = rng.integers(0, N, 5)
    _outputs_equal(
        NeighborSampler(data, [3, 2]).sample_from_nodes(
            NodeSamplerInput(node=seeds)),
        JNeighborSampler(jdata, [3, 2]).sample_from_nodes(
            JNodeInput(node=seeds)))
