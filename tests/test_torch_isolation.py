"""The PyTorch port stands alone: importing it loads nothing of JAX, flax or
the JAX package; no file of it (nor ``chip_smoke.py``) imports them; its
entry points run on the CUDA card unless asked for the CPU, and raise
without a card instead of running on the CPU; its host-side loaders run
without a card, on the port's own build of the native sampler (the
heterogeneous loaders too)."""

import ast
import ctypes
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pytorch_geometric_tpu_torch as pkg
from pytorch_geometric_tpu_torch import EdgeIndex
from pytorch_geometric_tpu_torch.nn.conv import (GATConv, GATv2Conv, GCNConv,
                                                 SuperGATConv, TransformerConv)
from pytorch_geometric_tpu_torch.nn.models import GAT, GCN, GIN, GraphSAGE
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import cache_gcn_norm
from pytorch_geometric_tpu_torch.ops import segment_spmm, spmm
from pytorch_geometric_tpu_torch.ops.bsr_spmm import BSR, bsr_matmul
from pytorch_geometric_tpu_torch.ops.gat_fused import gat_mix
from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
from pytorch_geometric_tpu_torch.ops.edge_dot import edge_dot
from pytorch_geometric_tpu_torch.ops.segment_max import segment_max_blocked

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(pkg.__file__).resolve().parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pytorch_geometric_tpu')


def _forbidden(module: str) -> bool:
    top = module.split('.')[0]
    return top in FORBIDDEN


def test_import_loads_no_jax():
    code = (
        'import importlib, pkgutil, sys\n'
        'import pytorch_geometric_tpu_torch as p\n'
        'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        f'{FORBIDDEN!r})\n'
        'print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n'
        'assert not bad, bad\n'
        'assert {"pytorch_geometric_tpu_torch.compat", '
        '"pytorch_geometric_tpu_torch.loader.scan_train", '
        '"pytorch_geometric_tpu_torch.data.batch", '
        '"pytorch_geometric_tpu_torch.sampler.neighbor_sampler", '
        '"pytorch_geometric_tpu_torch.loader.neighbor_loader", '
        '"pytorch_geometric_tpu_torch.loader.prefetch", '
        '"pytorch_geometric_tpu_torch.data.hetero_data", '
        '"pytorch_geometric_tpu_torch.data.hetero_batch", '
        '"pytorch_geometric_tpu_torch.ops.grouped", '
        '"pytorch_geometric_tpu_torch.nn.dense.linear", '
        '"pytorch_geometric_tpu_torch.nn.conv.rgcn_conv", '
        '"pytorch_geometric_tpu_torch.nn.conv.hetero_conv", '
        '"pytorch_geometric_tpu_torch.nn.to_hetero", '
        '"pytorch_geometric_tpu_torch.sampler.hetero", '
        '"pytorch_geometric_tpu_torch.loader.hetero_loader", '
        '"pytorch_geometric_tpu_torch.ops.chunked_spmm", '
        '"pytorch_geometric_tpu_torch.ops.sampled", '
        '"pytorch_geometric_tpu_torch.loader.cluster", '
        '"pytorch_geometric_tpu_torch.loader.graph_saint", '
        '"pytorch_geometric_tpu_torch.loader.ibmb", '
        '"pytorch_geometric_tpu_torch.loader.list_loader", '
        '"pytorch_geometric_tpu_torch.loader.temporal", '
        '"pytorch_geometric_tpu_torch.loader.legacy", '
        '"pytorch_geometric_tpu_torch.data.temporal", '
        '"pytorch_geometric_tpu_torch.nn.conv.graph_conv", '
        '"pytorch_geometric_tpu_torch.nn.models.node2vec", '
        '"pytorch_geometric_tpu_torch.utils.extra", '
        '"pytorch_geometric_tpu_torch.experimental", '
        '"pytorch_geometric_tpu_torch.utils.core", '
        '"pytorch_geometric_tpu_torch.utils.dense", '
        '"pytorch_geometric_tpu_torch.nn.aggr.base", '
        '"pytorch_geometric_tpu_torch.nn.aggr.basic", '
        '"pytorch_geometric_tpu_torch.nn.aggr.multi", '
        '"pytorch_geometric_tpu_torch.nn.aggr.attention", '
        '"pytorch_geometric_tpu_torch.nn.norm.norms", '
        '"pytorch_geometric_tpu_torch.nn.pool.glob", '
        '"pytorch_geometric_tpu_torch.nn.conv.gen_conv", '
        '"pytorch_geometric_tpu_torch.nn.conv.point_conv"} <= set('
        'sys.modules)\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 70   # every module was imported


@pytest.mark.parametrize('path', sorted(
    str(p.relative_to(ROOT)) for p in
    list(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py']))
def test_no_jax_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f'{path}:{node.lineno} imports {bad}'


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_entry_points_need_a_card_by_default(no_card):
    coo = np.array([[0, 1, 2], [1, 2, 0]], np.int32)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        EdgeIndex(coo, (3, 3))
    for conv in (GCNConv, GATConv, GATv2Conv, TransformerConv, SuperGATConv):
        with pytest.raises(RuntimeError, match='no CUDA card'):
            conv(4, 4)
    for cls in (GCN, GraphSAGE, GIN, GAT):
        with pytest.raises(RuntimeError, match='no CUDA card'):
            cls(4, 8, 2, 2)
    # asked for the CPU, they run there
    ei = EdgeIndex(coo, (3, 3), device='cpu').fill_cache()
    out = GCN(4, 8, 2, 2, device='cpu')(torch.ones(3, 4), ei)
    assert out.shape == (3, 2) and out.device.type == 'cpu'
    # a raw COO follows x's device: here the CPU
    assert spmm(torch.from_numpy(coo), torch.ones(3, 2)).device.type == 'cpu'
    # so does a fused GAT over the slot orders
    out = GAT(4, 8, 2, 2, heads=2, device='cpu',
              conv_kwargs={'add_self_loops': False})(torch.ones(3, 4), ei)
    assert out.shape == (3, 2) and ei.blocked.perm.device.type == 'cpu'
    # the block-sparse cache is built on the EdgeIndex's device
    bsr = cache_gcn_norm(ei, block_sparse=True)
    assert bsr.bsr.vals.device.type == 'cpu'
    assert bsr.bsr_t.row_ptr.device.type == 'cpu'


def test_wrapper_never_runs_plain_on_a_cuda_tensor():
    """The wrapper's only plain path is behind a CPU-device check; a
    ``meta`` tensor (neither CPU nor CUDA) is refused, not computed."""
    ip = torch.zeros(3, dtype=torch.int32, device='meta')
    src = torch.zeros(0, dtype=torch.int32, device='meta')
    x = torch.zeros(2, 4, device='meta')
    with pytest.raises(ValueError, match='cpu or cuda'):
        segment_spmm(ip, src, None, x)
    layout = BSR(vals=torch.zeros(0, 128, 128, device='meta'), cols=src,
                 row_ptr=torch.zeros(2, dtype=torch.int32, device='meta'))
    with pytest.raises(ValueError, match='cpu or cuda'):
        bsr_matmul(layout, x, 2)
    p = torch.zeros(0, 2, device='meta')
    with pytest.raises(ValueError, match='cpu or cuda'):
        gat_mix(ip, src, p, None, None)
    with pytest.raises(ValueError, match='cpu or cuda'):
        segment_max_blocked(p, SimpleNamespace(indptr=ip), 2)
    with pytest.raises(ValueError, match='cpu or cuda'):
        edge_dot(x.view(2, 1, 4), x.view(2, 1, 4), src, src)
    # the flash kernels: the wrappers, and the two backward passes, which
    # take no CPU tensor either
    ops = fs.FlashOperands('gat', 1, x[:, :1], x[:, :1], x, None)
    ml = torch.zeros(2, 1, device='meta')
    with pytest.raises(ValueError, match='cpu or cuda'):
        fs.flash_forward(ops, src, src, None, 2, 8)
    with pytest.raises(ValueError, match='cpu or cuda'):
        fs.flash_backward(ops, src, src, None, 2, 8, ml, ml, x, x)
    plan = fs.csr_plan(src, src, None, 2)
    with pytest.raises(ValueError, match='run on cuda'):
        fs.flash_backward_dst(ops, ml, ml, x, x, plan)
    with pytest.raises(ValueError, match='run on cuda'):
        fs.flash_backward_src(ops, x, ml, plan)


def test_regime_arms_never_run_plain_off_the_cpu():
    """The windowed and chunked regimes reach kernel 1's wrapper, whose
    only plain path is behind a CPU-device check: ``meta`` tensors are
    refused, not computed (the windowed arm is kernel 1 over the CSC views
    of the layout's first ``E`` slots); and auto on CPU tensors needs no
    card."""
    from pytorch_geometric_tpu_torch import WindowedCSC
    from pytorch_geometric_tpu_torch.ops.chunked_spmm import chunked_spmm
    from pytorch_geometric_tpu_torch.ops.segment_spmm import segment_spmm
    i32 = dict(dtype=torch.int32, device='meta')
    win = WindowedCSC(src=torch.zeros(1, 4, **i32),
                      dst=torch.zeros(1, 4, **i32),
                      perm=torch.zeros(1, 4, dtype=torch.int64,
                                       device='meta'),
                      inv_pos=torch.zeros(4, dtype=torch.int64,
                                          device='meta'))
    x = torch.zeros(2, 4, device='meta')
    with pytest.raises(ValueError, match='cpu or cuda'):
        segment_spmm(torch.zeros(3, **i32), win.src.view(-1)[:4], None, x)
    with pytest.raises(ValueError, match='cpu or cuda'):
        chunked_spmm(torch.zeros(4, **i32), torch.zeros(4, **i32), None, x,
                     2, 1 << 16)
    coo = np.array([[0, 1, 2], [1, 2, 0]], np.int32)
    ei = EdgeIndex(coo, (3, 3), device='cpu').fill_cache(auto=True)
    assert ei.dense_adj is None and ei.device.type == 'cpu'


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it, chip_smoke.py exits non-zero and
    prints no result."""
    (tmp_path / 'chip_smoke.py').write_text(
        (ROOT / 'chip_smoke.py').read_text())
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_loaders_run_on_the_host_without_a_card(no_card):
    """Sampling and collation are host work: the loaders run with no card
    visible; an upload to the default device (the card) raises."""
    from pytorch_geometric_tpu_torch.data import Data
    from pytorch_geometric_tpu_torch.loader import (CachedLoader,
                                                    NeighborLoader,
                                                    PrefetchLoader)
    coo = np.array([[0, 1, 2, 3], [1, 2, 3, 0]])
    loader = NeighborLoader(Data(x=np.ones((4, 2), np.float32),
                                 edge_index=coo, num_nodes=4), [2],
                            batch_size=2)
    assert [int(b.batch_size) for b in loader] == [2, 2]
    assert len(list(PrefetchLoader(loader, put=False, num_threads=1))) == 2
    for cls in (PrefetchLoader, CachedLoader):
        with pytest.raises(RuntimeError, match='no CUDA card'):
            cls(loader)


def test_native_sampler_is_the_ports_own_build():
    """The sampler library is built from the port's copy of the source into
    the port's build directory (never the JAX package's
    ``csrc.load()``, which writes next to its sources), and bound with
    ``ctypes.CDLL``, which releases the GIL around each call."""
    from pytorch_geometric_tpu_torch import csrc
    lib = csrc.sampler_library()
    assert lib is not None and csrc.WITH_NATIVE_SAMPLER
    assert type(lib) is ctypes.CDLL
    path = csrc.sampler_path()
    assert path.parent == PKG / '_build' and path.is_file()
    assert csrc.SOURCE_DIR == PKG / 'csrc'
    assert (PKG / 'csrc' / csrc.SAMPLER_SOURCE).is_file()


def test_hetero_loaders_run_on_the_host_without_a_card(no_card):
    """The heterogeneous samplers, loaders and collation are host work:
    they run with no card visible, and the batch relations' upload to the
    default device (the card) raises."""
    from pytorch_geometric_tpu_torch.data import HeteroBatch, HeteroData
    from pytorch_geometric_tpu_torch.loader import (DataLoader, HGTLoader,
                                                    HeteroNeighborLoader,
                                                    batch_edge_index_dict)
    data = HeteroData()
    data['p'].x = np.ones((6, 2), np.float32)
    data['a'].x = np.ones((4, 2), np.float32)
    data['a', 'w', 'p'].edge_index = np.array([[0, 1, 2, 3], [1, 2, 3, 0]])
    data['p', 'c', 'p'].edge_index = np.array([[0, 1, 2], [1, 2, 3]])
    for cls in (HeteroNeighborLoader, HGTLoader):
        batches = list(cls(data, [2, 2], ('p', None), batch_size=4))
        assert [int(b['p'].batch_size) for b in batches] == [4, 4]
        assert batches[0]['p'].x.device.type == 'cpu'
    assert isinstance(next(iter(DataLoader([data, data], batch_size=2))),
                      HeteroBatch)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        batch_edge_index_dict(batches[0])
    assert batch_edge_index_dict(batches[0], 'cpu')[
        ('a', 'w', 'p')].device.type == 'cpu'


def test_hetero_sampler_is_the_ports_own_build():
    """The heterogeneous sampler's native path calls
    ``hetero_neighbor_sample`` in the port's own ``CDLL`` build of its copy
    of ``sampler.cpp`` (never the JAX package's library), with its
    argument types bound."""
    from pytorch_geometric_tpu_torch import csrc
    from pytorch_geometric_tpu_torch.sampler import hetero
    lib = csrc.sampler_library()
    assert type(lib) is ctypes.CDLL
    assert csrc.sampler_path().parent == PKG / '_build'
    assert lib.hetero_neighbor_sample.argtypes is not None
    assert 'hetero_neighbor_sample' in (
        PKG / 'csrc' / csrc.SAMPLER_SOURCE).read_text()
    assert hetero.csrc is csrc


def test_subgraph_loaders_run_on_the_host_without_a_card(no_card):
    """Partitioning, cluster batches, random walks, GraphSAINT batches and
    the IBMB, list, temporal and legacy loaders are host work: they run with
    no card visible, on the port's own native builds."""
    from pytorch_geometric_tpu_torch import csrc
    from pytorch_geometric_tpu_torch.data import Data, TemporalData
    from pytorch_geometric_tpu_torch.loader import (
        ClusterData, ClusterLoader, GraphSAINTRandomWalkSampler,
        IBMBBatchLoader, NeighborSampler, TemporalDataLoader)
    assert csrc.partition_library() is not None
    rng = np.random.default_rng(0)
    coo = rng.integers(0, 200, (2, 1200))
    data = Data(x=np.ones((200, 3), np.float32), edge_index=coo,
                y=rng.integers(0, 3, 200), num_nodes=200)
    batches = list(ClusterLoader(ClusterData(data, 8), batch_size=2))
    assert len(batches) == 4 and batches[0].x.device.type == 'cpu'
    saint = GraphSAINTRandomWalkSampler(data, 20, num_steps=2,
                                        sample_coverage=2)
    assert [b.x.device.type for b in saint] == ['cpu', 'cpu']
    assert len(list(IBMBBatchLoader(data, num_partitions=3))) == 3
    assert len(list(NeighborSampler(coo, [2], batch_size=50))) == 4
    ev = TemporalData(rng.integers(0, 9, 10), rng.integers(0, 9, 10),
                      np.arange(10))
    assert len(list(TemporalDataLoader(ev, batch_size=4))) == 3
