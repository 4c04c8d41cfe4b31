"""The port's package namespaces against the JAX package's: every name in
the ``__all__`` of the JAX package's root, ``nn``, ``utils``, ``ops``,
``nn.pool``, ``nn.aggr``, ``nn.dense``, ``nn.models``, ``data``,
``datasets`` and ``io`` that the port has ported (its defining module has a
counterpart in the port that defines the name) resolves on the port's
package of the same path, in a fresh interpreter that imports only that
package (the root's names after ``import pytorch_geometric_tpu_torch``
alone, its subpackages included); and that import loads no ``triton`` and
starts no CUDA context."""

import importlib
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ('', '.nn', '.utils', '.ops', '.nn.pool', '.nn.aggr', '.nn.dense',
            '.nn.models', '.data', '.datasets', '.io')


def _port_module(module: str):
    """The port's counterpart of the JAX module ``module``, or None."""
    name = module.replace('pytorch_geometric_tpu',
                          'pytorch_geometric_tpu_torch', 1)
    try:
        if importlib.util.find_spec(name) is None:
            return None
    except ModuleNotFoundError:
        return None
    return importlib.import_module(name)


def _expected(pkg: str):
    """The JAX ``__all__`` names of ``pkg`` that the port has ported: a
    subpackage the port has, or an object whose defining module has a
    counterpart in the port defining it (under its own name)."""
    jm = importlib.import_module('pytorch_geometric_tpu' + pkg)
    names = []
    for name in jm.__all__:
        obj = getattr(jm, name, None)
        if inspect.ismodule(obj):
            if _port_module(obj.__name__) is not None:
                names.append(name)
            continue
        where = getattr(obj, '__module__', None)
        if not (isinstance(where, str)
                and where.startswith('pytorch_geometric_tpu')):
            continue
        port = _port_module(where)
        if port is not None and hasattr(port, getattr(obj, '__name__',
                                                      name)):
            names.append(name)
    return names


@pytest.fixture(scope='module')
def resolved():
    """What a fresh interpreter finds: for each package, the expected names
    that do not resolve; and whether the root import loaded triton or
    started CUDA."""
    expected = {pkg: _expected(pkg) for pkg in PACKAGES}
    code = (
        'import importlib, json, sys\n'
        'import torch\n'
        'import pytorch_geometric_tpu_torch as p\n'
        'out = {"triton": "triton" in sys.modules,\n'
        '       "cuda": torch.cuda.is_initialized(), "missing": {}}\n'
        f'expected = {expected!r}\n'
        'for pkg, names in expected.items():\n'
        '    try:\n'
        '        m = importlib.import_module(p.__name__ + pkg)\n'
        '    except ImportError:\n'
        '        m = None\n'
        '    out["missing"][pkg] = [n for n in names if not hasattr(m, n)]\n'
        'print(json.dumps(out))\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return expected, json.loads(res.stdout.splitlines()[-1])


@pytest.mark.parametrize('pkg', PACKAGES)
def test_jax_names_resolve_on_the_port(resolved, pkg):
    expected, out = resolved
    assert expected[pkg], pkg
    assert out['missing'][pkg] == [], (pkg, out['missing'][pkg])


def test_data_and_datasets_hold_the_datasets_slice(resolved):
    """The scan expects the ``data`` and ``datasets`` names of the
    datasets slice (their modules have counterparts), and they resolve."""
    expected, out = resolved
    assert {'HypergraphData', 'Summary', 'Stats', 'summary', 'Database',
            'SQLiteDatabase', 'RocksDatabase', 'OnDiskDataset', 'TensorInfo',
            'download_url', 'download_google_url', 'extract_tar',
            'extract_zip', 'extract_bz2', 'extract_gz', 'FeatureStore',
            'GraphStore', 'InMemoryFeatureStore', 'InMemoryGraphStore',
            'TensorAttr', 'EdgeAttr', 'EdgeLayout'} <= set(expected['.data'])
    assert {'Planetoid', 'Amazon', 'Coauthor', 'WebKB', 'WikipediaNetwork',
            'Actor', 'read_npz', 'Reddit', 'Reddit2', 'Flickr', 'Yelp',
            'AmazonProducts', 'NELL', 'CitationFull', 'CoraFull',
            'DeezerEurope', 'LastFMAsia', 'FacebookPagePage', 'GitHub',
            'Twitch', 'GemsecDeezer', 'Airports', 'PolBlogs', 'EmailEUCore',
            'WikiCS', 'PPI', 'HeterophilousGraphDataset', 'LINKXDataset',
            'BitcoinOTC', 'EllipticBitcoinDataset', 'AttributedGraphDataset',
            'SNAPDataset', 'KarateClub', 'StochasticBlockModelDataset',
            'ExplainerDataset', 'FakeHeteroDataset', 'ba_graph', 'BAShapes',
            'BA2MotifDataset', 'BAMultiShapesDataset', 'InfectionDataset',
            'MixHopSyntheticDataset', 'RandomPartitionGraphDataset'} <= set(
                expected['.datasets'])
    assert out['missing']['.data'] == out['missing']['.datasets'] == []


def test_root_namespace_holds_the_containers_and_subpackages(resolved):
    """The names the root must give, whatever the scan finds."""
    expected, _ = resolved
    assert {'Data', 'Batch', 'HeteroData', 'Dataset', 'InMemoryDataset',
            'compile', 'is_compiling', 'debug', 'is_debug_enabled', 'nn',
            'ops', 'utils', 'loader', 'sampler', 'experimental',
            'datasets'} <= set(expected[''])


def test_root_import_loads_no_triton_and_no_cuda(resolved):
    _, out = resolved
    assert not out['triton'] and not out['cuda'], out
