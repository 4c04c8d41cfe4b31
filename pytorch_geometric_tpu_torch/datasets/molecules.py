"""Molecular and benchmark-suite datasets: ZINC, AQSOL, MoleculeNet,
GNNBenchmarkDataset, MNISTSuperpixels, LRGBDataset, MalNetTiny.

Counterpart of ``pytorch_geometric_tpu/datasets/molecules.py`` (reference
``torch_geometric/datasets/zinc.py``, ``aqsol.py``, ``molecule_net.py``,
``gnn_benchmark_dataset.py``, ``mnist_superpixels.py``, ``lrgb.py``,
``malnet_tiny.py``), with its parsing: pickled raws through ``pickle``,
``.pt`` payloads through ``torch.load``, the same graphs from the same raw
files. MoleculeNet featurises with rdkit where it is installed and
otherwise with the JAX package's bag of SMILES symbols over a chain graph.
Raw files go under ``root/raw``; nothing is downloaded.
"""

import csv
import os.path as osp
import pickle
from typing import Sequence

import numpy as np

from ..data.data import Data
from ..data.dataset import InMemoryDataset


def from_rdmol(mol) -> Data:
    """An rdkit molecule as a ``Data``: atomic numbers as ``x [N, 1]`` and
    ``z``, the bonds in both directions (the port's copy of JAX
    ``utils/misc.py:476-485``; it needs rdkit's ``mol``)."""
    z = np.asarray([a.GetAtomicNum() for a in mol.GetAtoms()])
    rows, cols = [], []
    for b in mol.GetBonds():
        i, j = b.GetBeginAtomIdx(), b.GetEndAtomIdx()
        rows += [i, j]
        cols += [j, i]
    return Data(x=z[:, None].astype(np.float32), z=z,
                edge_index=np.stack([rows, cols]) if rows
                else np.zeros((2, 0), np.int64))


def _read_pickle(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


class ZINC(InMemoryDataset):
    """ZINC molecular graphs (reference ``zinc.py``): pickled dicts with
    ``atom_type``, the ``bond_type`` adjacency and
    ``logP_SA_cycle_normalized``; ``subset`` keeps the first 1,000."""

    def __init__(self, root: str, subset: bool = False,
                 split: str = 'train', **kwargs):
        self.subset = subset
        self.split = split
        super().__init__(root, **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.split}.pickle']

    @property
    def processed_file_names(self) -> Sequence[str]:
        tag = 'subset' if self.subset else 'full'
        return [f'{self.split}_{tag}.npz']

    def process(self):
        mols = _read_pickle(osp.join(self.raw_dir, self.raw_file_names[0]))
        if self.subset:
            mols = mols[:1000]
        out = []
        for mol in mols:
            adj = np.asarray(mol['bond_type'])
            r, c = np.nonzero(adj)
            out.append(Data(
                x=np.asarray(mol['atom_type']).reshape(-1, 1).astype(
                    np.float32),
                edge_index=np.stack([r, c]).astype(np.int64),
                edge_attr=adj[r, c].astype(np.float32),
                y=np.asarray(mol['logP_SA_cycle_normalized'],
                             np.float32).reshape(-1)))
        self.save(out)


class AQSOL(ZINC):
    """Aqueous solubility (reference ``aqsol.py``): pickled ``(x,
    edge_attr, edge_index, y)`` tuples."""

    def process(self):
        mols = _read_pickle(osp.join(self.raw_dir, self.raw_file_names[0]))
        self.save([Data(x=np.asarray(x, np.float32).reshape(len(x), -1),
                        edge_index=np.asarray(coo, np.int64),
                        edge_attr=np.asarray(ea, np.float32),
                        y=np.asarray([y], np.float32))
                   for x, ea, coo, y in mols])


class MoleculeNet(InMemoryDataset):
    """MoleculeNet csv benchmarks (reference ``molecule_net.py``): one
    graph a SMILES row, its label columns as ``y [1, T]`` (NaN where
    empty), the SMILES' first 64 bytes as ``smiles``. With rdkit the graph
    is :func:`from_rdmol` of the parsed molecule; without, the JAX
    package's fallback (:meth:`_smiles_fallback`)."""

    # (csv name, smiles column, label columns)
    names = {
        'esol': ('delaney-processed.csv', -1, slice(1, 2)),
        'freesolv': ('SAMPL.csv', 1, slice(2, 3)),
        'lipo': ('Lipophilicity.csv', 2, slice(1, 2)),
        'hiv': ('HIV.csv', 0, slice(2, 3)),
        'bace': ('bace.csv', 0, slice(2, 3)),
    }

    def __init__(self, root: str, name: str, **kwargs):
        self.name = name.lower()
        super().__init__(osp.join(root, self.name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [self.names[self.name][0]]

    def process(self):
        fname, smi_col, y_cols = self.names[self.name]
        out = []
        with open(osp.join(self.raw_dir, fname)) as f:
            reader = csv.reader(f)
            next(reader)
            for row in reader:
                smiles = row[smi_col]
                try:
                    from rdkit import Chem
                    d = from_rdmol(Chem.MolFromSmiles(smiles))
                except ImportError:
                    d = self._smiles_fallback(smiles)
                ys = [float(v) if v else float('nan') for v in row[y_cols]]
                d.y = np.asarray([ys], np.float32)
                d.smiles = np.frombuffer(
                    smiles.encode()[:64].ljust(64), np.uint8).copy()
                out.append(d)
        self.save(out)

    @staticmethod
    def _smiles_fallback(smiles: str) -> Data:
        """Without rdkit: a node per letter of the SMILES, one-hot at its
        lower case's code modulo 32 (``x [N, 32]``), over a chain graph in
        both directions."""
        atoms = [c for c in smiles if c.isalpha()]
        n = max(len(atoms), 1)
        x = np.zeros((n, 32), np.float32)
        for i, a in enumerate(atoms[:n]):
            x[i, ord(a.lower()) % 32] = 1
        if n > 1:
            r = np.arange(n - 1)
            coo = np.concatenate(
                [np.stack([r, r + 1]), np.stack([r + 1, r])], 1)
        else:
            coo = np.zeros((2, 0), np.int64)
        return Data(x=x, edge_index=coo.astype(np.int64))


def _load_pt(path):
    import torch
    return torch.load(path, weights_only=False)


class GNNBenchmarkDataset(InMemoryDataset):
    """CLUSTER, PATTERN, MNIST, CIFAR10 (reference
    ``gnn_benchmark_dataset.py``): the ``<name>.pt`` payload's train, val
    and test lists of graphs (dicts or objects with ``x``, ``edge_index``,
    ``edge_attr``, ``y``, ``pos``)."""

    def __init__(self, root: str, name: str, split: str = 'train',
                 **kwargs):
        self.name = name
        self.split = split
        super().__init__(osp.join(root, name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.name}.pt']

    @property
    def processed_file_names(self) -> Sequence[str]:
        return [f'{self.split}.npz']

    def process(self):
        payload = _load_pt(osp.join(self.raw_dir, self.raw_file_names[0]))
        graphs = payload[{'train': 0, 'val': 1, 'test': 2}[self.split]]
        out = []
        for g in graphs:
            kw = {}
            for key in ('x', 'edge_index', 'edge_attr', 'y', 'pos'):
                v = (g.get(key) if isinstance(g, dict)
                     else getattr(g, key, None))
                if v is not None:
                    kw[key] = np.asarray(v)
            out.append(Data(**kw))
        self.save(out)


class MNISTSuperpixels(GNNBenchmarkDataset):
    """MNIST superpixel graphs (reference ``mnist_superpixels.py``): the
    ``MNISTSuperpixels.pt`` payload's train and test lists of dicts. The
    split is set before the dataset base runs ``process`` (the JAX package
    sets it after, and raises ``AttributeError``: ROADMAP Queue 3)."""

    def __init__(self, root: str, train: bool = True, **kwargs):
        self.split = 'train' if train else 'test'
        InMemoryDataset.__init__(self, root, **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['MNISTSuperpixels.pt']

    def process(self):
        payload = _load_pt(osp.join(self.raw_dir, self.raw_file_names[0]))
        graphs = payload[0 if self.split == 'train' else 1]
        self.save([Data(**{k: np.asarray(v) for k, v in
                           (g.items() if isinstance(g, dict) else [])})
                   for g in graphs])


class LRGBDataset(InMemoryDataset):
    """Long-Range Graph Benchmark (reference ``lrgb.py``): a pickled list
    of ``(x, edge_attr, edge_index, y)`` a split."""

    def __init__(self, root: str, name: str, split: str = 'train',
                 **kwargs):
        self.name = name
        self.split = split
        super().__init__(osp.join(root, name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.split}.pickle']

    @property
    def processed_file_names(self) -> Sequence[str]:
        return [f'{self.split}.npz']

    def process(self):
        graphs = _read_pickle(osp.join(self.raw_dir,
                                       self.raw_file_names[0]))
        self.save([Data(x=np.asarray(x, np.float32),
                        edge_index=np.asarray(coo, np.int64),
                        edge_attr=np.asarray(ea, np.float32),
                        y=np.asarray(y))
                   for x, ea, coo, y in graphs])


class MalNetTiny(InMemoryDataset):
    """Function-call graphs (reference ``malnet_tiny.py``): a split file
    of ``path label`` lines, each path an edge list (``#`` comments)."""

    def __init__(self, root: str, split: str = 'train', **kwargs):
        self.split = split
        super().__init__(root, **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.split}.txt']

    @property
    def processed_file_names(self) -> Sequence[str]:
        return [f'{self.split}.npz']

    def process(self):
        with open(osp.join(self.raw_dir, self.raw_file_names[0])) as f:
            entries = [line.strip().split() for line in f if line.strip()]
        out = []
        for path, label in entries:
            coo = np.genfromtxt(osp.join(self.raw_dir, path),
                                dtype=np.int64, comments='#').T
            n = int(coo.max()) + 1 if coo.size else 1
            out.append(Data(edge_index=coo.astype(np.int64),
                            y=np.asarray([int(label)]), num_nodes=n))
        self.save(out)
