"""Mesh, point-cloud, molecular and temporal datasets: ModelNet, FAUST,
MD17, QM9, MovieLens, JODIEDataset.

Counterpart of ``pytorch_geometric_tpu/datasets/geometry.py`` (reference
``torch_geometric/datasets/modelnet.py``, ``faust.py``, ``md17.py``,
``qm9.py``, ``movie_lens.py``, ``jodie.py``), with its numpy parsing: the
same raw files give the JAX package's graphs bit for bit. Raw files go
under ``root/raw`` (the layout of the reference's extracted downloads);
nothing is downloaded. QM9 is parsed without rdkit, by this module's
:func:`parse_sdf` (``io/sdf.py`` keeps the other one, as the JAX package
does).
"""

import csv
import glob
import os.path as osp
from typing import Optional, Sequence

import numpy as np

from ..data.data import Data
from ..data.dataset import InMemoryDataset
from ..data.hetero_data import HeteroData
from ..data.temporal import TemporalData


class ModelNet(InMemoryDataset):
    """ModelNet10/40 OFF meshes (reference ``datasets/modelnet.py``): one
    folder a category under ``raw/``, its meshes under ``train/`` and
    ``test/``; the label is the category's place in sorted order."""

    def __init__(self, root: str, name: str = '10', train: bool = True,
                 **kwargs):
        self.name = name
        self.split = 'train' if train else 'test'
        super().__init__(osp.join(root, f'modelnet{name}_{self.split}'),
                         **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['']  # the category folders are checked in process()

    def _maybe_download(self):
        pass

    def process(self):
        from ..io import read_off
        categories = sorted(
            osp.basename(p) for p in glob.glob(osp.join(self.raw_dir, '*'))
            if osp.isdir(p))
        if not categories:
            raise RuntimeError(
                f'ModelNet: no category folders of OFF meshes under '
                f'{self.raw_dir}, and this package downloads nothing')
        data_list = []
        for label, cat in enumerate(categories):
            for path in sorted(glob.glob(
                    osp.join(self.raw_dir, cat, self.split, '*.off'))):
                data_list.append(read_off(path).replace(
                    y=np.array([label])))
        self.save(data_list)


class FAUST(InMemoryDataset):
    """FAUST scans (reference ``datasets/faust.py``): the PLY registrations
    under ``raw/MPI-FAUST/training/registrations``, the first 80 for
    training; the label is the pose, ``i % 10``."""

    def __init__(self, root: str, train: bool = True, **kwargs):
        self.train = train
        super().__init__(root, **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['MPI-FAUST']

    def process(self):
        from ..io import read_ply
        paths = sorted(glob.glob(osp.join(
            self.raw_dir, 'MPI-FAUST', 'training', 'registrations',
            '*.ply')))
        data_list = [read_ply(p).replace(y=np.array([i % 10]))
                     for i, p in enumerate(paths)]
        self.save(data_list[:80] if self.train else data_list[80:])


class MD17(InMemoryDataset):
    """MD17 molecular dynamics (reference ``datasets/md17.py``): the npz
    arrays ``z``, ``R``, ``E``, ``F``, one graph a frame (the first 10,000),
    with ``energy`` and ``force`` and ``y`` the energy."""

    def __init__(self, root: str, name: str, **kwargs):
        self.name = name
        super().__init__(osp.join(root, name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.name}.npz']

    def process(self):
        with np.load(osp.join(self.raw_dir, self.raw_file_names[0]),
                     allow_pickle=True) as f:
            z = f['z'].astype(np.int32)
            pos = f['R'].astype(np.float32)
            energy = f['E'].astype(np.float32).reshape(-1)
            force = f['F'].astype(np.float32)
        self.save([
            Data(z=z, pos=pos[i], y=np.array([energy[i]]),
                 energy=np.array(energy[i], np.float32),
                 force=force[i], num_nodes=len(z))
            for i in range(min(len(pos), 10000))])


# the elements of QM9 and the bond types of its SDF (single, double,
# triple, aromatic)
_SYMBOLS = {'H': 1, 'C': 6, 'N': 7, 'O': 8, 'F': 9}
_BOND_TYPES = {'1': 0, '2': 1, '3': 2, '4': 3}


def parse_sdf(src: str) -> Data:
    """One SDF molecule block (JAX ``geometry.py:115``): atomic numbers
    ``z`` (0 for an element outside H, C, N, O, F), positions, the bonds in
    both directions in file order and their types one-hot as ``edge_attr
    [E, 4]``."""
    lines = src.split('\n')
    counts = lines[3].split()
    num_atoms, num_bonds = int(counts[0]), int(counts[1])
    pos, z = [], []
    for line in lines[4:4 + num_atoms]:
        parts = line.split()
        pos.append([float(v) for v in parts[:3]])
        z.append(_SYMBOLS.get(parts[3], 0))
    rows, cols, types = [], [], []
    for line in lines[4 + num_atoms:4 + num_atoms + num_bonds]:
        parts = line.split()
        a, b = int(parts[0]) - 1, int(parts[1]) - 1
        t = _BOND_TYPES.get(parts[2], 0)
        rows += [a, b]
        cols += [b, a]
        types += [t, t]
    edge_index = (np.stack([rows, cols]).astype(np.int32)
                  if rows else np.zeros((2, 0), np.int32))
    edge_attr = (np.eye(4, dtype=np.float32)[types] if types
                 else np.zeros((0, 4), np.float32))
    return Data(z=np.array(z, np.int32), pos=np.array(pos, np.float32),
                edge_index=edge_index, edge_attr=edge_attr,
                num_nodes=num_atoms)


class QM9(InMemoryDataset):
    """QM9 molecules (reference ``datasets/qm9.py``): ``gdb9.sdf``'s blocks
    (separated by ``$$$$``) parsed without rdkit, and ``y [1, T]`` the
    columns after the first of ``gdb9.sdf.csv``'s row of the same place."""

    def __init__(self, root: str, **kwargs):
        super().__init__(root, **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['gdb9.sdf', 'gdb9.sdf.csv']

    def process(self):
        with open(osp.join(self.raw_dir, 'gdb9.sdf')) as f:
            blocks = f.read().split('$$$$\n')
        targets = []
        with open(osp.join(self.raw_dir, 'gdb9.sdf.csv')) as f:
            reader = csv.reader(f)
            next(reader)
            for row in reader:
                targets.append([float(v) for v in row[1:]])
        data_list = []
        for i, block in enumerate(blocks):
            if not block.strip() or i >= len(targets):
                continue
            data_list.append(parse_sdf(block).replace(
                y=np.array(targets[i], np.float32)[None]))
        self.save(data_list)


class MovieLens(InMemoryDataset):
    """MovieLens-100k style ratings (reference ``datasets/movie_lens.py``):
    one ``HeteroData`` whose users rate movies, identity features, the
    ratings as ``edge_label``; ``ratings.csv`` is parsed to
    ``processed/hetero.npz``."""

    def __init__(self, root: str, **kwargs):
        self._hetero: Optional[HeteroData] = None
        super().__init__(root, **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return ['ratings.csv']

    @property
    def processed_file_names(self) -> Sequence[str]:
        return ['hetero.npz']

    def process(self):
        users, movies = {}, {}
        src, dst, rating = [], [], []
        with open(osp.join(self.raw_dir, 'ratings.csv')) as f:
            reader = csv.reader(f)
            next(reader)
            for row in reader:
                u, m, r = row[0], row[1], float(row[2])
                users.setdefault(u, len(users))
                movies.setdefault(m, len(movies))
                src.append(users[u])
                dst.append(movies[m])
                rating.append(r)
        np.savez(osp.join(self.processed_dir, 'hetero.npz'),
                 src=np.array(src, np.int64), dst=np.array(dst, np.int64),
                 rating=np.array(rating, np.float32),
                 num_users=len(users), num_movies=len(movies))

    def _load_hetero(self) -> HeteroData:
        if self._hetero is None:
            z = np.load(osp.join(self.processed_dir, 'hetero.npz'))
            data = HeteroData()
            data['user'].num_nodes_hint = int(z['num_users'])
            data['user'].x = np.eye(int(z['num_users']), dtype=np.float32)
            data['movie'].x = np.eye(int(z['num_movies']), dtype=np.float32)
            rel = data['user', 'rates', 'movie']
            rel.edge_index = np.stack([z['src'], z['dst']]).astype(np.int32)
            rel.edge_label = z['rating']
            self._hetero = data
        return self._hetero

    def len(self):
        return 1

    def get(self, idx):
        return self._load_hetero()


class JODIEDataset(InMemoryDataset):
    """JODIE temporal interactions (reference ``datasets/jodie.py``): the
    csv rows ``user, item, timestamp, state_label, features...`` as one
    ``TemporalData``, items numbered after the users, timestamps and labels
    truncated to integers; parsed to ``processed/events.npz``."""

    def __init__(self, root: str, name: str, **kwargs):
        self.name = name
        self._events = None
        super().__init__(osp.join(root, name), **kwargs)

    @property
    def raw_file_names(self) -> Sequence[str]:
        return [f'{self.name}.csv']

    @property
    def processed_file_names(self) -> Sequence[str]:
        return ['events.npz']

    def process(self):
        src, dst, t, msgs, y = [], [], [], [], []
        with open(osp.join(self.raw_dir, self.raw_file_names[0])) as f:
            reader = csv.reader(f)
            next(reader)
            for row in reader:
                src.append(int(row[0]))
                dst.append(int(row[1]))
                t.append(float(row[2]))
                y.append(float(row[3]))
                msgs.append([float(v) for v in row[4:]])
        src = np.array(src, np.int64)
        dst = np.array(dst, np.int64) + (src.max() + 1)
        np.savez(osp.join(self.processed_dir, 'events.npz'),
                 src=src, dst=dst,
                 t=np.array(t, np.float64).astype(np.int64),
                 y=np.array(y, np.float64).astype(np.int64),
                 msg=np.array(msgs, np.float32))

    def _load(self):
        if self._events is None:
            z = np.load(osp.join(self.processed_dir, 'events.npz'))
            self._events = TemporalData(z['src'], z['dst'], z['t'],
                                        z['msg'], z['y'])
        return self._events

    def len(self):
        return 1

    def get(self, idx):
        return self._load()
