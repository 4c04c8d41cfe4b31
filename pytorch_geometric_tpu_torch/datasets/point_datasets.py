"""Point-cloud and mesh datasets: the mesh folders (GeometricShapes,
SHREC2016, MedShapeNet, Teeth3DS, CoMA), TOSCA, PCPNetDataset, ShapeNet,
S3DIS, DynamicFAUST, PascalPF, WILLOWObjectClass.

Counterpart of ``pytorch_geometric_tpu/datasets/point_datasets.py``
(reference ``torch_geometric/datasets/geometric_shapes.py``,
``shrec2016.py``, ``med_shape_net.py``, ``teeth3ds.py``, ``coma.py``,
``tosca.py``, ``pcpnet_dataset.py``, ``shapenet.py``, ``s3dis.py``,
``dynamic_faust.py``, ``pascal_pf.py``, ``willow.py``): each scans the raw
files under ``root/raw`` (one example a file) and parses them as the JAX
package does, most of them when an example is asked for. ``.mat`` files
are read with ``scipy.io.loadmat`` and HDF5 needs ``h5py``, both imported
when a dataset is built. Nothing is downloaded.
"""

import os
import os.path as osp
from typing import Sequence

import numpy as np

from ..data.data import Data
from ..data.dataset import Dataset
from ..io.mesh import read_obj, read_off, read_ply


class _MeshFolder(Dataset):
    """Every file under ``raw/`` with one of ``extensions`` is an example,
    read by ``reader`` when asked for, labelled by its folder's place
    among the sorted folder names."""

    extensions = ('.off',)
    reader = staticmethod(read_off)

    def __init__(self, root: str, transform=None, pre_transform=None):
        self.root = root
        self.transform = transform
        self.pre_transform = pre_transform
        self.pre_filter = None
        os.makedirs(self.raw_dir, exist_ok=True)
        self.paths, labels = [], []
        for dirpath, _, files in sorted(os.walk(self.raw_dir)):
            for f in sorted(files):
                if f.lower().endswith(self.extensions):
                    self.paths.append(osp.join(dirpath, f))
                    labels.append(osp.basename(dirpath))
        if not self.paths:
            raise RuntimeError(
                f'{type(self).__name__}: no mesh files under {self.raw_dir}, '
                f'and this package downloads nothing')
        self.class_to_idx = {c: i for i, c in enumerate(sorted(set(labels)))}
        self.labels = [self.class_to_idx[label] for label in labels]

    @property
    def raw_dir(self):
        return osp.join(self.root, 'raw')

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        d = self.reader(self.paths[idx])
        d.y = np.asarray([self.labels[idx]])
        if self.pre_transform is not None:
            d = self.pre_transform(d)
        if self.transform is not None:
            d = self.transform(d)
        return d


class GeometricShapes(_MeshFolder):
    """40 2-D and 3-D shape categories (reference ``geometric_shapes.py``)."""


class SHREC2016(_MeshFolder):
    """Partial mesh retrieval (reference ``shrec2016.py``)."""


class MedShapeNet(_MeshFolder):
    """Medical shape meshes (reference ``med_shape_net.py``)."""


class Teeth3DS(_MeshFolder):
    """Intraoral scans (reference ``teeth3ds.py``)."""
    extensions = ('.obj',)
    reader = staticmethod(read_obj)


class CoMA(_MeshFolder):
    """Facial expression meshes (reference ``coma.py``)."""
    extensions = ('.ply',)
    reader = staticmethod(read_ply)


def _mat_matrix(path: str, loadmat, dtype):
    """The first 2-D array among a ``.mat`` file's values."""
    return np.asarray(next(v for v in loadmat(path).values()
                           if isinstance(v, np.ndarray) and v.ndim == 2),
                      dtype)


class TOSCA(Dataset):
    """Non-rigid shapes (reference ``tosca.py``): ``<name>.vert.mat`` and
    ``<name>.tri.mat`` a figure (1-based triangles), the figures whose
    names start with one of ``categories``, read when the dataset is
    built."""

    def __init__(self, root: str, categories: Sequence[str] = ('cat',),
                 transform=None, pre_transform=None):
        from scipy.io import loadmat
        self.root = root
        self.transform = transform
        self.pre_filter = None
        self.graphs = []
        raw = osp.join(root, 'raw')
        names = sorted(f[:-9] for f in os.listdir(raw)
                       if f.endswith('.vert.mat')) if osp.isdir(raw) else []
        if not names:
            raise RuntimeError(f'TOSCA: no .vert.mat files under {raw}')
        for name in names:
            if not any(name.startswith(c) for c in categories):
                continue
            pos = _mat_matrix(osp.join(raw, f'{name}.vert.mat'), loadmat,
                              np.float32)
            tri = _mat_matrix(osp.join(raw, f'{name}.tri.mat'), loadmat,
                              np.int64) - 1
            d = Data(pos=pos, face=tri.T, num_nodes=pos.shape[0])
            if pre_transform is not None:
                d = pre_transform(d)
            self.graphs.append(d)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, idx):
        d = self.graphs[idx]
        return d if self.transform is None else self.transform(d)


class PCPNetDataset(Dataset):
    """Point clouds with normals (reference ``pcpnet_dataset.py``): the
    names in ``raw/list/<split>.txt``, each ``<name>.xyz`` and, where
    there is one, ``<name>.normals`` as ``norm``."""

    def __init__(self, root: str, category: str = 'Noisy',
                 split: str = 'train', transform=None, **kw):
        self.root = root
        self.transform = transform
        raw = osp.join(root, 'raw')
        listfile = osp.join(raw, f'list/{split}.txt')
        if not osp.exists(listfile):
            raise RuntimeError(f'PCPNet: missing split list {listfile}')
        with open(listfile) as f:
            self.names = [line.strip() for line in f if line.strip()]
        self.raw = raw

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx):
        name = self.names[idx]
        pos = np.loadtxt(osp.join(self.raw, f'{name}.xyz'), dtype=np.float32)
        d = Data(pos=pos, num_nodes=pos.shape[0])
        npath = osp.join(self.raw, f'{name}.normals')
        if osp.exists(npath):
            d.norm = np.loadtxt(npath, dtype=np.float32)
        return d if self.transform is None else self.transform(d)


class ShapeNet(Dataset):
    """ShapeNet part segmentation (reference ``shapenet.py``): text clouds
    ``x y z nx ny nz part`` under one folder a category (``categories``
    keeps some); ``category`` is the folder's place in sorted order."""

    def __init__(self, root: str, categories=None, transform=None, **kw):
        self.root = root
        self.transform = transform
        raw = osp.join(root, 'raw')
        self.files, self.cats = [], []
        if osp.isdir(raw):
            for cat in sorted(os.listdir(raw)):
                cdir = osp.join(raw, cat)
                if not osp.isdir(cdir) or (categories
                                           and cat not in categories):
                    continue
                for f in sorted(os.listdir(cdir)):
                    if f.endswith('.txt'):
                        self.files.append(osp.join(cdir, f))
                        self.cats.append(cat)
        if not self.files:
            raise RuntimeError(f'ShapeNet: no category txts under {raw}')
        self.class_to_idx = {c: i for i, c in
                             enumerate(sorted(set(self.cats)))}

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        arr = np.loadtxt(self.files[idx], dtype=np.float32)
        d = Data(pos=arr[:, :3], num_nodes=arr.shape[0])
        if arr.shape[1] >= 6:
            d.norm = arr[:, 3:6]
        if arr.shape[1] >= 7:
            d.y = arr[:, 6].astype(np.int32)
        d.category = np.asarray([self.class_to_idx[self.cats[idx]]])
        return d if self.transform is None else self.transform(d)


class S3DIS(Dataset):
    """Indoor scene segmentation (reference ``s3dis.py``): room ``.npy``
    blocks ``x y z r g b label``; the rooms of ``Area_<test_area>`` are the
    test split."""

    def __init__(self, root: str, test_area: int = 6, train: bool = True,
                 transform=None, **kw):
        self.root = root
        self.transform = transform
        raw = osp.join(root, 'raw')
        self.files = []
        if osp.isdir(raw):
            for f in sorted(os.listdir(raw)):
                if f.endswith('.npy') and train != (f'Area_{test_area}'
                                                    in f):
                    self.files.append(osp.join(raw, f))
        if not self.files:
            raise RuntimeError(f'S3DIS: no room npys under {raw}')

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        arr = np.load(self.files[idx]).astype(np.float32)
        d = Data(pos=arr[:, :3], x=arr[:, 3:6] / 255.0,
                 y=arr[:, 6].astype(np.int32), num_nodes=arr.shape[0])
        return d if self.transform is None else self.transform(d)


class DynamicFAUST(Dataset):
    """4-D human scans (reference ``dynamic_faust.py``): needs ``h5py``
    (``ImportError`` without it), and raises for the registrations it
    cannot read, as the JAX package does."""

    def __init__(self, root: str, **kw):
        try:
            import h5py  # noqa: F401
        except ImportError as e:
            raise ImportError('DynamicFAUST requires h5py') from e
        raise RuntimeError('DynamicFAUST: place registrations_*.hdf5 '
                           f'under {osp.join(root, "raw")}')


def _keypoint_graphs(raw: str, key: str, transpose: bool):
    """A ``Data`` of keypoint positions a ``.mat`` file under ``raw``."""
    from scipy.io import loadmat
    graphs = []
    for f in sorted(os.listdir(raw)):
        if not f.endswith('.mat'):
            continue
        pts = loadmat(osp.join(raw, f))[key].astype(np.float32)
        if transpose:
            pts = pts.T
        else:
            pts = pts[~np.isnan(pts).any(-1)]
        graphs.append(Data(pos=pts, num_nodes=pts.shape[0]))
    return graphs


class PascalPF(Dataset):
    """Pascal-PF keypoints (reference ``pascal_pf.py``): ``kps`` of each
    ``.mat`` under ``raw/Annotations/<category>``, rows with a NaN
    dropped."""

    def __init__(self, root: str, category: str, transform=None, **kw):
        self.transform = transform
        raw = osp.join(root, 'raw', 'Annotations', category)
        if not osp.isdir(raw):
            raise RuntimeError(f'PascalPF: missing {raw}')
        self.graphs = _keypoint_graphs(raw, 'kps', False)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, idx):
        d = self.graphs[idx]
        return d if self.transform is None else self.transform(d)


class WILLOWObjectClass(PascalPF):
    """WILLOW keypoints (reference ``willow.py``): ``pts_coord`` of each
    ``.mat`` under ``raw/<category>``, transposed."""

    def __init__(self, root: str, category: str, transform=None, **kw):
        self.transform = transform
        raw = osp.join(root, 'raw', category)
        if not osp.isdir(raw):
            raise RuntimeError(f'WILLOW: missing {raw}')
        self.graphs = _keypoint_graphs(raw, 'pts_coord', True)
