"""Readers and writers of graph file formats. Counterpart of
``pytorch_geometric_tpu/io``: meshes (OFF, OBJ, PLY), text arrays, SDF
molecules, the GNN-benchmark npz, the TUDataset text files, Planetoid's
pickles, and the fsspec wrappers ``fs``."""

from .mesh import read_off, write_off, read_obj, read_ply
from .txt import read_txt_array, parse_txt_array
from .sdf import read_sdf, parse_sdf
from .npz import read_npz, parse_npz
from .tu import read_tu_data
from ..datasets.planetoid import read_planetoid_data
from . import fs

__all__ = ['read_off', 'write_off', 'read_obj', 'read_ply',
           'read_txt_array', 'parse_txt_array', 'read_sdf', 'parse_sdf',
           'read_npz', 'parse_npz', 'read_tu_data', 'read_planetoid_data',
           'fs']
