"""SDF molecule parser.

Counterpart of ``pytorch_geometric_tpu/io/sdf.py`` (reference
``torch_geometric/io/sdf.py``): the MDL atom and bond blocks of one
molecule into a ``Data`` with one-hot element features over H, C, N, O, F
(``x``), 3-D positions, and the bonds in both directions, sorted by
``(row, col)`` with duplicates merged, their bond types less one as
``edge_attr``. ``datasets/geometry.py`` keeps the other ``parse_sdf``, the
one ``QM9`` reads with, as the JAX package does."""

import numpy as np

from ..data.data import Data
from .txt import parse_txt_array

elems = {'H': 0, 'C': 1, 'N': 2, 'O': 3, 'F': 4}


def parse_sdf(src: str) -> Data:
    lines = src.split('\n')[3:]
    num_atoms, num_bonds = (int(item) for item in lines[0].split()[:2])

    atom_block = lines[1:num_atoms + 1]
    pos = parse_txt_array(atom_block, end=3)
    z = np.array([elems[item.split()[3]] for item in atom_block], np.int64)
    x = np.eye(len(elems), dtype=np.float32)[z]

    bond_block = lines[1 + num_atoms:1 + num_atoms + num_bonds]
    rc = parse_txt_array(bond_block, end=2, dtype=np.int64) - 1
    row = np.concatenate([rc[:, 0], rc[:, 1]])
    col = np.concatenate([rc[:, 1], rc[:, 0]])
    # the bond types as one column, flattened (JAX sdf.py:33-35)
    attr = parse_txt_array(bond_block, start=2, end=3).reshape(-1) - 1
    attr = np.concatenate([attr, attr], 0)
    # coalesce: sort by (row, col), merge duplicates
    key = row * num_atoms + col
    order = np.argsort(key, kind='stable')
    key, row, col, attr = key[order], row[order], col[order], attr[order]
    keep = np.ones(len(key), bool)
    keep[1:] = key[1:] != key[:-1]
    edge_index = np.stack([row[keep], col[keep]]).astype(np.int64)
    return Data(x=x, edge_index=edge_index,
                edge_attr=attr[keep].astype(np.float32), pos=pos,
                num_nodes=num_atoms)


def read_sdf(path: str) -> Data:
    with open(path) as f:
        return parse_sdf(f.read())
