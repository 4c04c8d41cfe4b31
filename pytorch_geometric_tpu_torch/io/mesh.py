"""Mesh readers: OFF, OBJ, PLY (ASCII), and the OFF writer.

Counterpart of ``pytorch_geometric_tpu/io/mesh.py`` (reference
``torch_geometric/io/off.py``, ``obj.py``, ``ply.py``): positions as
float32 ``pos [N, 3]``, every polygon fan-triangulated into ``face [3,
F]`` (int64 on the host, narrowed by ``Data`` as the JAX package's is)."""

import numpy as np

from ..data.data import Data, host


def _faces(faces) -> np.ndarray:
    return (np.array(faces, np.int64).T if faces
            else np.zeros((3, 0), np.int64))


def _fan(poly, faces):
    for i in range(1, len(poly) - 1):
        faces.append([poly[0], poly[i], poly[i + 1]])


def read_off(path: str) -> Data:
    """An OFF file (reference ``io/off.py:read_off``); the counts may share
    the header's line (``OFF4 2 0``)."""
    with open(path) as f:
        src = f.read().split('\n')
    if src[0].strip() == 'OFF':
        src = src[1:]
    else:
        src[0] = src[0][3:]
    counts = src[0].split()
    num_nodes, num_faces = int(counts[0]), int(counts[1])
    pos = np.array([[float(v) for v in line.split()[:3]]
                    for line in src[1:1 + num_nodes]], np.float32)
    faces = []
    for line in src[1 + num_nodes:1 + num_nodes + num_faces]:
        parts = [int(v) for v in line.split()]
        _fan(parts[1:parts[0] + 1], faces)
    return Data(pos=pos, face=_faces(faces), num_nodes=num_nodes)


def write_off(data: Data, path: str):
    """``data.pos`` and ``data.face`` as an OFF file (reference
    ``io/off.py:write_off``); the tensors may lie on any device."""
    pos, face = host(data.pos), host(data.face)
    with open(path, 'w') as f:
        f.write(f'OFF\n{len(pos)} {face.shape[1]} 0\n')
        for p in pos:
            f.write(' '.join(str(float(v)) for v in p) + '\n')
        for c in face.T:
            f.write('3 ' + ' '.join(str(int(v)) for v in c) + '\n')


def read_obj(path: str) -> Data:
    """The ``v`` and ``f`` lines of an OBJ file (reference ``io/obj.py``);
    a face vertex's texture and normal indices are dropped."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == 'v':
                verts.append([float(v) for v in parts[1:4]])
            elif parts[0] == 'f':
                _fan([int(p.split('/')[0]) - 1 for p in parts[1:]], faces)
    return Data(pos=np.array(verts, np.float32), face=_faces(faces),
                num_nodes=len(verts))


def read_ply(path: str) -> Data:
    """An ASCII PLY file (reference ``io/ply.py``): its elements in header
    order, ``vertex`` rows' first three values and ``face`` rows'
    polygons."""
    with open(path, 'rb') as f:
        header = []
        while True:
            line = f.readline().decode('ascii').strip()
            header.append(line)
            if line == 'end_header':
                break
        counts, order = {}, []
        for h in header:
            if h.startswith('element'):
                _, name, cnt = h.split()
                counts[name] = int(cnt)
                order.append(name)
        verts, faces = [], []
        for name in order:
            for _ in range(counts[name]):
                line = f.readline().decode('ascii').split()
                if name == 'vertex':
                    verts.append([float(v) for v in line[:3]])
                elif name == 'face':
                    _fan([int(v) for v in line[1:int(line[0]) + 1]], faces)
    return Data(pos=np.array(verts, np.float32), face=_faces(faces),
                num_nodes=len(verts))
