"""The port's ``io`` package against the JAX package's, on the CPU.

Each reader parses files written here at small shapes to the same arrays
and graphs as the JAX package's reader of the same bytes, bit for bit,
dtypes included: text arrays (separator, column range, dtype, blank
lines), an SDF molecule with a repeated bond (merged), OFF meshes (the
counts on their own line and on the header's, quads fan-triangulated),
OBJ faces with texture and normal indices, ASCII PLY, the GNN-benchmark
npz (``read_npz`` and ``parse_npz`` both ways), and the TUDataset text
files with and without the optional ones. ``write_off`` is read back by
both packages. The fsspec wrappers run on a local directory and on
``memory://``: listing, copying (and extracting a ``.tar.gz``), moving,
globbing, removing; ``save`` / ``load`` pickle as the JAX package's do
(either reads the other's file); ``torch_save`` / ``torch_load`` go
through ``torch.save`` / ``torch.load``."""

import io as stdio
import tarfile

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pytorch_geometric_tpu import io as jio
from pytorch_geometric_tpu_torch import io as tio
from pytorch_geometric_tpu_torch.datasets import planetoid as tplanetoid


def _same_data(got, want, what=''):
    assert got.num_nodes == want.num_nodes, what
    assert sorted(got.keys()) == sorted(want.keys()), what
    for k in want.keys():
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f'{what} {k}')


# -- text -------------------------------------------------------------------
@pytest.mark.parametrize('sep,start,end,dtype', [
    (None, 0, None, np.float32), (',', 1, 3, np.float64),
    (None, 2, None, np.int64)])
def test_txt_arrays_match_jax(tmp_path, sep, start, end, dtype):
    rng = np.random.default_rng(1)
    rows = rng.integers(-50, 50, (6, 4)) / 4
    join = ' ' if sep is None else sep
    lines = [join.join(str(v) for v in r) for r in rows]
    path = tmp_path / 'a.txt'
    path.write_text('\n'.join(lines[:3]) + '\n\n  \n' + '\n'.join(lines[3:])
                    + '\n')
    for fn, args in (('parse_txt_array', (lines,)),
                     ('read_txt_array', (str(path),))):
        got = getattr(tio, fn)(*args, sep=sep, start=start, end=end,
                               dtype=dtype)
        want = getattr(jio, fn)(*args, sep=sep, start=start, end=end,
                                dtype=dtype)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# -- SDF ----------------------------------------------------------------------
SDF = """water dimer, a bond repeated
  synthetic

  5  5  0  0  0  0  0  0  0  0999 V2000
    0.0000    0.0000    0.0000 O   0  0  0  0  0
    0.9600    0.0000    0.0000 H   0  0  0  0  0
   -0.2400    0.9300    0.0000 H   0  0  0  0  0
    2.9000    0.1000    0.2000 N   0  0  0  0  0
    3.4000    1.0000   -0.1000 C   0  0  0  0  0
  1  2  1  0
  1  3  1  0
  4  5  2  0
  2  1  1  0
  5  1  4  0
M  END
"""


def test_sdf_matches_jax(tmp_path):
    _same_data(tio.parse_sdf(SDF), jio.parse_sdf(SDF), 'parse_sdf')
    path = tmp_path / 'm.sdf'
    path.write_text(SDF)
    got = tio.read_sdf(str(path))
    _same_data(got, jio.read_sdf(str(path)), 'read_sdf')
    # the repeated bond 1-2 merged: 4 bonds in both directions
    assert got.edge_index.shape == (2, 8)


# -- meshes -------------------------------------------------------------------
def _mesh_text(rng, header_counts):
    pos = rng.standard_normal((7, 3)).round(4)
    faces = [[0, 1, 2], [2, 3, 4, 5], [4, 5, 6], [0, 2, 4, 6, 1]]
    head = 'OFF7 4 0\n' if header_counts else 'OFF\n7 4 0\n'
    return pos, faces, head + ''.join(
        ' '.join(str(v) for v in p) + '\n' for p in pos) + ''.join(
        f'{len(f)} ' + ' '.join(map(str, f)) + '\n' for f in faces)


@pytest.mark.parametrize('header_counts', [False, True])
def test_read_off_matches_jax(tmp_path, header_counts):
    _, _, text = _mesh_text(np.random.default_rng(2), header_counts)
    path = tmp_path / 'm.off'
    path.write_text(text)
    got = tio.read_off(str(path))
    _same_data(got, jio.read_off(str(path)))
    # a triangle, a quad (2), a triangle, a pentagon (3)
    assert got.face.shape == (3, 7)


def test_write_off_reads_back_on_both(tmp_path):
    d = tio.read_off(str(_write(tmp_path / 'in.off', _mesh_text(
        np.random.default_rng(3), False)[2])))
    tio.write_off(d, str(tmp_path / 'out.off'))
    jio.write_off(jio.read_off(str(tmp_path / 'in.off')),
                  str(tmp_path / 'jax.off'))
    assert (tmp_path / 'out.off').read_text() == (
        tmp_path / 'jax.off').read_text()
    _same_data(tio.read_off(str(tmp_path / 'out.off')),
               jio.read_off(str(tmp_path / 'out.off')))


def _write(path, text):
    path.write_text(text)
    return path


def test_read_obj_matches_jax(tmp_path):
    pos, faces, _ = _mesh_text(np.random.default_rng(4), False)
    text = '# a mesh\no thing\n' + ''.join(
        'v ' + ' '.join(str(v) for v in p) + '\n' for p in pos) + \
        'vn 0 0 1\n\n' + ''.join(
        'f ' + ' '.join(f'{i + 1}/{i + 1}/1' if k % 2 else str(i + 1)
                        for k, i in enumerate(f)) + '\n' for f in faces)
    path = _write(tmp_path / 'm.obj', text)
    _same_data(tio.read_obj(str(path)), jio.read_obj(str(path)))


def test_read_ply_matches_jax(tmp_path):
    pos, faces, _ = _mesh_text(np.random.default_rng(5), False)
    text = ('ply\nformat ascii 1.0\ncomment made here\n'
            f'element vertex {len(pos)}\nproperty float x\n'
            'property float y\nproperty float z\nproperty float nx\n'
            f'element face {len(faces)}\n'
            'property list uchar int vertex_indices\nend_header\n'
            + ''.join(' '.join(str(v) for v in p) + ' 0.5\n' for p in pos)
            + ''.join(f'{len(f)} ' + ' '.join(map(str, f)) + '\n'
                      for f in faces))
    path = _write(tmp_path / 'm.ply', text)
    _same_data(tio.read_ply(str(path)), jio.read_ply(str(path)))


# -- npz ----------------------------------------------------------------------
def _npz(path, rng, n=20, f=6, e=70):
    coo = rng.integers(0, n, (2, e))
    coo[:, :3] = [[2, 5, 5], [2, 6, 6]]            # a loop and a duplicate
    adj = sp.csr_matrix((np.ones(e, np.float32), (coo[0], coo[1])), (n, n))
    x = sp.csr_matrix(rng.random((n, f)) * (rng.random((n, f)) < 0.4))
    np.savez(path, adj_data=adj.data, adj_indices=adj.indices,
             adj_indptr=adj.indptr, adj_shape=adj.shape, attr_data=x.data,
             attr_indices=x.indices, attr_indptr=x.indptr,
             attr_shape=x.shape, labels=rng.integers(0, 3, n))
    return path


@pytest.mark.parametrize('to_undirected', [True, False])
def test_npz_matches_jax(tmp_path, to_undirected):
    path = _npz(tmp_path / 'g.npz', np.random.default_rng(6))
    with np.load(path) as f:
        got = tio.parse_npz(f, to_undirected=to_undirected)
        want = jio.parse_npz(f, to_undirected=to_undirected)
    _same_data(got, want, 'parse_npz')
    _same_data(tio.read_npz(str(path)), jio.read_npz(str(path)), 'read_npz')


# -- TU -----------------------------------------------------------------------
def _tu(raw, rng, optional):
    sizes = [4, 6, 3]
    off = np.concatenate([[0], np.cumsum(sizes)])
    edges = np.array([(off[g] + a + 1, off[g] + b + 1)
                      for g, n in enumerate(sizes) for a, b in
                      rng.integers(0, n, (2 * n, 2))])
    files = {'A': (edges, '%d'),
             'graph_indicator': (np.repeat(np.arange(1, 4), sizes), '%d')}
    if 'labels' in optional:
        files.update(graph_labels=(np.array([3, 1, 3]), '%d'),
                     node_labels=(rng.integers(2, 5, sum(sizes)), '%d'),
                     edge_labels=(rng.integers(0, 3, len(edges)), '%d'))
    if 'attributes' in optional:
        files.update(
            node_attributes=(rng.standard_normal((sum(sizes), 2)), '%.5f'),
            edge_attributes=(rng.standard_normal((len(edges), 3)), '%.5f'),
            graph_attributes=(rng.standard_normal((3, 2)), '%.5f'))
    raw.mkdir(parents=True)
    for suffix, (arr, fmt) in files.items():
        np.savetxt(raw / f'T_{suffix}.txt', arr, fmt=fmt, delimiter=', ')


@pytest.mark.parametrize('optional', [(), ('labels',), ('attributes',),
                                      ('labels', 'attributes')])
def test_read_tu_data_matches_jax(tmp_path, optional):
    _tu(tmp_path / 'raw', np.random.default_rng(7), optional)
    got, got_sizes = tio.read_tu_data(str(tmp_path / 'raw'), 'T')
    want, want_sizes = jio.read_tu_data(str(tmp_path / 'raw'), 'T')
    assert got_sizes == want_sizes
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        _same_data(g, w, f'graph {i}')


def test_io_names_planetoid_reader():
    assert tio.read_planetoid_data is tplanetoid.read_planetoid_data
    assert set(tio.__all__) == set(jio.__all__)


# -- fsspec -------------------------------------------------------------------
@pytest.mark.parametrize('where', ['local', 'memory'])
def test_fs_wrappers(tmp_path, where):
    base = (str(tmp_path / 'store') if where == 'local'
            else f'memory://pgt_fs_test_{tmp_path.name}')
    fs = tio.fs
    fs.makedirs(f'{base}/a/b')
    assert fs.isdir(f'{base}/a') and fs.exists(f'{base}/a/b')
    assert fs.isdisk(base) == (where == 'local')
    assert fs.islocal(base)
    obj = {'x': np.arange(5.0), 'y': [1, 'two']}
    fs.save(obj, f'{base}/a/obj.pkl')
    assert fs.isfile(f'{base}/a/obj.pkl')
    back = fs.load(f'{base}/a/obj.pkl')
    np.testing.assert_array_equal(back['x'], obj['x'])
    assert back['y'] == obj['y']
    # the JAX package reads the port's pickle, and the port the JAX one's
    np.testing.assert_array_equal(jio.fs.load(f'{base}/a/obj.pkl')['x'],
                                  obj['x'])
    jio.fs.save(obj, f'{base}/a/jax.pkl')
    assert fs.load(f'{base}/a/jax.pkl')['y'] == obj['y']
    names = sorted(fs.ls(f'{base}/a'))
    assert names == sorted(jio.fs.ls(f'{base}/a'))
    assert [n.rstrip('/').rsplit('/', 1)[-1] for n in names] == [
        'b', 'jax.pkl', 'obj.pkl']
    assert sorted(fs.glob(f'{base}/a/*.pkl')) == sorted(
        jio.fs.glob(f'{base}/a/*.pkl'))
    fs.cp(f'{base}/a/obj.pkl', f'{base}/a/b')
    assert fs.isfile(f'{base}/a/b/obj.pkl')
    fs.mv(f'{base}/a/b/obj.pkl', f'{base}/a/b/moved.pkl')
    assert fs.exists(f'{base}/a/b/moved.pkl')
    assert not fs.exists(f'{base}/a/b/obj.pkl')
    fs.rm(f'{base}/a')
    assert not fs.exists(f'{base}/a')
    assert fs.normpath(f'{base}/x/../y') == (
        jio.fs.normpath(f'{base}/x/../y'))


def test_fs_cp_extracts_a_tar_gz(tmp_path):
    buf = stdio.BytesIO()
    with tarfile.open(fileobj=buf, mode='w:gz') as tar:
        for name, data in (('d/one.txt', b'1'), ('d/two.txt', b'22')):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, stdio.BytesIO(data))
    (tmp_path / 'arch.tar.gz').write_bytes(buf.getvalue())
    for pkg, out in ((tio, 'port'), (jio, 'jax')):
        (tmp_path / out).mkdir()
        pkg.fs.cp(str(tmp_path / 'arch.tar.gz'), str(tmp_path / out),
                  extract=True)
    # the members' common folder is dropped, as the JAX package drops it
    for name, data in (('one.txt', b'1'), ('two.txt', b'22')):
        assert (tmp_path / 'port' / name).read_bytes() == (
            tmp_path / 'jax' / name).read_bytes() == data


def test_fs_torch_save_and_load(tmp_path):
    obj = {'w': torch.arange(6.0).view(2, 3), 'n': 3}
    path = str(tmp_path / 'obj.pt')
    tio.fs.torch_save(obj, path)
    # the reference's format: torch.load reads it directly
    direct = torch.load(path, weights_only=True)
    back = tio.fs.torch_load(path, map_location='cpu')
    for got in (direct, back):
        assert torch.equal(got['w'], obj['w']) and got['n'] == 3
