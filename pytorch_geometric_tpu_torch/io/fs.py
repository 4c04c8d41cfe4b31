"""fsspec filesystem wrappers.

Counterpart of ``pytorch_geometric_tpu/io/fs.py`` (reference
``torch_geometric/io/fs.py``): path-URI dispatch, so a dataset root can
lie on any fsspec backend (local, ``memory://``, ``http(s)://``, ``gs://``,
``s3://``). ``save`` / ``load`` pickle a tree of arrays, as the JAX
package's do; ``torch_save`` / ``torch_load`` go through ``torch.save`` /
``torch.load``, the reference's format (the JAX package pickles there too:
ROADMAP Queue 3). A remote archive is cached under the temporary directory
(``tempfile.gettempdir()``) while it is extracted."""

import os.path as osp
import pickle
import sys
import tempfile
from typing import Any, Dict, List, Optional, Union

try:
    import fsspec
    _HAS_FSSPEC = True
except ImportError:          # pragma: no cover - torch installs it
    fsspec = None
    _HAS_FSSPEC = False

DEFAULT_CACHE_PATH = osp.join(tempfile.gettempdir(), 'pgt_simplecache')


def get_fs(path: str) -> 'fsspec.AbstractFileSystem':
    """The filesystem of a path URI (reference ``fs.py:21``)."""
    if not _HAS_FSSPEC:
        raise ImportError("'get_fs' requires the 'fsspec' package")
    return fsspec.core.url_to_fs(path)[0]


def normpath(path: str) -> str:
    if isdisk(path):
        return osp.normpath(path)
    return path


def exists(path: str) -> bool:
    return get_fs(path).exists(path)


def makedirs(path: str, exist_ok: bool = True) -> None:
    return get_fs(path).makedirs(path, exist_ok)


def isdir(path: str) -> bool:
    return get_fs(path).isdir(path)


def isfile(path: str) -> bool:
    return get_fs(path).isfile(path)


def isdisk(path: str) -> bool:
    return 'file' in get_fs(path).protocol


def islocal(path: str) -> bool:
    return isdisk(path) or 'memory' in get_fs(path).protocol


def ls(path: str, detail: bool = False) -> Union[List[str],
                                                 List[Dict[str, Any]]]:
    fs = get_fs(path)
    outputs = fs.ls(path, detail=detail)
    if not isdisk(path):
        if detail:
            for output in outputs:
                output['name'] = fs.unstrip_protocol(output['name'])
        else:
            outputs = [fs.unstrip_protocol(o) for o in outputs]
    return outputs


def cp(path1: str, path2: str, extract: bool = False,
       log: bool = True, use_cache: bool = True,
       clear_cache: bool = True) -> None:
    """Copy ``path1`` to ``path2`` across filesystems, extracting a
    ``.tar.gz``, ``.zip`` or ``.gz`` when ``extract`` (reference
    ``fs.py:117``)."""
    kwargs: Dict[str, Any] = {}
    is_path2_dir = isdir(path2)
    # a remote archive is cached locally while it is extracted
    if not islocal(path1):
        if log and 'pytest' not in sys.modules:
            print(f'Downloading {path1}', file=sys.stderr)
        if extract and use_cache:
            kwargs.setdefault('simplecache',
                              dict(cache_storage=DEFAULT_CACHE_PATH))
            path1 = f'simplecache::{path1}'
    if extract and path1.endswith('.tar.gz'):
        kwargs.setdefault('tar', dict(compression='gzip'))
        path1 = f'tar://**::{path1}'
    elif extract and path1.endswith('.zip'):
        path1 = f'zip://**::{path1}'
    elif extract and path1.endswith('.gz'):
        kwargs.setdefault('compression', 'infer')

    multiple_files = '*' in path1
    open_files = fsspec.open_files(path1, **kwargs)
    with open_files as of:
        for _, open_file in zip(of, open_files):
            with open_file as f_from:
                to_path = path2
                if multiple_files:
                    common = osp.commonprefix(
                        [of2.path for of2 in open_files])
                    to_path = osp.join(path2, open_file.path[len(common):])
                elif is_path2_dir:
                    to_path = osp.join(path2, osp.basename(path1))
                fs2 = get_fs(to_path)
                if not fs2.exists(osp.dirname(to_path)):
                    fs2.makedirs(osp.dirname(to_path), exist_ok=True)
                with fs2.open(to_path, 'wb') as f_to:
                    while True:
                        chunk = f_from.read(10 * 1024 * 1024)
                        if not chunk:
                            break
                        f_to.write(chunk)
    if clear_cache and use_cache and exists(DEFAULT_CACHE_PATH):
        try:
            rm(DEFAULT_CACHE_PATH)
        except PermissionError:      # pragma: no cover
            pass


def rm(path: str, recursive: bool = True) -> None:
    get_fs(path).rm(path, recursive)


def mv(path1: str, path2: str) -> None:
    fs1, fs2 = get_fs(path1), get_fs(path2)
    assert fs1.protocol == fs2.protocol
    fs1.mv(path1, path2)


def glob(path: str) -> List[str]:
    fs = get_fs(path)
    out = fs.glob(path)
    if not isdisk(path):
        out = [fs.unstrip_protocol(p) for p in out]
    return out


def save(data: Any, path: str) -> None:
    """Pickle a tree of arrays to any fsspec path."""
    with fsspec.open(path, 'wb') as f:
        f.write(pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL))


def load(path: str) -> Any:
    with fsspec.open(path, 'rb') as f:
        return pickle.load(f)


def torch_save(data: Any, path: str) -> None:
    """``torch.save`` to any fsspec path (reference ``fs.py:torch_save``)."""
    import torch
    with fsspec.open(path, 'wb') as f:
        torch.save(data, f)


def torch_load(path: str, map_location: Optional[Any] = None) -> Any:
    """``torch.load`` from any fsspec path (reference
    ``fs.py:torch_load``); the file may hold any picklable object, as the
    reference's may, so it is read with ``weights_only=False``: load only
    files you trust."""
    import torch
    with fsspec.open(path, 'rb') as f:
        return torch.load(f, map_location=map_location, weights_only=False)
