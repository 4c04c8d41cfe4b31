"""URL download helpers.

Counterpart of ``pytorch_geometric_tpu/data/download.py`` (reference
``torch_geometric/data/download.py``), with the same API. No dataset class
calls them: a dataset whose raw files are missing raises. ``download_url``
returns at once when the file is already in ``folder``. ``makedirs`` is the
port's copy of the JAX package's ``io/fs.py::makedirs``.
"""

import os
import os.path as osp
import ssl
import sys
import urllib.request
from typing import Optional


def makedirs(path: str, exist_ok: bool = True) -> None:
    """Make ``path`` and its parents on its filesystem (reference
    ``io/fs.py``): an fsspec URI through fsspec where it is installed,
    else the local disk."""
    try:
        import fsspec
    except ImportError:
        os.makedirs(path, exist_ok=exist_ok)
        return
    fsspec.core.url_to_fs(path)[0].makedirs(path, exist_ok)


def _log(msg: str, log: bool) -> None:
    if log and 'PYTEST_CURRENT_TEST' not in os.environ:
        print(msg, file=sys.stderr)


def download_url(url: str, folder: str, log: bool = True,
                 filename: Optional[str] = None) -> str:
    """Download ``url`` into ``folder`` and return the file path
    (reference ``download.py:13``). Skips the download when the target
    file already exists."""
    if filename is None:
        filename = url.rpartition('/')[2]
        filename = filename if filename[0] == '?' else filename.split('?')[0]
    path = osp.join(folder, filename)
    if osp.exists(path):
        _log(f'Using existing file {filename}', log)
        return path
    _log(f'Downloading {url}', log)
    os.makedirs(folder, exist_ok=True)
    ctx = ssl._create_unverified_context()
    with urllib.request.urlopen(url, context=ctx) as resp, \
            open(path, 'wb') as f:
        while True:
            chunk = resp.read(10 * 1024 * 1024)
            if not chunk:
                break
            f.write(chunk)
    return path


def download_google_url(id: str, folder: str, filename: str,
                        log: bool = True) -> str:
    """Download a Google-Drive hosted file by id (reference
    ``download.py:62``)."""
    url = f'https://drive.usercontent.google.com/download?id={id}&confirm=t'
    return download_url(url, folder, log, filename)
