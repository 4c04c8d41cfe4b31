"""Archive extraction helpers.

Counterpart of ``pytorch_geometric_tpu/data/extract.py`` (reference
``torch_geometric/data/extract.py``): tar (members filtered as data), zip,
and single-file bz2 and gz, the output named after the archive less its
suffix."""

import bz2
import gzip
import os
import os.path as osp
import sys
import tarfile
import zipfile


def _maybe_log(path: str, log: bool = True) -> None:
    if log and 'PYTEST_CURRENT_TEST' not in os.environ:
        print(f'Extracting {path}', file=sys.stderr)


def extract_tar(path: str, folder: str, mode: str = 'r:gz',
                log: bool = True) -> None:
    _maybe_log(path, log)
    with tarfile.open(path, mode) as f:
        f.extractall(folder, filter='data')


def extract_zip(path: str, folder: str, log: bool = True) -> None:
    _maybe_log(path, log)
    with zipfile.ZipFile(path, 'r') as f:
        f.extractall(folder)


def extract_bz2(path: str, folder: str, log: bool = True) -> None:
    _maybe_log(path, log)
    out = osp.join(folder, osp.basename(path)[:-4])
    with bz2.open(path) as r, open(out, 'wb') as w:
        w.write(r.read())


def extract_gz(path: str, folder: str, log: bool = True) -> None:
    _maybe_log(path, log)
    out = osp.join(folder, osp.basename(path)[:-3])
    with gzip.open(path, 'rb') as r, open(out, 'wb') as w:
        w.write(r.read())
