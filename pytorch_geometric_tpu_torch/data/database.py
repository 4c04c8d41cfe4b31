"""Database and OnDiskDataset: datasets larger than memory.

Counterpart of ``pytorch_geometric_tpu/data/database.py`` (reference
``torch_geometric/data/database.py:59``, ``SQLiteDatabase`` ``:274``,
``RocksDatabase`` ``:584``, the ``TensorInfo`` schema, and
``on_disk_dataset.py:12``). A row is pickled as the JAX package pickles it:
a ``Data`` as a dict of numpy arrays and its node count, read back as a
port ``Data`` of host tensors. SQLite is in the standard library; RocksDB
needs the optional ``rocksdict`` package and raises ``ImportError``
without it.
"""

import io
import os.path as osp
import pickle
import sqlite3
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

from .data import Data, host
from .dataset import Dataset


@dataclass
class TensorInfo:
    """(reference ``database.py:TensorInfo``)."""
    dtype: str
    size: tuple = (-1,)


class Database:
    """Abstract key-value store of serialised rows (reference
    ``database.py:59``)."""

    def insert(self, index: int, data: Any):
        raise NotImplementedError

    def multi_insert(self, indices: Sequence[int], data_list):
        for i, d in zip(indices, data_list):
            self.insert(i, d)

    def get(self, index: int) -> Any:
        raise NotImplementedError

    def multi_get(self, indices: Sequence[int]) -> List[Any]:
        return [self.get(i) for i in indices]

    def __len__(self) -> int:
        raise NotImplementedError

    def close(self):
        pass


def _serialize(obj) -> bytes:
    if isinstance(obj, Data):
        payload = {'__pgt_data__': True}
        for k, v in obj.items():
            payload[k] = host(v)
        payload['__num_nodes__'] = obj.num_nodes
        obj = payload
    buf = io.BytesIO()
    pickle.dump(obj, buf, protocol=4)
    return buf.getvalue()


def _deserialize(blob: bytes):
    obj = pickle.loads(blob)
    if isinstance(obj, dict) and obj.get('__pgt_data__'):
        num_nodes = obj.pop('__num_nodes__')
        obj.pop('__pgt_data__')
        return Data(num_nodes=num_nodes, **obj)
    return obj


class SQLiteDatabase(Database):
    """(reference ``database.py:274``): one table of ``(id, blob)``."""

    def __init__(self, path: str, name: str = 'pgt'):
        self.path = path
        self.name = name
        self._conn = sqlite3.connect(path)
        self._conn.execute(
            f'CREATE TABLE IF NOT EXISTS {name} '
            f'(id INTEGER PRIMARY KEY, data BLOB NOT NULL)')
        self._conn.commit()

    def insert(self, index: int, data: Any):
        self._conn.execute(
            f'INSERT OR REPLACE INTO {self.name} (id, data) VALUES (?, ?)',
            (int(index), _serialize(data)))
        self._conn.commit()

    def multi_insert(self, indices, data_list):
        self._conn.executemany(
            f'INSERT OR REPLACE INTO {self.name} (id, data) VALUES (?, ?)',
            [(int(i), _serialize(d)) for i, d in zip(indices, data_list)])
        self._conn.commit()

    def get(self, index: int):
        row = self._conn.execute(
            f'SELECT data FROM {self.name} WHERE id = ?',
            (int(index),)).fetchone()
        if row is None:
            raise KeyError(index)
        return _deserialize(row[0])

    def __len__(self):
        return self._conn.execute(
            f'SELECT COUNT(*) FROM {self.name}').fetchone()[0]

    def close(self):
        self._conn.close()


class RocksDatabase(Database):
    """RocksDB-backed key-value store (reference ``database.py:584``) on
    the optional ``rocksdict`` package, as the reference gates it."""

    def __init__(self, path: str, name: str = 'pgt'):
        try:
            from rocksdict import Options, Rdict
        except ImportError as e:
            raise ImportError(
                "'RocksDatabase' requires the 'rocksdict' package") from e
        self.path = path
        self.name = name
        opts = Options(raw_mode=True)
        opts.create_if_missing(True)
        self._db = Rdict(path, opts)
        self._count = sum(1 for _ in self._db.keys())  # once, at open

    @staticmethod
    def _key(index: int) -> bytes:
        return int(index).to_bytes(8, 'big', signed=True)

    def insert(self, index: int, data: Any):
        key = self._key(index)
        # a cheap existence check keeps the count without reading the
        # value; a false positive of key_may_exist costs one get
        may = getattr(self._db, 'key_may_exist', None)
        exists = (self._db.get(key) is not None
                  if may is None or may(key) else False)
        if not exists:
            self._count += 1
        self._db[key] = _serialize(data)

    def get(self, index: int):
        row = self._db.get(self._key(index))
        if row is None:
            raise KeyError(index)
        return _deserialize(row)

    def __len__(self):
        return self._count

    def close(self):
        self._db.close()


class OnDiskDataset(Dataset):
    """A dataset over a Database (reference ``on_disk_dataset.py:12``):
    subclasses implement ``process()`` calling ``self.append(data)``."""

    def __init__(self, root: str, backend: str = 'sqlite', **kwargs):
        self.backend = backend
        self._db: Optional[Database] = None
        super().__init__(root, **kwargs)

    @property
    def processed_file_names(self):
        return ['data.sqlite']

    @property
    def db(self) -> Database:
        if self._db is None:
            self._db = SQLiteDatabase(
                osp.join(self.processed_dir, 'data.sqlite'))
        return self._db

    def append(self, data):
        self.db.insert(len(self.db), data)

    def len(self) -> int:
        return len(self.db)

    def get(self, idx: int):
        return self.db.get(idx)
