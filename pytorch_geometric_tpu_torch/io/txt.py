"""Text array parsers.

Counterpart of ``pytorch_geometric_tpu/io/txt.py`` (reference
``torch_geometric/io/txt_array.py``): the same numpy parse, so both
packages read the same rows from the same text."""

from typing import Optional, Sequence

import numpy as np


def parse_txt_array(src: Sequence[str], sep: Optional[str] = None,
                    start: int = 0, end: Optional[int] = None,
                    dtype=np.float32) -> np.ndarray:
    """The fields ``start:end`` of each line of ``src``, split at ``sep``
    (whitespace by default), as one ``[lines, fields]`` array."""
    return np.array([[float(x) for x in line.split(sep)[start:end]]
                     for line in src], dtype)


def read_txt_array(path: str, sep: Optional[str] = None, start: int = 0,
                   end: Optional[int] = None,
                   dtype=np.float32) -> np.ndarray:
    """:func:`parse_txt_array` of the non-blank lines of the file at
    ``path``."""
    with open(path) as f:
        src = [line for line in f.read().split('\n') if line.strip()]
    return parse_txt_array(src, sep, start, end, dtype)
