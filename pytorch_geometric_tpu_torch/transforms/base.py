"""BaseTransform and Compose.

Counterpart of ``pytorch_geometric_tpu/transforms/base.py`` (reference
``torch_geometric/transforms/base_transform.py`` and ``compose.py``).
Transforms are host-side graph rewrites, ``Data`` in and ``Data`` out: each
returns a new ``Data`` through ``replace``.
"""

from typing import Callable, Sequence


class BaseTransform:
    def __call__(self, data):
        raise NotImplementedError

    def __repr__(self):
        return f'{self.__class__.__name__}()'


class Compose(BaseTransform):
    """Chain transforms (reference ``compose.py``)."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data

    def __repr__(self):
        args = ', '.join(repr(t) for t in self.transforms)
        return f'Compose([{args}])'
