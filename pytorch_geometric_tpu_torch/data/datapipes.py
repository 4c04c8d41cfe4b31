"""Iterable-pipeline adapters.

Counterpart of ``pytorch_geometric_tpu/data/datapipes.py`` (reference
``torch_geometric/data/datapipes.py``). The reference builds on
``torch.utils.data``'s IterDataPipes; as in the JAX package the same
composition is given over plain iterables: ``DatasetAdapter`` makes a
dataset iterable and chainable, ``Batcher`` groups it into ``Batch``
objects (padded where asked), ``functional_transform`` registers a
transform under a chainable method name.
"""

from typing import Callable, Iterator, Optional


class IterPipe:
    """A minimal chainable iterable (the IterDataPipe role)."""

    _registry = {}

    def __iter__(self) -> Iterator:
        raise NotImplementedError

    def __getattr__(self, name):
        fn = IterPipe._registry.get(name)
        if fn is None:
            raise AttributeError(name)

        def method(*args, **kwargs):
            return _Mapped(self, lambda d: fn(*args, **kwargs)(d))
        return method


class _Mapped(IterPipe):
    def __init__(self, source, fn: Callable):
        self.source, self.fn = source, fn

    def __iter__(self):
        for item in self.source:
            yield self.fn(item)


class DatasetAdapter(IterPipe):
    """A dataset as an iterable pipe (reference ``datapipes.py:67``)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __iter__(self):
        for i in range(len(self.dataset)):
            yield self.dataset[i]

    def __len__(self):
        return len(self.dataset)


class Batcher(IterPipe):
    """Groups of ``batch_size`` as ``Batch`` objects, padded to
    ``max_num_nodes`` / ``max_num_edges`` where given (reference
    ``datapipes.py:20``)."""

    def __init__(self, source, batch_size: int, drop_last: bool = False,
                 max_num_nodes: Optional[int] = None,
                 max_num_edges: Optional[int] = None):
        self.source = source
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.max_num_nodes = max_num_nodes
        self.max_num_edges = max_num_edges

    def _batch(self, buf):
        from .batch import Batch
        return Batch.from_data_list(buf, pad_num_nodes=self.max_num_nodes,
                                    pad_num_edges=self.max_num_edges)

    def __iter__(self):
        buf = []
        for item in self.source:
            buf.append(item)
            if len(buf) == self.batch_size:
                yield self._batch(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._batch(buf)


def functional_transform(name: str) -> Callable:
    """Register a transform class as a chainable pipe method
    (reference ``datapipes.py:87``)::

        @functional_transform('my_norm')
        class MyNorm(BaseTransform): ...
        pipe = DatasetAdapter(ds).my_norm()
    """
    def deco(cls):
        IterPipe._registry[name] = cls
        return cls
    return deco
