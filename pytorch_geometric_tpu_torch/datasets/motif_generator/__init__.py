"""Class-based motif generators for explainability benchmarks.

Counterpart of ``pytorch_geometric_tpu/datasets/motif_generator`` (reference
``torch_geometric/datasets/motif_generator/``: base.py, custom.py,
house.py, cycle.py, grid.py), the GNNExplainer paper's motifs, with the same
edge orders and role labels.
"""

from abc import ABC, abstractmethod
from typing import Any, Optional

import numpy as np

from ...data.data import Data


class MotifGenerator(ABC):
    """Abstract base for motif generators
    (reference ``motif_generator/base.py``)."""

    @abstractmethod
    def __call__(self) -> Data:
        raise NotImplementedError

    @staticmethod
    def resolve(query: Any, *args: Any, **kwargs: Any) -> 'MotifGenerator':
        if isinstance(query, MotifGenerator):
            return query
        if isinstance(query, type) and issubclass(query, MotifGenerator):
            return query(*args, **kwargs)
        if isinstance(query, str):
            q = query.lower()
            for gen in list(globals().values()):
                if (isinstance(gen, type) and issubclass(gen, MotifGenerator)
                        and gen is not MotifGenerator):
                    name = gen.__name__.lower()
                    if q in (name, name.replace('motif', '')):
                        return gen(*args, **kwargs)
        raise ValueError(f"Could not resolve motif generator '{query}'")

    def __repr__(self) -> str:
        return f'{self.__class__.__name__}()'


def _from_networkx(g) -> Data:
    """A networkx graph's structure as a ``Data``: nodes renumbered in
    their order, an undirected graph's edges in both directions (the JAX
    package's ``utils/convert.py::from_networkx`` without attributes)."""
    mapping = {v: i for i, v in enumerate(g.nodes)}
    edges = [(mapping[u], mapping[v]) for u, v in g.edges]
    if not g.is_directed():
        edges = edges + [(v, u) for u, v in edges]
    coo = (np.array(edges, np.int64).T if edges
           else np.zeros((2, 0), np.int64))
    return Data(edge_index=coo, num_nodes=g.number_of_nodes())


class CustomMotif(MotifGenerator):
    """A motif from a given structure, a :class:`Data` graph or a networkx
    graph (reference ``motif_generator/custom.py``)."""

    def __init__(self, structure: Any):
        super().__init__()
        self.structure: Optional[Data] = None
        if isinstance(structure, Data):
            self.structure = structure
        else:
            try:
                import networkx as nx
                if isinstance(structure, nx.Graph):
                    self.structure = _from_networkx(structure)
            except ImportError:
                pass
        if self.structure is None:
            raise ValueError(
                f"Expected a motif structure of type 'Data' or "
                f"'networkx.Graph' (got {type(structure)})")

    def __call__(self) -> Data:
        assert isinstance(self.structure, Data)
        return self.structure


class HouseMotif(CustomMotif):
    """The 5-node house; labels are the structural roles top / middle /
    bottom (reference ``motif_generator/house.py``)."""

    def __init__(self) -> None:
        super().__init__(Data(
            num_nodes=5,
            edge_index=np.array([
                [0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4],
                [1, 3, 4, 4, 2, 0, 1, 3, 2, 0, 0, 1],
            ], np.int64),
            y=np.array([0, 0, 1, 1, 2], np.int64),
        ))


class CycleMotif(CustomMotif):
    """A cycle of ``num_nodes`` nodes, undirected, sorted by row then column
    (reference ``motif_generator/cycle.py``)."""

    def __init__(self, num_nodes: int):
        self.num_nodes = num_nodes
        row = np.repeat(np.arange(num_nodes), 2)
        col1 = np.arange(-1, num_nodes - 1) % num_nodes
        col2 = np.arange(1, num_nodes + 1) % num_nodes
        col = np.sort(np.stack([col1, col2], axis=1), axis=-1).reshape(-1)
        super().__init__(Data(
            num_nodes=num_nodes,
            edge_index=np.stack([row, col]).astype(np.int64),
        ))

    def __repr__(self) -> str:
        return f'{self.__class__.__name__}({self.num_nodes})'


class GridMotif(CustomMotif):
    """The 3x3 grid with structural-role labels
    (reference ``motif_generator/grid.py``)."""

    def __init__(self) -> None:
        pairs = [
            (0, 1), (0, 3), (1, 4), (3, 4), (1, 2), (2, 5), (4, 5),
            (3, 6), (6, 7), (4, 7), (5, 8), (7, 8),
        ]
        edges = pairs + [(b, a) for a, b in pairs]
        super().__init__(Data(
            num_nodes=9,
            edge_index=np.asarray(edges, np.int64).T,
            y=np.array([0, 1, 0, 1, 2, 1, 0, 1, 0], np.int64),
        ))


__all__ = ['MotifGenerator', 'CustomMotif', 'HouseMotif', 'CycleMotif',
           'GridMotif']
