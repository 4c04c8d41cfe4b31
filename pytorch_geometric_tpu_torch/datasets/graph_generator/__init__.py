"""Class-based synthetic graph generators.

Counterpart of ``pytorch_geometric_tpu/datasets/graph_generator`` (reference
``torch_geometric/datasets/graph_generator/``: base.py, ba_graph.py,
er_graph.py, grid_graph.py, tree_graph.py), with the generator-object
protocol ``ExplainerDataset`` resolves. The numeric construction is the
port's copy of the JAX package's ``utils/misc.py`` generators
(``erdos_renyi_graph``, ``barabasi_albert_graph``,
``stochastic_blockmodel_graph``, ``grid``; reference ``utils/random.py``,
``utils/grid.py``): the same numpy streams, so one seed gives the JAX
package's edges, in its order.
"""

from abc import ABC, abstractmethod
from typing import Any, List, Sequence, Tuple

import numpy as np

from ...data.data import Data
from ...utils.coalesce import to_undirected


def erdos_renyi_graph(num_nodes: int, edge_prob: float,
                      directed: bool = False, seed: int = 0) -> np.ndarray:
    """Each ordered pair (each pair, undirected: both directions) an edge
    with probability ``edge_prob``; no self loops."""
    rng = np.random.default_rng(seed)
    mask = rng.random((num_nodes, num_nodes)) < edge_prob
    np.fill_diagonal(mask, False)
    if not directed:
        r, c = np.nonzero(np.triu(mask))
        return np.concatenate([np.stack([r, c]), np.stack([c, r])], 1)
    r, c = np.nonzero(mask)
    return np.stack([r, c])


def barabasi_albert_graph(num_nodes: int, num_edges: int,
                          seed: int = 0) -> np.ndarray:
    """Preferential attachment: each new node links to ``num_edges``
    earlier ones, drawn by degree; both directions."""
    rng = np.random.default_rng(seed)
    row, col = [], []
    targets = list(range(num_edges))
    repeated = []
    for v in range(num_edges, num_nodes):
        for t in targets:
            row += [v, t]
            col += [t, v]
        repeated += targets + [v] * num_edges
        targets = list(rng.choice(repeated, num_edges, replace=False))
    return np.stack([np.asarray(row), np.asarray(col)])


def stochastic_blockmodel_graph(block_sizes: Sequence[int], edge_probs,
                                directed: bool = False,
                                seed: int = 0) -> np.ndarray:
    """Each pair of nodes an edge with its blocks' probability; no self
    loops."""
    sizes = np.asarray(block_sizes)
    probs = np.asarray(edge_probs)
    block = np.repeat(np.arange(len(sizes)), sizes)
    rng = np.random.default_rng(seed)
    mask = rng.random((int(sizes.sum()),) * 2) < probs[block[:, None],
                                                       block[None, :]]
    np.fill_diagonal(mask, False)
    if not directed:
        r, c = np.nonzero(np.triu(mask))
        return np.concatenate([np.stack([r, c]), np.stack([c, r])], 1)
    r, c = np.nonzero(mask)
    return np.stack([r, c])


def grid(height: int, width: int, dtype=np.int64):
    """8-neighbour grid graph with self loops, and its positions."""
    row, col = [], []
    for r in range(height):
        for c in range(width):
            v = r * width + c
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    rr, cc = r + dr, c + dc
                    if 0 <= rr < height and 0 <= cc < width:
                        row.append(v)
                        col.append(rr * width + cc)
    pos = np.stack([np.tile(np.arange(width), height),
                    (height - 1 - np.repeat(np.arange(height), width))],
                   1).astype(np.float32)
    return np.stack([np.asarray(row, dtype), np.asarray(col, dtype)]), pos


class GraphGenerator(ABC):
    """Abstract base for synthetic graph generators
    (reference ``graph_generator/base.py``)."""

    @abstractmethod
    def __call__(self) -> Data:
        raise NotImplementedError

    @staticmethod
    def resolve(query: Any, *args: Any, **kwargs: Any) -> 'GraphGenerator':
        if isinstance(query, GraphGenerator):
            return query
        if isinstance(query, type) and issubclass(query, GraphGenerator):
            return query(*args, **kwargs)
        if isinstance(query, str):
            q = query.lower()
            for gen in list(globals().values()):
                if (isinstance(gen, type) and issubclass(gen, GraphGenerator)
                        and gen is not GraphGenerator):
                    name = gen.__name__.lower()
                    if q in (name, name.replace('graph', '')):
                        return gen(*args, **kwargs)
        raise ValueError(f"Could not resolve graph generator '{query}'")

    def __repr__(self) -> str:
        return f'{self.__class__.__name__}()'


class BAGraph(GraphGenerator):
    """Barabasi-Albert graphs (reference ``graph_generator/ba_graph.py``);
    each call draws the next seed's graph."""

    def __init__(self, num_nodes: int, num_edges: int, seed: int = 0):
        super().__init__()
        self.num_nodes = num_nodes
        self.num_edges = num_edges
        self._seed = seed

    def __call__(self) -> Data:
        edge_index = barabasi_albert_graph(self.num_nodes, self.num_edges,
                                           seed=self._seed)
        self._seed += 1
        return Data(num_nodes=self.num_nodes, edge_index=edge_index)

    def __repr__(self) -> str:
        return (f'{self.__class__.__name__}(num_nodes={self.num_nodes}, '
                f'num_edges={self.num_edges})')


class ERGraph(GraphGenerator):
    """Erdos-Renyi graphs (reference ``graph_generator/er_graph.py``); each
    call draws the next seed's graph."""

    def __init__(self, num_nodes: int, edge_prob: float, seed: int = 0):
        super().__init__()
        self.num_nodes = num_nodes
        self.edge_prob = edge_prob
        self._seed = seed

    def __call__(self) -> Data:
        edge_index = erdos_renyi_graph(self.num_nodes, self.edge_prob,
                                       seed=self._seed)
        self._seed += 1
        return Data(num_nodes=self.num_nodes, edge_index=edge_index)

    def __repr__(self) -> str:
        return (f'{self.__class__.__name__}(num_nodes={self.num_nodes}, '
                f'edge_prob={self.edge_prob})')


class GridGraph(GraphGenerator):
    """2-D grid graphs (reference ``graph_generator/grid_graph.py``)."""

    def __init__(self, height: int, width: int, dtype=None):
        super().__init__()
        self.height = height
        self.width = width
        self.dtype = dtype

    def __call__(self) -> Data:
        edge_index, pos = grid(self.height, self.width)
        if self.dtype is not None:
            pos = pos.astype(self.dtype)
        return Data(edge_index=edge_index, pos=pos)

    def __repr__(self) -> str:
        return (f'{self.__class__.__name__}(height={self.height}, '
                f'width={self.width})')


def tree(depth: int, branch: int = 2, undirected: bool = False
         ) -> Tuple[np.ndarray, np.ndarray]:
    """Perfect ``branch``-ary tree edges (parent to child, BFS ids) and each
    node's depth (reference ``graph_generator/tree_graph.py::tree``)."""
    edges: List[Tuple[int, int]] = []
    depths: List[int] = [0]
    frontier = [0]
    for d in range(depth):
        nxt = []
        for node in frontier:
            for _ in range(branch):
                child = len(depths)
                edges.append((node, child))
                depths.append(d + 1)
                nxt.append(child)
        frontier = nxt
    edge_index = np.asarray(edges, np.int64).T.reshape(2, -1)
    if undirected:
        edge_index = to_undirected(edge_index, num_nodes=len(depths))
    return edge_index, np.asarray(depths, np.int64)


class TreeGraph(GraphGenerator):
    """Perfect trees (reference ``graph_generator/tree_graph.py``). The
    reference emits edges in DFS insertion order; the ids (BFS) and the
    edge set are the same, the order is BFS, as in the JAX package."""

    def __init__(self, depth: int, branch: int = 2,
                 undirected: bool = False):
        super().__init__()
        self.depth = depth
        self.branch = branch
        self.undirected = undirected

    def __call__(self) -> Data:
        edge_index, depths = tree(self.depth, self.branch, self.undirected)
        return Data(edge_index=edge_index, depth=depths,
                    num_nodes=len(depths))

    def __repr__(self) -> str:
        return (f'{self.__class__.__name__}(depth={self.depth}, '
                f'branch={self.branch}, undirected={self.undirected})')


__all__ = ['GraphGenerator', 'BAGraph', 'ERGraph', 'GridGraph', 'TreeGraph']
