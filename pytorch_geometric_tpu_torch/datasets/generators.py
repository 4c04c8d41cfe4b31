"""Synthetic graph generators: KarateClub, the stochastic block model, the
BA-shapes explainer benchmarks, FakeHeteroDataset, the infection benchmark
and the planted-partition graphs.

Counterpart of ``pytorch_geometric_tpu/datasets/generators.py`` (reference
``torch_geometric/datasets/karate.py`` (Zachary 1977, public-domain
sociology data), ``sbm_dataset.py``, ``explainer_dataset.py`` with
``graph_generator/ba_graph.py`` and ``motif_generator/house.py``,
``datasets/fake.py:111``, ``ba_shapes.py``, ``ba2motif_dataset.py``,
``ba_multi_shapes.py``, ``infection_dataset.py``,
``mixhop_synthetic_dataset.py``, ``random_partition_graph_dataset.py``),
with the same numpy streams: one seed gives the JAX package's graphs bit
for bit, edge order included. Each builds host tensors.
"""

from typing import Sequence

import numpy as np

from ..data.data import Data, host
from ..data.hetero_data import HeteroData
from .graph_generator import (GraphGenerator, erdos_renyi_graph,
                              stochastic_blockmodel_graph)
from .motif_generator import MotifGenerator

# Zachary's karate club (1977), 78 undirected friendship edges among 34
# members; communities from the canonical split (public-domain data).
_KARATE_EDGES = [
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8),
    (0, 10), (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21),
    (0, 31), (1, 2), (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21),
    (1, 30), (2, 3), (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28),
    (2, 32), (3, 7), (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10),
    (5, 16), (6, 16), (8, 30), (8, 32), (8, 33), (9, 33), (13, 33),
    (14, 32), (14, 33), (15, 32), (15, 33), (18, 32), (18, 33), (19, 33),
    (20, 32), (20, 33), (22, 32), (22, 33), (23, 25), (23, 27), (23, 29),
    (23, 32), (23, 33), (24, 25), (24, 27), (24, 31), (25, 31), (26, 29),
    (26, 33), (27, 33), (28, 31), (28, 33), (29, 32), (29, 33), (30, 32),
    (30, 33), (31, 32), (31, 33), (32, 33),
]
# 4-community labels from greedy modularity maximisation, the dataset's
# convention (``datasets/karate.py``; communities as published with PyG's
# dataset card)
_KARATE_COMMUNITY = [
    1, 1, 1, 1, 3, 3, 3, 1, 0, 1, 3, 1, 1, 1, 0, 0, 3, 1, 0, 1, 0, 1,
    0, 0, 2, 2, 0, 0, 2, 0, 0, 2, 0, 0,
]


class _OneGraph:
    """A dataset of one generated graph, ``transform`` applied once."""

    def _set(self, data: Data, transform):
        self._data = transform(data) if transform else data

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        return self._data


class KarateClub(_OneGraph):
    """Zachary's karate club (reference ``datasets/karate.py``): one-hot
    features, one labelled node a community."""

    def __init__(self, transform=None):
        e = np.array(_KARATE_EDGES, np.int32).T
        coo = np.concatenate([e, e[::-1]], axis=1)
        coo = coo[:, np.lexsort((coo[1], coo[0]))]
        y = np.array(_KARATE_COMMUNITY, np.int32)
        train_mask = np.zeros(34, bool)
        for c in range(int(y.max()) + 1):
            train_mask[np.nonzero(y == c)[0][0]] = True
        self._set(Data(x=np.eye(34, dtype=np.float32), edge_index=coo, y=y,
                       train_mask=train_mask, num_nodes=34), transform)


class StochasticBlockModelDataset(_OneGraph):
    """SBM generator (reference ``datasets/sbm_dataset.py``): blocks of the
    given sizes, edges by the block-pair probabilities, both directions;
    features around a Gaussian centre a block."""

    def __init__(self, block_sizes: Sequence[int], edge_probs,
                 num_channels: int = 16, seed: int = 0, transform=None):
        rng = np.random.default_rng(seed)
        sizes = np.asarray(block_sizes)
        probs = np.asarray(edge_probs)
        n = int(sizes.sum())
        y = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
        rows, cols = [], []
        offs = np.concatenate([[0], np.cumsum(sizes)])
        for i in range(len(sizes)):
            for j in range(len(sizes)):
                block = rng.random((sizes[i], sizes[j])) < probs[i, j]
                if i == j:
                    block = np.triu(block, 1)
                r, c = np.nonzero(block)
                rows.append(r + offs[i])
                cols.append(c + offs[j])
        row = np.concatenate(rows)
        col = np.concatenate(cols)
        coo = np.stack([np.concatenate([row, col]),
                        np.concatenate([col, row])]).astype(np.int32)
        centers = rng.standard_normal((len(sizes), num_channels)) * 1.5
        x = (centers[y]
             + rng.standard_normal((n, num_channels))).astype(np.float32)
        self._set(Data(x=x, edge_index=coo, y=y, num_nodes=n), transform)


def ba_graph(rng, num_nodes: int, num_edges_per_node: int = 5
             ) -> np.ndarray:
    """Barabasi-Albert preferential attachment over ``rng``, both
    directions (reference ``datasets/graph_generator/ba_graph.py``)."""
    m = num_edges_per_node
    targets = list(range(m))
    repeated = []
    rows, cols = [], []
    for v in range(m, num_nodes):
        for t in set(targets):
            rows.append(v)
            cols.append(t)
        repeated.extend(targets)
        repeated.extend([v] * m)
        targets = [repeated[i] for i in rng.integers(0, len(repeated), m)]
    e = np.stack([np.array(rows), np.array(cols)])
    return np.concatenate([e, e[::-1]], axis=1).astype(np.int32)


class ExplainerDataset(_OneGraph):
    """BA-shapes: a base graph with motifs attached, and ground-truth masks
    (reference ``datasets/explainer_dataset.py``).

    Either the legacy ``num_nodes`` form (a BA base and house motifs) or
    the reference's generator-object form, ``ExplainerDataset(
    graph_generator, motif_generator='house', num_motifs=80)``, with the
    generators resolved through :class:`graph_generator.GraphGenerator` and
    :class:`motif_generator.MotifGenerator`."""

    HOUSE_EDGES = np.array([(0, 1), (1, 2), (2, 3), (3, 0), (3, 4),
                            (4, 0)], np.int64).T

    def __init__(self, num_nodes=300, num_motifs: int = 80, seed: int = 0,
                 transform=None, motif_generator=None, graph_generator=None):
        if graph_generator is None and not isinstance(
                num_nodes, (int, np.integer)):
            # the reference's positional form: a graph generator first
            graph_generator = num_nodes
        if graph_generator is None and motif_generator is not None:
            raise ValueError(
                'motif_generator requires a graph_generator (the legacy '
                'num_nodes form always builds BA + house motifs)')
        if graph_generator is not None:
            self._init_from_generators(graph_generator,
                                       motif_generator or 'house',
                                       num_motifs, seed, transform)
            return
        rng = np.random.default_rng(seed)
        edges = [ba_graph(rng, num_nodes)]
        n = num_nodes
        node_label = np.zeros(num_nodes, np.int32)
        node_mask = np.zeros(num_nodes, bool)
        for _ in range(num_motifs):
            he = self.HOUSE_EDGES + n
            he = np.concatenate([he, he[::-1]], axis=1)
            attach = rng.integers(0, num_nodes)
            link = np.array([[attach, n], [n, attach]], np.int64).T
            edges.extend([he, link])
            node_label = np.concatenate(
                [node_label, np.array([1, 1, 2, 2, 3], np.int32)])
            node_mask = np.concatenate([node_mask, np.ones(5, bool)])
            n += 5
        coo = np.concatenate(edges, axis=1).astype(np.int32)
        self._set(Data(x=np.ones((n, 10), np.float32), edge_index=coo,
                       y=node_label, node_mask=node_mask, num_nodes=n),
                  transform)

    def _init_from_generators(self, graph_generator, motif_generator,
                              num_motifs, seed, transform):
        """The reference's generator-object path
        (``explainer_dataset.py:64-124``): the base graph from the graph
        generator, ``num_motifs`` motif copies attached at random base
        nodes; ``node_mask`` / ``edge_mask`` mark motif nodes and edges;
        labels 0 for the base, the motif's ``y + 1`` for its nodes."""
        rng = np.random.default_rng(seed)
        base = GraphGenerator.resolve(graph_generator)()
        motif = MotifGenerator.resolve(motif_generator)()
        nb = int(base.num_nodes)
        nm = int(motif.num_nodes)
        motif_edges = host(motif.edge_index).astype(np.int64)
        edges = [host(base.edge_index).astype(np.int64)]
        edge_masks = [np.zeros(edges[0].shape[1], bool)]
        ys = [np.zeros(nb, np.int64)]
        node_mask = [np.zeros(nb, bool)]
        n = nb
        attach = rng.permutation(nb)[:num_motifs]
        for i in range(num_motifs):
            me = motif_edges + n
            link = np.array([[int(attach[i]), n], [n, int(attach[i])]],
                            np.int64).T
            edges.extend([me, link])
            edge_masks.extend([np.ones(me.shape[1], bool),
                               np.zeros(2, bool)])
            ys.append(host(motif.y).astype(np.int64) + 1
                      if motif.y is not None else np.ones(nm, np.int64))
            node_mask.append(np.ones(nm, bool))
            n += nm
        self._set(Data(edge_index=np.concatenate(edges, axis=1),
                       y=np.concatenate(ys),
                       node_mask=np.concatenate(node_mask),
                       edge_mask=np.concatenate(edge_masks), num_nodes=n),
                  transform)


class FakeHeteroDataset:
    """Random heterogeneous graphs (reference ``datasets/fake.py:111``)."""

    def __init__(self, num_graphs: int = 1, num_node_types: int = 3,
                 num_edge_types: int = 6, avg_num_nodes: int = 100,
                 avg_degree: int = 10, num_channels: int = 16,
                 num_classes: int = 4, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.num_classes = num_classes
        node_types = [f'v{i}' for i in range(num_node_types)]
        edge_types = []
        for i in range(num_edge_types):
            s = node_types[rng.integers(0, num_node_types)]
            d = node_types[rng.integers(0, num_node_types)]
            edge_types.append((s, f'e{i}', d))
        self._graphs = []
        for _ in range(num_graphs):
            data = HeteroData()
            sizes = {}
            for t in node_types:
                nt = max(2, int(rng.normal(avg_num_nodes,
                                           avg_num_nodes * 0.1)))
                sizes[t] = nt
                y = rng.integers(0, num_classes, nt)
                centers = rng.standard_normal((num_classes,
                                               num_channels)) * 2
                data[t].x = (centers[y] + rng.standard_normal(
                    (nt, num_channels))).astype(np.float32)
                data[t].y = y.astype(np.int32)
            for et in edge_types:
                s, _, d = et
                e = sizes[s] * avg_degree // 2
                data[et].edge_index = np.stack([
                    rng.integers(0, sizes[s], e),
                    rng.integers(0, sizes[d], e)]).astype(np.int32)
            self._graphs.append(data)

    def __len__(self):
        return len(self._graphs)

    def __getitem__(self, idx):
        return self._graphs[idx]


class BAShapes(_OneGraph):
    """A BA graph with house motifs attached (reference
    ``torch_geometric/datasets/ba_shapes.py``, now ExplainerDataset; kept
    as the classic fused generator): roles 1 top, 2 middle, 3 bottom."""

    def __init__(self, num_base_nodes: int = 300, num_motifs: int = 80,
                 transform=None, seed: int = 0):
        rng = np.random.default_rng(seed)
        coo = ba_graph(rng, num_base_nodes, 5)
        house = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 0], [0, 2]])
        rows = [coo[0]]
        cols = [coo[1]]
        y = np.zeros(num_base_nodes + 5 * num_motifs, np.int32)
        n = num_base_nodes
        for _ in range(num_motifs):
            base = int(rng.integers(0, num_base_nodes))
            he = house + n
            rows.append(np.concatenate([he[:, 0], he[:, 1], [base, n]]))
            cols.append(np.concatenate([he[:, 1], he[:, 0], [n, base]]))
            y[n] = 1
            y[n + 1:n + 3] = 2
            y[n + 3:n + 5] = 3
            n += 5
        coo = np.stack([np.concatenate(rows), np.concatenate(cols)])
        data = Data(x=np.ones((n, 10), np.float32),
                    edge_index=coo.astype(np.int32), y=y, num_nodes=n)
        data.train_mask = np.random.default_rng(seed + 1).random(n) < 0.8
        self._set(data, transform)


class BA2MotifDataset:
    """Graphs of 20 BA nodes, half with a house and half with a cycle
    attached (reference ``ba2motif_dataset.py``), for graph
    classification."""

    def __init__(self, num_graphs: int = 1000, transform=None,
                 seed: int = 0):
        self.transform = transform
        self.graphs = []
        house = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 0], [0, 2]])
        cycle = np.array([[i, (i + 1) % 5] for i in range(5)])
        for i in range(num_graphs):
            label = i % 2
            motif = house if label == 0 else cycle
            base = ba_graph(np.random.default_rng(seed + i), 20, 2)
            me = motif + 20
            attach = np.array([[int(np.random.default_rng(seed + i)
                                    .integers(0, 20)), 20]])
            coo = np.concatenate(
                [base, me.T, me.T[::-1], attach.T, attach.T[::-1]], 1)
            self.graphs.append(Data(x=np.ones((25, 10), np.float32),
                                    edge_index=coo.astype(np.int32),
                                    y=np.asarray([label]), num_nodes=25))

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, idx):
        g = self.graphs[idx]
        return g if self.transform is None else self.transform(g)


class BAMultiShapesDataset(BA2MotifDataset):
    """(reference ``ba_multi_shapes.py``): the same generator family."""


class InfectionDataset(_OneGraph):
    """The infection benchmark (reference ``infection_dataset.py``): labels
    are the BFS distance (capped) from the infected seed nodes over a
    random directed graph."""

    def __init__(self, num_nodes: int = 300, edge_prob: float = 0.02,
                 num_infected: int = 30, max_path_length: int = 4,
                 transform=None, seed: int = 0):
        rng = np.random.default_rng(seed)
        coo = erdos_renyi_graph(num_nodes, edge_prob, directed=True,
                                seed=seed)
        infected = rng.choice(num_nodes, num_infected, replace=False)
        dist = np.full(num_nodes, max_path_length + 1, np.int32)
        dist[infected] = 0
        frontier = list(infected)
        for step in range(1, max_path_length + 1):
            nxt = []
            for v in frontier:
                for u in coo[1][coo[0] == v]:
                    if dist[u] > step:
                        dist[u] = step
                        nxt.append(u)
            frontier = nxt
        x = np.zeros((num_nodes, 2), np.float32)
        x[infected, 1] = 1
        x[:, 0] = 1 - x[:, 1]
        self._set(Data(x=x, edge_index=coo.astype(np.int32),
                       y=np.minimum(dist, max_path_length),
                       num_nodes=num_nodes), transform)


class MixHopSyntheticDataset(_OneGraph):
    """Homophily-controlled synthetic graphs (reference
    ``mixhop_synthetic_dataset.py``): a planted partition whose
    inter-class edge probability follows the homophily."""

    def __init__(self, homophily: float = 0.5, num_nodes: int = 300,
                 num_classes: int = 10, transform=None, seed: int = 0):
        rng = np.random.default_rng(seed)
        sizes = [num_nodes // num_classes] * num_classes
        p_in = 0.06 * homophily * num_classes
        p_out = 0.06 * (1 - homophily) * num_classes / (num_classes - 1)
        probs = np.full((num_classes, num_classes), min(p_out, 1.0))
        np.fill_diagonal(probs, min(p_in, 1.0))
        coo = stochastic_blockmodel_graph(sizes, probs, seed=seed)
        n = sum(sizes)
        y = np.repeat(np.arange(num_classes), sizes).astype(np.int32)
        x = (np.eye(num_classes)[y]
             + rng.normal(0, 0.1, (n, num_classes))).astype(np.float32)
        self._set(Data(x=x, edge_index=coo.astype(np.int32), y=y,
                       num_nodes=n), transform)


class RandomPartitionGraphDataset(MixHopSyntheticDataset):
    """(reference ``random_partition_graph_dataset.py``): the same planted
    partition, parameterised by ``node_homophily_ratio``."""

    def __init__(self, num_classes: int = 10,
                 num_nodes_per_class: int = 30,
                 node_homophily_ratio: float = 0.5, **kw):
        super().__init__(homophily=node_homophily_ratio,
                         num_nodes=num_classes * num_nodes_per_class,
                         num_classes=num_classes, **kw)
