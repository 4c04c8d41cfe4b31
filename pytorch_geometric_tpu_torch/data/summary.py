"""Dataset summary statistics.

Counterpart of ``pytorch_geometric_tpu/data/summary.py`` (reference
``torch_geometric/data/summary.py``): the number of graphs and the
distribution of node and edge counts, in float64 numpy as the JAX package
computes them. The counts are static sizes, so graphs on the card are
summarised without reading their tensors back.
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class Stats:
    mean: float
    std: float
    min: float
    quantile25: float
    median: float
    quantile75: float
    max: float

    @classmethod
    def from_data(cls, values) -> 'Stats':
        v = np.asarray(values, np.float64)
        if v.size == 0:
            return cls(0, 0, 0, 0, 0, 0, 0)
        q = np.quantile(v, [0.25, 0.5, 0.75])
        return cls(float(v.mean()), float(v.std()), float(v.min()),
                   float(q[0]), float(q[1]), float(q[2]), float(v.max()))


@dataclass
class Summary:
    num_graphs: int
    num_nodes: Stats
    num_edges: Stats

    @classmethod
    def from_dataset(cls, dataset) -> 'Summary':
        ns = [d.num_nodes for d in dataset]
        es = [d.num_edges for d in dataset]
        return cls(len(ns), Stats.from_data(ns), Stats.from_data(es))

    def __repr__(self):
        def row(name, s: Stats):
            return (f'{name:<10} | mean {s.mean:8.1f} | std {s.std:8.1f}'
                    f' | min {s.min:8.0f} | max {s.max:8.0f}')
        return '\n'.join([f'Summary(num_graphs={self.num_graphs})',
                          row('nodes', self.num_nodes),
                          row('edges', self.num_edges)])


def summary(dataset) -> Summary:
    return Summary.from_dataset(dataset)
