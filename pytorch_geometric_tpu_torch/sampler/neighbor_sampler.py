"""NeighborSampler: host-side CSC neighbour sampling.

Counterpart of ``pytorch_geometric_tpu/sampler/neighbor_sampler.py``
(reference ``torch_geometric/sampler/neighbor_sampler.py:40``, which calls
pyg-lib's ``torch.ops.pyg.neighbor_sample``, ``:576``). The production path
is the port's copy of the JAX package's C++ sampler (``csrc/sampler.cpp``:
Fisher-Yates fanouts, FlatMap relabel, C-ABI CSC views converted once), with
the numpy version kept for hosts without ``g++``. Both emit fixed-shape
padded ``SamplerOutput``s, so every batch of a loader has one shape.
Semantics and random streams are the JAX package's, line for line: the same
seed gives the same batch on each path (the two paths draw different
neighbours, as they do there). Per-hop fanouts, with/without replacement,
first-occurrence global->local relabeling, seeds-first ordering, edges
sampled toward the seeds.
"""

import ctypes
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import csrc
from .base import (BaseSampler, NodeSamplerInput, EdgeSamplerInput,
                   NumNeighbors, NegativeSampling, SamplerOutput)
from ..data.data import Data, host


class _CSC:
    """Column-compressed adjacency: in-neighbors per node
    (reference ``sampler/utils.py:to_csc``)."""

    def __init__(self, edge_index, num_nodes: int):
        coo = host(edge_index)
        # numpy's argsort(kind='stable') by destination: a stable sort's
        # permutation is unique, and torch's sorts on every core (~10x at
        # 12M edges)
        dst = coo[1] if coo.flags.writeable else coo[1].copy()
        order = torch.sort(torch.from_numpy(dst), stable=True)[1].numpy()
        self.row = coo[0][order]          # source of each in-edge
        self.eid = order.astype(np.int64)  # original edge position
        self.colptr = np.searchsorted(coo[1][order],
                                      np.arange(num_nodes + 1))
        self.num_nodes = num_nodes


def _sample_neighbors(csc: _CSC, frontier: np.ndarray, fanout: int,
                      rng: np.random.Generator, replace: bool):
    """For each frontier node: up to ``fanout`` in-neighbors.

    Returns (src [F*fanout], eid [F*fanout], valid [F*fanout]) — fixed
    shape, padded with -1/invalid.
    """
    f = len(frontier)
    deg = csc.colptr[frontier + 1] - csc.colptr[frontier]
    starts = csc.colptr[frontier]
    if replace:
        # one bound per frontier row (the JAX package's numpy path passes
        # the bounds as a row vector, which numpy cannot broadcast to
        # (f, fanout) unless f == fanout, and raises)
        offs = rng.integers(0, np.maximum(deg, 1)[:, None], (f, fanout))
        valid = (deg > 0)[:, None] & np.ones((f, fanout), bool)
    else:
        # without replacement: for each slot k take position
        # floor(k*deg/fanout) + jitter — approximates a uniform distinct
        # draw when deg > fanout; exact all-neighbors when deg <= fanout.
        k = np.arange(fanout)[None, :]
        valid = k < np.minimum(deg, fanout)[:, None]
        big = deg[:, None] > fanout
        base = (k * deg[:, None]) // max(fanout, 1)
        jitter = rng.integers(0, np.maximum(deg[:, None] // fanout, 1),
                              (f, fanout))
        offs = np.where(big, base + jitter, np.minimum(k, np.maximum(
            deg[:, None] - 1, 0)))
        offs = np.minimum(offs, np.maximum(deg[:, None] - 1, 0))
    pos = starts[:, None] + offs
    pos = np.minimum(pos, len(csc.row) - 1) if len(csc.row) else pos * 0
    src = csc.row[pos] if len(csc.row) else np.zeros((f, fanout),
                                                     np.int64)
    eid = csc.eid[pos] if len(csc.row) else np.zeros((f, fanout),
                                                     np.int64)
    return src.reshape(-1), eid.reshape(-1), valid.reshape(-1)


class NeighborSampler(BaseSampler):
    """GraphSAGE-style multi-hop sampler (reference
    ``neighbor_sampler.py:40``)."""

    def __init__(self, data: Union[Data, tuple],
                 num_neighbors: Sequence[int], replace: bool = False,
                 disjoint: bool = False,
                 temporal_strategy: str = 'uniform',
                 time_attr: Optional[str] = None,
                 weight_attr: Optional[str] = None, seed: int = 0):
        if isinstance(data, Data):
            self.num_nodes = data.num_nodes
            edge_index = data.edge_index
        else:
            edge_index, self.num_nodes = data
        self.csc = _CSC(edge_index, self.num_nodes)
        # C-ABI-ready views, converted ONCE: per-batch
        # ascontiguousarray on the full CSC (tens of MB at 10M+ edges)
        # was the dominant loader cost (~25 ms/batch at 10M edges)
        self._csc_c = tuple(
            np.ascontiguousarray(a, np.int64)
            for a in (self.csc.colptr, self.csc.row, self.csc.eid))
        self.num_neighbors = NumNeighbors(num_neighbors)
        self.replace = replace
        # temporal + weighted options (reference
        # ``neighbor_sampler.py:428``: node- or edge-level ``time_attr``
        # with 'uniform'|'last', ``weight_attr`` biased draws)
        self.node_time = self.edge_time = self.edge_weight = None
        if time_attr is not None:
            t = host(getattr(data, time_attr)).astype(np.float64)
            num_edges = len(self.csc.row)
            if len(t) == self.num_nodes:
                self.node_time = t
            elif len(t) == num_edges:
                self.edge_time = t     # indexed by original edge id
            else:
                raise ValueError(
                    f"'{time_attr}' has {len(t)} entries; expected "
                    f"num_nodes ({self.num_nodes}) or num_edges "
                    f"({num_edges})")
        if weight_attr is not None:
            self.edge_weight = host(
                getattr(data, weight_attr)).astype(np.float64)
        if temporal_strategy not in ('uniform', 'last'):
            raise ValueError(f"temporal_strategy must be 'uniform' or "
                             f"'last' (got {temporal_strategy!r})")
        self.temporal_strategy = temporal_strategy
        # temporal sampling needs per-seed subtrees (reference forces
        # disjoint=True when time_attr is set)
        self.disjoint = disjoint or self.is_temporal
        self.rng = np.random.default_rng(seed)
        self.batch_size: Optional[int] = None

    @property
    def is_temporal(self) -> bool:
        return self.node_time is not None or self.edge_time is not None

    def _sample_native(self, seeds: np.ndarray, bs: int, rng=None):
        """C++ fast path (csrc/sampler.cpp, the pyg-lib equivalent)."""
        rng = rng if rng is not None else self.rng
        lib = csrc.sampler_library()
        node_caps = self.num_neighbors.node_budget(bs)
        edge_caps = self.num_neighbors.edge_budget(bs)
        n_cap, e_cap = sum(node_caps), sum(edge_caps)
        H = self.num_neighbors.num_hops

        colptr, row, eid = self._csc_c
        seeds_c = np.ascontiguousarray(seeds, np.int64)
        fanouts = np.ascontiguousarray(self.num_neighbors.values,
                                       np.int64)
        ecaps = np.ascontiguousarray(edge_caps, np.int64)
        node = np.zeros(n_cap, np.int64)
        node_mask = np.zeros(n_cap, np.uint8)
        rows = np.zeros(e_cap, np.int64)
        cols = np.zeros(e_cap, np.int64)
        eids = np.zeros(e_cap, np.int64)
        emask = np.zeros(e_cap, np.uint8)
        nsn = np.zeros(H + 1, np.int64)
        nse = np.zeros(H, np.int64)

        def p64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        def pu8(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

        lib.neighbor_sample(
            p64(colptr), p64(row), p64(eid),
            ctypes.c_int64(self.num_nodes),
            p64(seeds_c), ctypes.c_int64(len(seeds_c)),
            p64(fanouts), ctypes.c_int64(H),
            p64(ecaps), ctypes.c_int64(n_cap), ctypes.c_int64(e_cap),
            ctypes.c_int(int(self.replace)),
            ctypes.c_uint64(int(rng.integers(0, 2 ** 62))),
            p64(node), pu8(node_mask), p64(rows), p64(cols), p64(eids),
            pu8(emask), p64(nsn), p64(nse))
        return SamplerOutput(
            node=node, row=rows, col=cols, edge=eids,
            node_mask=node_mask.astype(bool),
            edge_mask=emask.astype(bool),
            num_sampled_nodes=[int(v) for v in nsn],
            num_sampled_edges=[int(v) for v in nse],
            batch_size=len(seeds))

    def _seed_time(self, inputs, seeds) -> Optional[np.ndarray]:
        if not self.is_temporal:
            return None
        if inputs.time is not None:
            return np.asarray(inputs.time, np.float64)
        if self.node_time is not None:
            return self.node_time[seeds]
        raise ValueError(
            "edge-level temporal sampling needs explicit seed times "
            "(NodeSamplerInput.time / the loader's input_time)")

    def _sample_native_tw(self, seeds: np.ndarray, bs: int,
                          seed_time: Optional[np.ndarray], rng=None):
        """C++ temporal/weighted/disjoint path (neighbor_sample_tw)."""
        rng = rng if rng is not None else self.rng
        lib = csrc.sampler_library()
        node_caps = self.num_neighbors.node_budget(bs)
        edge_caps = self.num_neighbors.edge_budget(bs)
        n_cap, e_cap = sum(node_caps), sum(edge_caps)
        H = self.num_neighbors.num_hops

        colptr, row, eid = self._csc_c
        seeds_c = np.ascontiguousarray(seeds, np.int64)
        fanouts = np.ascontiguousarray(self.num_neighbors.values,
                                       np.int64)
        ecaps = np.ascontiguousarray(edge_caps, np.int64)
        node = np.zeros(n_cap, np.int64)
        batch = np.zeros(n_cap, np.int64)
        node_mask = np.zeros(n_cap, np.uint8)
        rows = np.zeros(e_cap, np.int64)
        cols = np.zeros(e_cap, np.int64)
        eids = np.zeros(e_cap, np.int64)
        emask = np.zeros(e_cap, np.uint8)
        nsn = np.zeros(H + 1, np.int64)
        nse = np.zeros(H, np.int64)

        def p64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        def pu8(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

        def pf64(a):
            if a is None:
                return ctypes.POINTER(ctypes.c_double)()
            a = np.ascontiguousarray(a, np.float64)
            _keep.append(a)
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

        _keep = []
        lib.neighbor_sample_tw(
            p64(colptr), p64(row), p64(eid),
            ctypes.c_int64(self.num_nodes),
            p64(seeds_c), ctypes.c_int64(len(seeds_c)),
            pf64(seed_time),
            p64(fanouts), ctypes.c_int64(H),
            p64(ecaps), ctypes.c_int64(n_cap), ctypes.c_int64(e_cap),
            ctypes.c_int(int(self.replace)),
            ctypes.c_int(int(self.disjoint)),
            ctypes.c_int(1 if self.temporal_strategy == 'last' else 0),
            pf64(self.node_time), pf64(self.edge_time),
            pf64(self.edge_weight),
            ctypes.c_uint64(int(rng.integers(0, 2 ** 62))),
            p64(node), p64(batch), pu8(node_mask),
            p64(rows), p64(cols), p64(eids), pu8(emask),
            p64(nsn), p64(nse))
        return SamplerOutput(
            node=node, row=rows, col=cols, edge=eids,
            node_mask=node_mask.astype(bool),
            edge_mask=emask.astype(bool),
            num_sampled_nodes=[int(v) for v in nsn],
            num_sampled_edges=[int(v) for v in nse],
            batch_size=len(seeds),
            batch=batch if self.disjoint else None)

    def _sample_tw_python(self, seeds: np.ndarray, bs: int,
                          seed_time: Optional[np.ndarray], rng=None):
        """numpy mirror of ``neighbor_sample_tw`` (same semantics)."""
        rng = rng if rng is not None else self.rng
        node_caps = self.num_neighbors.node_budget(bs)
        edge_caps = self.num_neighbors.edge_budget(bs)
        n_cap, e_cap = sum(node_caps), sum(edge_caps)
        temporal = self.is_temporal
        key_of = ((lambda g, b: b * self.num_nodes + g)
                  if self.disjoint else (lambda g, b: g))

        local = {}
        nodes, batches = [], []
        for i, s in enumerate(seeds):
            k = key_of(int(s), i)
            if k not in local:
                local[k] = len(nodes)
                nodes.append(int(s))
                batches.append(i if self.disjoint else 0)
        nsn = [len(nodes)]
        nse = []
        rows = np.full(e_cap, n_cap, np.int64)
        cols = np.full(e_cap, n_cap, np.int64)
        eids = np.zeros(e_cap, np.int64)
        emask = np.zeros(e_cap, bool)

        frontier = [(nodes[i], batches[i]) for i in range(len(nodes))]
        e_cursor = 0
        for hop, fanout in enumerate(self.num_neighbors.values):
            next_frontier = []
            new_nodes = hop_edges = 0
            base = e_cursor
            for v, b in frontier:
                dst_local = local[key_of(v, b)]
                lo, hi = self.csc.colptr[v], self.csc.colptr[v + 1]
                cand = np.arange(lo, hi)
                if temporal:
                    t_max = (seed_time[b] if seed_time is not None
                             else self.node_time[v])
                    t = (self.node_time[self.csc.row[cand]]
                         if self.node_time is not None
                         else self.edge_time[self.csc.eid[cand]])
                    cand = cand[t <= t_max]
                deg = len(cand)
                if deg == 0:
                    continue
                if temporal and self.temporal_strategy == 'last':
                    t = (self.node_time[self.csc.row[cand]]
                         if self.node_time is not None
                         else self.edge_time[self.csc.eid[cand]])
                    pick = cand[np.argsort(-t, kind='stable')[:fanout]]
                elif self.edge_weight is not None:
                    w = self.edge_weight[self.csc.eid[cand]]
                    if self.replace:
                        if w.sum() <= 0:
                            continue
                        pick = rng.choice(cand, fanout,
                                               p=w / w.sum())
                    elif deg <= fanout:
                        pick = cand
                    else:
                        ok = w > 0
                        keys = np.full(deg, -np.inf)
                        keys[ok] = (np.log(rng.random(ok.sum()))
                                    / w[ok])
                        pick = cand[np.argsort(-keys)[:min(
                            fanout, int(ok.sum()))]]
                elif deg <= fanout and not self.replace:
                    pick = cand
                elif self.replace:
                    pick = cand[rng.integers(0, deg, fanout)]
                else:
                    pick = rng.choice(cand, fanout, replace=False)
                for pos in pick:
                    g = int(self.csc.row[pos])
                    k = key_of(g, b)
                    if len(nodes) >= n_cap and k not in local:
                        continue
                    if k not in local:
                        local[k] = len(nodes)
                        nodes.append(g)
                        batches.append(b if self.disjoint else 0)
                        next_frontier.append((g, b))
                        new_nodes += 1
                    slot = base + hop_edges
                    if slot >= e_cap:
                        continue
                    rows[slot] = local[k]
                    cols[slot] = dst_local
                    eids[slot] = self.csc.eid[pos]
                    emask[slot] = True
                    hop_edges += 1
            nsn.append(new_nodes)
            nse.append(hop_edges)
            e_cursor += edge_caps[hop]
            frontier = next_frontier

        node = np.zeros(n_cap, np.int64)
        node[:len(nodes)] = nodes
        batch = np.zeros(n_cap, np.int64)
        batch[:len(batches)] = batches
        node_mask = np.arange(n_cap) < len(nodes)
        return SamplerOutput(
            node=node, row=rows, col=cols, edge=eids,
            node_mask=node_mask, edge_mask=emask,
            num_sampled_nodes=nsn, num_sampled_edges=nse,
            batch_size=len(seeds),
            batch=batch if self.disjoint else None)

    def sample_from_nodes(self, inputs: NodeSamplerInput,
                          rng_seed: Optional[int] = None
                          ) -> SamplerOutput:
        """``rng_seed``: per-call RNG override so concurrent callers
        (threaded loaders) sample deterministically without sharing the
        mutable ``self.rng``."""
        rng = (np.random.default_rng(rng_seed) if rng_seed is not None
               else self.rng)
        seeds = np.asarray(inputs.node, np.int64)
        bs = self.batch_size or len(seeds)
        native = csrc.WITH_NATIVE_SAMPLER
        needs_tw = (self.disjoint or self.is_temporal
                    or self.edge_weight is not None)
        if needs_tw:
            seed_time = self._seed_time(inputs, seeds)
            if native:
                return self._sample_native_tw(seeds, bs, seed_time,
                                              rng=rng)
            return self._sample_tw_python(seeds, bs, seed_time, rng=rng)
        if native:
            return self._sample_native(seeds, bs, rng=rng)
        node_caps = self.num_neighbors.node_budget(bs)
        edge_caps = self.num_neighbors.edge_budget(bs)
        n_cap = sum(node_caps)
        e_cap = sum(edge_caps)

        # first-occurrence global->local map, seeds first
        local = {}
        node_list = []
        for s in seeds:
            if int(s) not in local:
                local[int(s)] = len(node_list)
                node_list.append(int(s))
        num_sampled_nodes = [len(node_list)]
        num_sampled_edges = []

        rows = np.full(e_cap, n_cap, np.int64)    # local src (dump=n_cap)
        cols = np.full(e_cap, n_cap, np.int64)    # local dst
        eids = np.zeros(e_cap, np.int64)
        edge_mask = np.zeros(e_cap, bool)

        frontier = np.array(node_list, np.int64)
        e_cursor = 0
        for hop, fanout in enumerate(self.num_neighbors.values):
            if len(frontier) == 0:
                num_sampled_nodes.append(0)
                num_sampled_edges.append(0)
                e_cursor += edge_caps[hop]
                continue
            src, eid, valid = _sample_neighbors(
                self.csc, frontier, fanout, rng, self.replace)
            dst_local = np.repeat(
                [local[int(v)] for v in frontier], fanout)
            new_nodes = 0
            hop_edges = 0
            base = e_cursor
            next_frontier = []
            for i in range(len(src)):
                if not valid[i]:
                    continue
                g = int(src[i])
                if g not in local:
                    local[g] = len(node_list)
                    node_list.append(g)
                    next_frontier.append(g)
                    new_nodes += 1
                slot = base + hop_edges
                rows[slot] = local[g]
                cols[slot] = dst_local[i]
                eids[slot] = eid[i]
                edge_mask[slot] = True
                hop_edges += 1
            num_sampled_nodes.append(new_nodes)
            num_sampled_edges.append(hop_edges)
            e_cursor += edge_caps[hop]
            frontier = np.array(next_frontier, np.int64)

        node = np.zeros(n_cap, np.int64)
        node[:len(node_list)] = node_list
        node_mask = np.arange(n_cap) < len(node_list)
        return SamplerOutput(
            node=node, row=rows, col=cols, edge=eids,
            node_mask=node_mask, edge_mask=edge_mask,
            num_sampled_nodes=num_sampled_nodes,
            num_sampled_edges=num_sampled_edges,
            batch_size=len(seeds))

    def sample_from_edges(self, inputs: EdgeSamplerInput,
                          neg_sampling: Optional[NegativeSampling] = None
                          ) -> SamplerOutput:
        """Link sampling (reference ``neighbor_sampler.py`` edge path +
        ``base.py:849``): seeds = src+dst (+ sampled negatives).

        binary  -> metadata {edge_label, edge_label_index}
        triplet -> metadata {src_index, dst_pos_index, dst_neg_index}
        """
        row = np.asarray(inputs.row, np.int64)
        col = np.asarray(inputs.col, np.int64)
        k = len(row)
        triplet = neg_sampling is not None and neg_sampling.is_triplet()
        neg = 0
        if neg_sampling is not None:
            neg = int(math.ceil(k * neg_sampling.amount))
        if triplet:
            # per-source negative destinations only (reference
            # base.py:879: triplet draws dst negatives per input edge)
            neg_row = np.zeros(0, np.int64)
            neg_col = self.rng.integers(0, self.num_nodes, neg)
        else:
            neg_row = self.rng.integers(0, self.num_nodes, neg)
            neg_col = self.rng.integers(0, self.num_nodes, neg)
        seeds = np.concatenate([row, col, neg_row, neg_col])
        time = None
        if inputs.time is not None:
            t = np.asarray(inputs.time, np.float64)
            reps = [t, t]
            if len(neg_row):
                reps.append(np.resize(t, len(neg_row)))
            if len(neg_col):
                reps.append(np.resize(t, len(neg_col)))
            time = np.concatenate(reps)
        self_bs, self.batch_size = self.batch_size, len(seeds)
        try:
            out = self.sample_from_nodes(
                NodeSamplerInput(node=seeds, time=time))
        finally:
            self.batch_size = self_bs

        # vectorized first-occurrence localization (replaces the
        # per-batch python dict): seeds-first prefix of out.node holds
        # each seed's local id; disjoint mode is positional by design
        if self.disjoint:
            pos = np.arange(len(seeds), dtype=np.int64)
            src_loc = pos[:k]
            dst_loc = pos[k:2 * k]
            nr_loc = pos[2 * k:2 * k + len(neg_row)]
            nc_loc = pos[2 * k + len(neg_row):]
        else:
            prefix = out.node[:out.num_sampled_nodes[0]]
            order = np.argsort(prefix, kind='stable')
            sorted_prefix = prefix[order]

            def loc(q):
                if len(q) == 0:
                    return np.zeros(0, np.int64)
                p = np.searchsorted(sorted_prefix, q)
                return order[np.minimum(p, len(order) - 1)]

            src_loc, dst_loc = loc(row), loc(col)
            nr_loc, nc_loc = loc(neg_row), loc(neg_col)

        if triplet:
            out.metadata = {'src_index': src_loc,
                            'dst_pos_index': dst_loc,
                            'dst_neg_index': nc_loc}
        else:
            label = np.concatenate([
                (np.asarray(inputs.label) if inputs.label is not None
                 else np.ones(k, np.float32)),
                np.zeros(neg, np.float32)])
            src_idx = np.concatenate([src_loc, nr_loc])
            dst_idx = np.concatenate([dst_loc, nc_loc])
            out.metadata = {'edge_label': label,
                            'edge_label_index': np.stack([src_idx,
                                                          dst_idx])}
        return out


class BidirectionalNeighborSampler(NeighborSampler):
    """Samples over the union of in- and out-edges
    (reference ``neighbor_sampler.py:620``): the CSC is built on
    A + A^T so hops traverse both directions."""

    def __init__(self, data, num_neighbors, **kwargs):
        coo = host(data.edge_index)
        both = np.concatenate([coo, coo[::-1]], 1)
        both = np.unique(both, axis=1)
        d2 = data.replace(edge_index=both) if hasattr(data, 'replace') \
            else type(data)(x=data.x, edge_index=both)
        super().__init__(d2, num_neighbors, **kwargs)
