"""Heterogeneous neighbour sampling.

Counterpart of ``pytorch_geometric_tpu/sampler/hetero.py`` (reference
``torch_geometric/sampler/neighbor_sampler.py:471``'s hetero path and
``hgt_sampler.py:23``): a CSC per edge type; every hop, each edge type
samples its fanout from the current frontier of its destination type. The
outputs are per-type padded arrays with static budgets. The native path is
the port's build of ``hetero_neighbor_sample`` (``csrc/sampler.cpp``), with
the numpy version kept for hosts without ``g++``; both draw from the
sampler's generator exactly as the JAX package's do, so one seed gives its
batches bit for bit on each path.
"""

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import csrc
from ..data.data import host
from .base import NodeSamplerInput
from .neighbor_sampler import _CSC, _sample_neighbors

EdgeType = Tuple[str, str, str]


@dataclass
class HeteroSamplerOutput:
    """(reference ``sampler/base.py:504``): padded per-type arrays; ``row``
    / ``col`` are local ids, ``-1`` in padded slots."""
    node: Dict[str, np.ndarray]
    node_mask: Dict[str, np.ndarray]
    row: Dict[EdgeType, np.ndarray]
    col: Dict[EdgeType, np.ndarray]
    edge: Dict[EdgeType, np.ndarray]
    edge_mask: Dict[EdgeType, np.ndarray]
    num_sampled_nodes: Dict[str, List[int]]
    num_sampled_edges: Dict[EdgeType, List[int]]
    batch_size: int
    input_type: str


class HeteroNeighborSampler:
    """(reference ``neighbor_sampler.py``'s hetero ``_sample``)."""

    def __init__(self, data, num_neighbors: Sequence[int],
                 replace: bool = False, seed: int = 0):
        self.node_types, self.edge_types = data.metadata()
        self.num_nodes = {t: data[t].num_nodes for t in self.node_types}
        self.cscs: Dict[EdgeType, _CSC] = {
            et: _CSC(host(data[et].edge_index), self.num_nodes[et[2]])
            for et in self.edge_types}
        self.fanouts = list(num_neighbors)
        self.replace = replace
        self.rng = np.random.default_rng(seed)
        self.batch_size: Optional[int] = None
        # C-ABI-ready views of every CSC, converted once at the first
        # native batch
        self._cscs_c = None

    def _budgets(self, input_type: str, bs: int):
        """Static per-type node / per-edge-type per-hop budgets."""
        H = len(self.fanouts)
        cap = {t: [0] * (H + 1) for t in self.node_types}
        cap[input_type][0] = bs
        ecap = {et: [0] * H for et in self.edge_types}
        for h in range(H):
            f = self.fanouts[h]
            for (src, rel, dst) in self.edge_types:
                ecap[(src, rel, dst)][h] = cap[dst][h] * f
            new_cap = {t: 0 for t in self.node_types}
            for (src, rel, dst) in self.edge_types:
                new_cap[src] += cap[dst][h] * f
            for t in self.node_types:
                cap[t][h + 1] = new_cap[t]
        return cap, ecap

    def _sample_native(self, input_type: str, seeds: np.ndarray,
                       bs: int) -> Optional[HeteroSamplerOutput]:
        """The C++ path (``csrc/sampler.cpp::hetero_neighbor_sample``)."""
        lib = csrc.sampler_library()
        if lib is None:
            return None
        H = len(self.fanouts)
        cap, ecap = self._budgets(input_type, bs)
        T, R = len(self.node_types), len(self.edge_types)
        tix = {t: i for i, t in enumerate(self.node_types)}
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)

        def pp(arrs, ty):
            return (ty * len(arrs))(*[a.ctypes.data_as(ty) for a in arrs])

        if self._cscs_c is None:
            self._cscs_c = tuple(
                [np.ascontiguousarray(getattr(self.cscs[et], k), np.int64)
                 for et in self.edge_types] for k in ('colptr', 'row', 'eid'))
        colptrs, rows, eids = self._cscs_c
        src_t = np.asarray([tix[et[0]] for et in self.edge_types], np.int64)
        dst_t = np.asarray([tix[et[2]] for et in self.edge_types], np.int64)
        n_caps = np.asarray([max(sum(cap[t]), 1) for t in self.node_types],
                            np.int64)
        ecap_flat = np.asarray([ecap[et][h] for et in self.edge_types
                                for h in range(H)], np.int64)
        e_caps = [max(int(ecap_flat[r * H:(r + 1) * H].sum()), 1)
                  for r in range(R)]

        node_bufs = [np.zeros(int(n), np.int64) for n in n_caps]
        nmask_bufs = [np.zeros(int(n), np.uint8) for n in n_caps]
        row_bufs = [np.full(e, -1, np.int64) for e in e_caps]
        col_bufs = [np.full(e, -1, np.int64) for e in e_caps]
        eid_bufs = [np.zeros(e, np.int64) for e in e_caps]
        emask_bufs = [np.zeros(e, np.uint8) for e in e_caps]
        nsn = np.zeros(T * (H + 1), np.int64)
        nse = np.zeros(R * H, np.int64)
        seeds = np.ascontiguousarray(seeds, np.int64)
        fan = np.asarray(self.fanouts, np.int64)

        lib.hetero_neighbor_sample(
            T, R, pp(colptrs, i64p), pp(rows, i64p), pp(eids, i64p),
            src_t.ctypes.data_as(i64p), dst_t.ctypes.data_as(i64p),
            tix[input_type], seeds.ctypes.data_as(i64p), len(seeds),
            fan.ctypes.data_as(i64p), H,
            n_caps.ctypes.data_as(i64p), ecap_flat.ctypes.data_as(i64p),
            int(self.replace), int(self.rng.integers(2 ** 62)),
            pp(node_bufs, i64p), pp(nmask_bufs, u8p),
            pp(row_bufs, i64p), pp(col_bufs, i64p), pp(eid_bufs, i64p),
            pp(emask_bufs, u8p),
            nsn.ctypes.data_as(i64p), nse.ctypes.data_as(i64p))

        return HeteroSamplerOutput(
            node={t: node_bufs[i] for i, t in enumerate(self.node_types)},
            node_mask={t: nmask_bufs[i].astype(bool)
                       for i, t in enumerate(self.node_types)},
            row={et: row_bufs[r] for r, et in enumerate(self.edge_types)},
            col={et: col_bufs[r] for r, et in enumerate(self.edge_types)},
            edge={et: eid_bufs[r] for r, et in enumerate(self.edge_types)},
            edge_mask={et: emask_bufs[r].astype(bool)
                       for r, et in enumerate(self.edge_types)},
            num_sampled_nodes={
                t: nsn[tix[t] * (H + 1):(tix[t] + 1) * (H + 1)].tolist()
                for t in self.node_types},
            num_sampled_edges={
                et: nse[r * H:(r + 1) * H].tolist()
                for r, et in enumerate(self.edge_types)},
            batch_size=len(seeds), input_type=input_type)

    def sample_from_nodes(self, input_type: str,
                          inputs: NodeSamplerInput) -> HeteroSamplerOutput:
        seeds = np.asarray(inputs.node, np.int64)
        bs = self.batch_size or len(seeds)
        if csrc.WITH_NATIVE_SAMPLER:
            out = self._sample_native(input_type, seeds, bs)
            if out is not None:
                return out
        H = len(self.fanouts)
        cap, ecap = self._budgets(input_type, bs)

        # vectorised global->local relabel tables (one per node type; the
        # numpy analogue of the reference's CPU hash maps)
        local: Dict[str, np.ndarray] = {
            t: np.full(self.num_nodes[t] + 1, -1, np.int64)
            for t in self.node_types}
        nodes: Dict[str, List[np.ndarray]] = {t: [] for t in self.node_types}
        counts: Dict[str, int] = {t: 0 for t in self.node_types}
        nsn: Dict[str, List[int]] = {t: [] for t in self.node_types}

        def add_new(t: str, cand: np.ndarray) -> np.ndarray:
            """Register unseen ids (first-occurrence order); returns the
            newly added ids."""
            unknown = local[t][cand] < 0
            g = cand[unknown]
            if len(g):
                uniq, first = np.unique(g, return_index=True)
                uniq = uniq[np.argsort(first)]
                local[t][uniq] = counts[t] + np.arange(len(uniq))
                counts[t] += len(uniq)
                nodes[t].append(uniq)
                return uniq
            return g

        add_new(input_type, seeds)
        for t in self.node_types:
            nsn[t] = [counts[t]]

        total_ecap = {et: sum(ecap[et]) for et in self.edge_types}
        rows = {et: np.full(max(total_ecap[et], 1), -1, np.int64)
                for et in self.edge_types}
        cols = {et: np.full(max(total_ecap[et], 1), -1, np.int64)
                for et in self.edge_types}
        eids = {et: np.zeros(max(total_ecap[et], 1), np.int64)
                for et in self.edge_types}
        emask = {et: np.zeros(max(total_ecap[et], 1), bool)
                 for et in self.edge_types}
        nse = {et: [] for et in self.edge_types}
        cursor = {et: 0 for et in self.edge_types}

        frontier: Dict[str, np.ndarray] = {
            t: (np.concatenate(nodes[t]) if nodes[t]
                else np.zeros(0, np.int64)) for t in self.node_types}
        for h in range(H):
            f = self.fanouts[h]
            new_frontier: Dict[str, List[np.ndarray]] = {
                t: [] for t in self.node_types}
            new_counts = {t: 0 for t in self.node_types}
            for et in self.edge_types:
                src_t, _, dst_t = et
                fr = frontier[dst_t]
                hop_edges = 0
                base = cursor[et]
                if len(fr):
                    srcs, eid, valid = _sample_neighbors(
                        self.cscs[et], fr, f, self.rng, self.replace)
                    dst_local = np.repeat(local[dst_t][fr], f)
                    g = srcs[valid]
                    fresh = add_new(src_t, g)
                    if len(fresh):
                        new_frontier[src_t].append(fresh)
                        new_counts[src_t] += len(fresh)
                    hop_edges = len(g)
                    sl = slice(base, base + hop_edges)
                    rows[et][sl] = local[src_t][g]
                    cols[et][sl] = dst_local[valid]
                    eids[et][sl] = eid[valid]
                    emask[et][sl] = True
                nse[et].append(hop_edges)
                cursor[et] += ecap[et][h]
            for t in self.node_types:
                nsn[t].append(new_counts[t])
            frontier = {
                t: (np.concatenate(new_frontier[t])
                    if new_frontier[t] else np.zeros(0, np.int64))
                for t in self.node_types}

        node_out, node_mask = {}, {}
        for t in self.node_types:
            n_cap = max(sum(cap[t]), 1)
            arr = np.zeros(n_cap, np.int64)
            flat = (np.concatenate(nodes[t]) if nodes[t]
                    else np.zeros(0, np.int64))
            arr[:len(flat)] = flat
            node_out[t] = arr
            node_mask[t] = np.arange(n_cap) < len(flat)
        return HeteroSamplerOutput(
            node=node_out, node_mask=node_mask, row=rows, col=cols,
            edge=eids, edge_mask=emask, num_sampled_nodes=nsn,
            num_sampled_edges=nse, batch_size=len(seeds),
            input_type=input_type)


class HGTSampler(HeteroNeighborSampler):
    """Typed-budget sampling (reference ``hgt_sampler.py:23``). As in the
    JAX package, the per-hop budget is the fanout of every incoming edge
    type (the reference splits one budget per node type)."""

    def __init__(self, data, num_samples: Sequence[int], **kw):
        super().__init__(data, num_samples, **kw)
