"""NeighborLoader / LinkNeighborLoader.

Counterpart of ``pytorch_geometric_tpu/loader/neighbor_loader.py``
(reference ``torch_geometric/loader/node_loader.py:30`` +
``neighbor_loader.py:10`` + ``link_neighbor_loader.py:10``). The loader
iterates seed batches, invokes the host sampler and joins features
(``filter_fn``, reference ``node_loader.py:154``) into a fixed-shape padded
``Data`` ready for one captured step: ``n_id``/``e_id`` bookkeeping,
seeds-first ordering, validity masks. The batches are the JAX package's,
field for field and dtype for dtype, as host tensors; a joined feature table
is gathered where it lies (on the card for a table on the card).
"""

from typing import Optional, Sequence

import numpy as np
import torch

from ..data.data import Data, host
from ..sampler import (NeighborSampler, NodeSamplerInput, EdgeSamplerInput,
                       NegativeSampling, SamplerOutput)


def _rows(table: torch.Tensor, idx: np.ndarray,
          mask: Optional[np.ndarray] = None) -> torch.Tensor:
    """``table``'s rows at ``idx`` on ``table``'s device, the rows where
    ``mask`` is False zeroed."""
    out = table[torch.from_numpy(idx).to(table.device)]
    if mask is not None:
        out[torch.from_numpy(~mask).to(table.device)] = 0
    return out


def _filter(data: Data, out: SamplerOutput,
            features: bool = True) -> Data:
    """Feature join (reference ``loader/utils.py:filter_data``).

    ``features=False`` skips the x/y/edge_attr gathers: the pattern for a
    feature table kept on the card, gathered by ``batch.n_id`` inside the
    captured step (see NeighborLoader ``filter_features``)."""
    n_cap = out.num_nodes_cap
    safe_nodes = np.where(out.node_mask, out.node, 0)
    kwargs = {}
    # ship ids as int32 when they fit: n_id/e_id cross to the card every
    # batch. The decision comes from the static graph size (not batch
    # content) so every batch has the same dtype: a per-batch flip would
    # be another shape for the captured step
    n32 = data.num_nodes < 2**31
    e32 = data.num_edges < 2**31

    def _nid(a, fits):
        return a.astype(np.int32) if fits else a
    if not features:
        coo = np.stack([out.row, out.col]).astype(np.int32)
        new = Data(edge_index=coo, num_nodes=n_cap)
        return new.replace(
            n_id=_nid(out.node, n32), e_id=_nid(out.edge, e32),
            node_mask=out.node_mask, edge_mask=out.edge_mask,
            batch_size=np.asarray(out.batch_size),
            num_sampled_nodes=np.asarray(out.num_sampled_nodes),
            num_sampled_edges=np.asarray(out.num_sampled_edges))
    if data.x is not None:
        kwargs['x'] = _rows(data.x, safe_nodes, out.node_mask)
    if data.y is not None and data.y.shape[0] == data.num_nodes:
        kwargs['y'] = _rows(data.y, safe_nodes)
    if data.edge_attr is not None:
        kwargs['edge_attr'] = _rows(
            data.edge_attr, np.where(out.edge_mask, out.edge, 0),
            out.edge_mask)
    coo = np.stack([out.row, out.col]).astype(np.int32)
    new = Data(edge_index=coo, num_nodes=n_cap, **kwargs)
    return new.replace(
        n_id=_nid(out.node, n32), e_id=_nid(out.edge, e32),
        node_mask=out.node_mask, edge_mask=out.edge_mask,
        batch_size=np.asarray(out.batch_size),
        num_sampled_nodes=np.asarray(out.num_sampled_nodes),
        num_sampled_edges=np.asarray(out.num_sampled_edges),
    )


class NeighborLoader:
    """(reference ``loader/neighbor_loader.py:10``)."""

    def __init__(self, data: Data, num_neighbors: Sequence[int],
                 input_nodes: Optional[np.ndarray] = None,
                 input_time: Optional[np.ndarray] = None,
                 batch_size: int = 1, shuffle: bool = False,
                 replace: bool = False, disjoint: bool = False,
                 temporal_strategy: str = 'uniform',
                 time_attr: Optional[str] = None,
                 weight_attr: Optional[str] = None,
                 drop_last: bool = False, seed: int = 0,
                 num_workers: int = 0, filter_features: bool = True):
        self.data = data
        self.sampler = NeighborSampler(
            data, num_neighbors, replace=replace, disjoint=disjoint,
            temporal_strategy=temporal_strategy, time_attr=time_attr,
            weight_attr=weight_attr, seed=seed)
        self.input_time = (np.asarray(input_time, np.float64)
                           if input_time is not None else None)
        if input_nodes is None:
            input_nodes = np.arange(data.num_nodes)
        input_nodes = host(input_nodes)
        if input_nodes.dtype == bool:
            input_nodes = np.nonzero(input_nodes)[0]
        self.input_nodes = np.asarray(input_nodes, np.int64)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        # sampling across batches is embarrassingly parallel (the C++
        # sampler releases the GIL): num_workers > 0 fans batch
        # sampling out over a thread pool with per-batch seeds, keeping
        # results deterministic and ordered, in place of the reference's
        # DataLoader worker processes
        self.num_workers = num_workers
        # filter_features=False: yield structure only (n_id/e_id/masks)
        # and gather the features on the card inside the captured step:
        # a host feature join of wide rows dominates the batch time
        self.filter_features = filter_features
        # fixed seed count per batch -> static budgets across batches
        self.sampler.batch_size = batch_size

    def __len__(self):
        n = len(self.input_nodes)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        """(idx, real_batch_size, rng_seed) per batch, host-side."""
        order = (self.rng.permutation(len(self.input_nodes))
                 if self.shuffle else np.arange(len(self.input_nodes)))
        out = []
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if len(idx) < self.batch_size:
                if self.drop_last:
                    break
                # repeat-pad the seed set; batch_size records real count
                idx = np.concatenate([
                    idx, np.zeros(self.batch_size - len(idx), np.int64)])
            out.append((idx, min(self.batch_size, len(order) - i),
                        int(self.rng.integers(0, 2 ** 62))))
        return out

    def _one(self, idx, real_bs, rng_seed):
        seeds = self.input_nodes[idx]
        out = self.sampler.sample_from_nodes(
            NodeSamplerInput(node=seeds, input_id=idx),
            rng_seed=rng_seed)
        out = SamplerOutput(**{**out.__dict__, 'batch_size': real_bs})
        return _filter(self.data, out, features=self.filter_features)

    def __iter__(self):
        batches = self._batches()
        if self.num_workers > 0:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor
            # bounded in-flight window (num_workers + 2): Executor.map
            # would submit the WHOLE epoch upfront and let finished
            # batches pile up faster than the consumer drains them
            # no `with`: a consumer that abandons the generator would
            # otherwise run the executor's __exit__ during GC/shutdown
            pool = ThreadPoolExecutor(self.num_workers)
            inflight = deque()
            it = iter(batches)
            try:
                for b in it:
                    inflight.append(pool.submit(self._one, *b))
                    if len(inflight) >= self.num_workers + 2:
                        break
                while inflight:
                    out = inflight.popleft().result()
                    nxt = next(it, None)
                    if nxt is not None:
                        inflight.append(pool.submit(self._one, *nxt))
                    yield out
            finally:
                try:
                    pool.shutdown(wait=False, cancel_futures=True)
                except Exception:
                    # abandoned generator finalized at interpreter
                    # shutdown: modules may already be torn down
                    pass
            return
        for b in batches:
            yield self._one(*b)


class LinkNeighborLoader:
    """(reference ``loader/link_neighbor_loader.py:10``)."""

    def __init__(self, data: Data, num_neighbors: Sequence[int],
                 edge_label_index: Optional[np.ndarray] = None,
                 edge_label: Optional[np.ndarray] = None,
                 neg_sampling_ratio: float = 0.0,
                 batch_size: int = 1, shuffle: bool = False,
                 seed: int = 0):
        self.data = data
        self.sampler = NeighborSampler(data, num_neighbors, seed=seed)
        if edge_label_index is None:
            edge_label_index = data.edge_index
        self.eli = host(edge_label_index).astype(np.int64)
        self.edge_label = edge_label
        self.neg = (NegativeSampling('binary', neg_sampling_ratio)
                    if neg_sampling_ratio > 0 else None)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return (self.eli.shape[1] + self.batch_size - 1) \
            // self.batch_size

    def __iter__(self):
        m = self.eli.shape[1]
        order = (self.rng.permutation(m) if self.shuffle
                 else np.arange(m))
        for i in range(0, m, self.batch_size):
            idx = order[i:i + self.batch_size]
            if len(idx) < self.batch_size:
                idx = np.concatenate([
                    idx, order[:self.batch_size - len(idx)]])
            label = (host(self.edge_label)[idx]
                     if self.edge_label is not None else None)
            out = self.sampler.sample_from_edges(
                EdgeSamplerInput(row=self.eli[0, idx],
                                 col=self.eli[1, idx], label=label,
                                 input_id=idx),
                neg_sampling=self.neg)
            d = _filter(self.data, out)
            yield d.replace(
                edge_label=out.metadata['edge_label'],
                edge_label_index=out.metadata['edge_label_index'])
