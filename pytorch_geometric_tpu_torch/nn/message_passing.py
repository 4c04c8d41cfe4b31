"""MessagePassing: the operator substrate.

Counterpart of ``pytorch_geometric_tpu/nn/message_passing.py`` as an
``nn.Module``. Semantics kept from it:

  * ``flow='source_to_target'``: messages flow along edge_index[0] -> [1];
    gather suffix ``_j`` = source endpoint, ``_i`` = target endpoint.
  * ``message`` default: identity on ``x_j``; ``update`` default: identity.
  * ``aggregate``: segment reduce by destination with a static
    ``dim_size``.
  * ``aggregate`` also takes an ``Aggregation`` module (``nn/aggr``) or a
    list of reductions, whose outputs are concatenated.
  * ``message_and_aggregate`` fusion: if the subclass implements it and is
    handed an ``EdgeIndex`` with no ``edge_mask``, and ``aggr`` is one of
    sum / mean / min / max, the SpMM path is taken.
  * ``edge_updater`` / ``edge_update`` for edge-level passes.
  * under ``experimental.debug()``, ``propagate`` and ``edge_updater``
    check that ``edge_index`` lies in ``[0, n]`` (``n`` is the padding
    sentinel) and raise ``IndexError`` otherwise.

Padding: edges whose endpoints are ``>= num_nodes`` are dropped by the
segment ops; an explicit ``edge_mask`` also zeroes messages.
"""

import inspect
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..edge_index import EdgeIndex
from ..ops import scatter, softmax


def _endpoints(edge_index, flow: str) -> Tuple[torch.Tensor, torch.Tensor]:
    coo = edge_index.coo if isinstance(edge_index, EdgeIndex) else edge_index
    if flow == 'source_to_target':
        return coo[0], coo[1]  # j (gather), i (aggregate)
    return coo[1], coo[0]


def _debug_check_bounds(j_idx, i_idx, num_src: int, num_dst: int) -> None:
    """Under ``experimental.debug()``, raise ``IndexError`` for an endpoint
    below 0 or past the padding sentinel ``n`` (JAX
    ``message_passing.py:45-78``). The gathers clamp indices for padding,
    so a corrupt ``edge_index`` would otherwise be aggregated into the last
    row silently. It reads the indices' extremes back to the host, so it
    is off by default."""
    from ..experimental import is_debug_enabled
    if not is_debug_enabled():
        return
    for idx, n, which in ((j_idx, num_src, 'source'),
                          (i_idx, num_dst, 'destination')):
        if idx.numel() == 0:
            continue
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0:
            raise IndexError(
                f"Found negative {which} indices in 'edge_index' (got "
                f"{lo}). Please ensure that all indices point to valid "
                f"node indices in the interval [0, {n}) (index == {n} "
                f"is reserved for padding) and try again.")
        if hi > n:
            raise IndexError(
                f"Found {which} indices in 'edge_index' that are larger "
                f"than {n} (got {hi}). Please ensure that all indices "
                f"point to valid node indices in the interval [0, {n}) "
                f"(index == {n} is reserved for padding) and try again.")


def _pair(x) -> Tuple[Any, Any]:
    if isinstance(x, tuple):
        return x
    return (x, x)


class MessagePassing(nn.Module):
    """Base class for the graph convolutions.

    Subclasses set ``self.aggr`` (a reduction's name, a list of them, or
    an ``Aggregation`` module) and ``self.flow`` as needed (defaults 'sum'
    / 'source_to_target') and override any of ``message`` / ``aggregate``
    / ``message_and_aggregate`` / ``update`` / ``edge_update``.
    """

    flow: str = 'source_to_target'

    def __init__(self):
        super().__init__()
        # an instance attribute, not a class one: a class attribute would
        # shadow an Aggregation module registered under the same name
        self.aggr = 'sum'

    def _aggr(self):
        if isinstance(self.aggr, str):
            return {'add': 'sum'}.get(self.aggr, self.aggr)
        return self.aggr

    # -- overridable stages -------------------------------------------------
    def message(self, x_j, **kwargs):
        return x_j

    def aggregate(self, inputs: torch.Tensor, index: torch.Tensor,
                  dim_size: int, edge_mask=None) -> torch.Tensor:
        aggr = self._aggr()
        if isinstance(aggr, (list, tuple)):
            return torch.cat([scatter(inputs, index, dim_size, reduce=a,
                                      mask=edge_mask) for a in aggr], -1)
        if not isinstance(aggr, str):
            return aggr(inputs, index, dim_size, mask=edge_mask)
        return scatter(inputs, index, dim_size, reduce=aggr, mask=edge_mask)

    def update(self, inputs, **kwargs):
        return inputs

    # message_and_aggregate and edge_update are absent by default; their
    # presence on a subclass enables the fused SpMM path and edge_updater.

    # -- propagation --------------------------------------------------------
    def propagate(self, edge_index, size: Optional[Tuple[int, int]] = None,
                  edge_mask: Optional[torch.Tensor] = None,
                  **kwargs) -> torch.Tensor:
        """Run gather -> message -> aggregate -> update.

        Args:
            edge_index: ``EdgeIndex`` or raw ``[2, E]`` int tensor.
            size: static ``(num_src, num_dst)``; required when
                ``edge_index`` is a raw tensor and ``x`` is absent.
            edge_mask: optional bool ``[E]`` (padding/dropout).
            **kwargs: node tensors (gathered per edge with ``_j``/``_i``
                suffixes in ``message``), edge tensors (passed through),
                e.g. ``x=x`` or ``x=(x_src, x_dst)``, ``edge_weight=w``.
        """
        num_src, num_dst = self._infer_size(edge_index, size, kwargs)
        j_idx, i_idx = _endpoints(edge_index, self.flow)
        _debug_check_bounds(j_idx, i_idx, num_src, num_dst)

        # Fused SpMM path. edge_mask is not threaded through
        # message_and_aggregate (padding lives in the EdgeIndex's sentinel
        # endpoints there), so an explicit mask takes the gather path.
        if (hasattr(self, 'message_and_aggregate') and edge_mask is None
                and isinstance(edge_index, EdgeIndex)
                and isinstance(self._aggr(), str)
                and self._aggr() in ('sum', 'mean', 'min', 'max')):
            out = self.message_and_aggregate(edge_index, **kwargs)
            if out is not NotImplemented:
                return self._run_update(out, kwargs)

        msg_kwargs = self._collect(self.message, j_idx, i_idx, num_src,
                                   num_dst, edge_mask, kwargs)
        out = self.message(**msg_kwargs)
        if edge_mask is not None:
            m = edge_mask.view((-1,) + (1,) * (out.dim() - 1))
            out = torch.where(m, out, 0)
        out = self.aggregate(out, i_idx, dim_size=num_dst,
                             edge_mask=edge_mask)
        return self._run_update(out, kwargs)

    def edge_updater(self, edge_index,
                     size: Optional[Tuple[int, int]] = None,
                     edge_mask: Optional[torch.Tensor] = None,
                     **kwargs) -> torch.Tensor:
        """Edge-level pass: ``edge_update`` called with the arguments it
        asks for, gathered as ``message``'s are; per-edge outputs."""
        num_src, num_dst = self._infer_size(edge_index, size, kwargs)
        j_idx, i_idx = _endpoints(edge_index, self.flow)
        _debug_check_bounds(j_idx, i_idx, num_src, num_dst)
        fn = self.edge_update
        return fn(**self._collect(fn, j_idx, i_idx, num_src, num_dst,
                                  edge_mask, kwargs))

    # -- internals ----------------------------------------------------------
    def _infer_size(self, edge_index, size, kwargs) -> Tuple[int, int]:
        if size is not None:
            return size
        if isinstance(edge_index, EdgeIndex):
            return edge_index.sparse_size
        x = kwargs.get('x')
        if x is not None:
            src, dst = _pair(x)
            if src is not None and dst is not None:
                return (src.shape[0], dst.shape[0])
            if src is not None:
                return (src.shape[0], src.shape[0])
        raise ValueError(
            'propagate() needs static sizes: pass an EdgeIndex, size=(N,M), '
            'or node features x')

    def _collect(self, fn, j_idx, i_idx, num_src, num_dst, edge_mask,
                 kwargs) -> Dict[str, Any]:
        """Materialise exactly the arguments ``fn`` asks for."""
        params = inspect.signature(fn).parameters
        out: Dict[str, Any] = {}
        # clamp gather indices so padded edges (idx == N) read row 0..N-1
        # safely; their messages are dropped at aggregation
        j_safe = j_idx.long().clamp(0, max(num_src - 1, 0))
        i_safe = i_idx.long().clamp(0, max(num_dst - 1, 0))
        for name in params:
            if name == 'kwargs':
                continue
            if name.endswith('_j') or name.endswith('_i'):
                base = name[:-2]
                val = kwargs.get(base)
                if val is None:
                    raise ValueError(
                        f"message() wants '{name}' but '{base}' was not "
                        f'passed to propagate()')
                src_val, dst_val = _pair(val)
                # index_select's gradient is a scatter-add, the transpose
                # of XLA's gather (2.7x less device time forward and
                # backward than indexing on products_bench's sampled
                # batches on an H100, chip_smoke.py's scan phase); on the
                # card it adds with atomics, so its sums' order, and the
                # gradient's last bits, may change from run to run.
                # Indexing's gradient sorts the indices and adds the
                # repeats of one index serially.
                out[name] = (src_val.index_select(0, j_safe)
                             if name.endswith('_j')
                             else dst_val.index_select(0, i_safe))
            elif name == 'index':
                out[name] = i_idx
            elif name in ('size_i', 'dim_size'):
                out[name] = num_dst
            elif name == 'size_j':
                out[name] = num_src
            elif name == 'edge_mask':
                out[name] = edge_mask
            elif name in kwargs:
                out[name] = kwargs[name]
            elif params[name].default is inspect.Parameter.empty:
                raise ValueError(
                    f"message() requires '{name}' but it was not passed to "
                    f'propagate()')
        return out

    def _run_update(self, out, kwargs):
        params = inspect.signature(self.update).parameters
        ukwargs = {k: kwargs[k] for k in params
                   if k not in ('inputs', 'kwargs') and k in kwargs}
        return self.update(out, **ukwargs)

    # convenience for attention convs
    @staticmethod
    def edge_softmax(alpha: torch.Tensor, index: torch.Tensor,
                     num_nodes: int,
                     edge_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Softmax of ``alpha`` over each destination's incoming edges
        (``ops.softmax``)."""
        return softmax(alpha, index, num_nodes, mask=edge_mask)
