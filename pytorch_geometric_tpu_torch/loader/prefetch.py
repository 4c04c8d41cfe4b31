"""PrefetchLoader + CachedLoader.

Counterpart of ``pytorch_geometric_tpu/loader/prefetch.py`` (reference
``torch_geometric/loader/prefetch.py:52``, an asynchronous upload on CUDA
streams, and ``loader/cache.py:21``, a cache of device batches).

The JAX package leans on ``jax.device_put`` being asynchronous. The port
uploads on a copy stream of its own from pinned host buffers, so that batch
k+1 crosses to the card while the work queued on batch k runs:

  * two pinned staging buffers are used in turn, and one is refilled only
    once the copy that read it last has passed its event;
  * the card tensors are allocated on the copy stream; before a batch is
    handed over, the consumer's stream waits on its copy's event (so a
    replay, and ``compat.compile``'s copy into its static buffers, come
    after the upload), and each tensor is recorded on that stream (so the
    allocator does not reuse its memory while the consumer still reads it).

On a CPU device there is nothing to overlap: no pinning and no stream.
"""

import queue
import threading
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch

from ..backend import resolve_device
from ..data.data import Data, as_tensor
from ..edge_index import CSR, EdgeIndex

# staged tensors start on 64-byte boundaries of the pinned buffer
_ALIGN = 64


def map_tensors(batch, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``batch`` with ``fn`` applied to every tensor in it: the fields of a
    ``Data`` (or ``Batch``), an ``EdgeIndex``'s COO, sorted orientations and
    carried weights, the values of dicts, lists and tuples; a numpy array
    becomes a tensor first (:func:`.data.as_tensor`), as ``jax.device_put``
    converts one. Anything else is kept as it is."""
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, np.ndarray):
        return fn(as_tensor(batch))
    if isinstance(batch, EdgeIndex):
        def opt(v):
            return None if v is None else map_tensors(v, fn)
        return EdgeIndex(fn(batch.coo), batch.sparse_size,
                         csr=opt(batch.csr), csc=opt(batch.csc),
                         num_real_edges=batch.num_real_edges,
                         weight=opt(batch.weight))
    if isinstance(batch, Data):
        obj = object.__new__(type(batch))
        obj.__dict__.update(batch.__dict__)
        obj._store = {k: map_tensors(v, fn) for k, v in batch.items()}
        return obj
    if isinstance(batch, dict):
        return {k: map_tensors(v, fn) for k, v in batch.items()}
    if isinstance(batch, CSR):
        return CSR(*(map_tensors(v, fn) for v in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(map_tensors(v, fn) for v in batch)
    return batch


class _Uploader:
    """Host-to-card copies of whole batches on a stream of their own, staged
    through two pinned buffers used in turn (see the module docstring)."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers: List[Optional[torch.Tensor]] = [None] * self.SLOTS
        self.events: List[Optional[torch.cuda.Event]] = [None] * self.SLOTS
        self.turn = 0

    def put(self, batch):
        """Queue ``batch``'s upload; returns ``(batch on the card, the copy's
        event, the card tensors made)``. Tensors already on the card pass
        through."""
        sizes = []

        def size(t):
            if t.device.type == 'cpu':
                sizes.append(-(-t.numel() * t.element_size() // _ALIGN)
                             * _ALIGN)
            return t

        map_tensors(batch, size)
        slot = self.turn % self.SLOTS
        self.turn += 1
        if self.events[slot] is not None:
            # the copy that read this buffer last must have passed
            self.events[slot].synchronize()
        buf = self.buffers[slot]
        if buf is None or buf.numel() < sum(sizes):
            buf = self.buffers[slot] = torch.empty(
                max(sum(sizes), _ALIGN), dtype=torch.uint8, pin_memory=True)
        made, offset = [], 0

        def upload(t):
            nonlocal offset
            if t.device.type != 'cpu':
                return t
            n = t.numel() * t.element_size()
            staged = buf[offset:offset + n].view(t.dtype).view(t.shape)
            staged.copy_(t)
            offset += -(-n // _ALIGN) * _ALIGN
            dev = torch.empty(t.shape, dtype=t.dtype, device=self.device)
            dev.copy_(staged, non_blocking=True)
            made.append(dev)
            return dev

        with torch.cuda.stream(self.stream):
            out = map_tensors(batch, upload)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        return out, event, made

    def arrive(self, item):
        """The batch of :meth:`put`'s ``item``, ready for the caller's
        stream: it waits on the copy, and owns the tensors from here on."""
        batch, event, made = item
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for t in made:
            t.record_stream(current)
        return batch


class PrefetchLoader:
    """Wraps any batch iterable and uploads batch i+1 while batch i is being
    consumed (reference ``prefetch.py:52``).

    ``device``: where ``put=True`` uploads, the card by default
    (:func:`..backend.resolve_device`); on the card, through pinned buffers
    and a copy stream (the module docstring). ``put=False`` keeps batches on
    the host, for consumers that stack several batches before one upload
    (``loader/scan_train.py``'s ``stack_batches``).

    ``num_threads > 0`` also moves the host side of the pipeline (sampling
    and collation, the expensive part of NeighborLoader batches, and the
    staging copies) onto a producer thread feeding a bounded queue of
    ``queue_size``, so that it overlaps the card's work. Batches come in the
    loader's order; an error in the loader reaches the consumer; a consumer
    that stops early stops the producer.
    """

    def __init__(self, loader, device: Optional[Any] = None,
                 num_threads: int = 0, queue_size: int = 2,
                 put: bool = True):
        self.loader = loader
        self.device = resolve_device(device) if put else None
        self.num_threads = num_threads
        self.queue_size = queue_size
        self.put = put
        self._uploader = (_Uploader(self.device)
                          if put and self.device.type == 'cuda' else None)

    def __len__(self):
        return len(self.loader)

    def _put(self, batch):
        if not self.put:
            return batch
        if self._uploader is None:
            return map_tensors(batch, lambda t: t.to(self.device))
        return self._uploader.put(batch)

    def _arrive(self, item):
        if self._uploader is None:
            return item
        return self._uploader.arrive(item)

    def _iter_threaded(self) -> Iterator:
        q: 'queue.Queue' = queue.Queue(maxsize=max(self.queue_size, 1))
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that notices the consumer's abandonment: without
            # the stop check, an abandoned iterator would leave the producer
            # blocked in q.put for good (a leaked thread and its batches)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in self.loader:
                    if not put(('item', self._put(b))):
                        return
            except BaseException as e:          # reaches the consumer
                put(('error', e))
                return
            put(('done', None))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == 'error':
                    raise payload
                if kind == 'done':
                    return
                yield self._arrive(payload)
        finally:
            stop.set()
            # drain so that a producer blocked in q.put returns, then join
            # briefly: a daemon thread killed at interpreter teardown in the
            # middle of a C++ sampler call aborts the process
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)

    def __iter__(self) -> Iterator:
        if self.num_threads > 0:
            yield from self._iter_threaded()
            return
        it = iter(self.loader)
        try:
            ahead = self._put(next(it))
        except StopIteration:
            return
        for nxt in it:
            nxt_up = self._put(nxt)   # queued on the copy stream
            yield self._arrive(ahead)
            ahead = nxt_up
        yield self._arrive(ahead)


class CachedLoader:
    """Caches transformed device batches by position (reference
    ``cache.py:21``); ``device`` defaults to the card."""

    def __init__(self, loader, transform: Optional[Callable] = None,
                 device: Optional[Any] = None):
        self.loader = loader
        self.transform = transform
        self.device = resolve_device(device)
        self._cache = {}

    def __len__(self):
        return len(self.loader)

    def clear(self):
        self._cache.clear()

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i in self._cache:
                yield self._cache[i]
                continue
            if self.transform is not None:
                batch = self.transform(batch)
            batch = map_tensors(batch, lambda t: t.to(self.device))
            self._cache[i] = batch
            yield batch
