"""Several sampled training steps per dispatch.

Counterpart of ``pytorch_geometric_tpu/loader/scan_train.py``. Dispatching
one optimiser step at a time makes the host pay for every launch of every
step; the JAX package stacks K sampled batches and runs the K steps in one
device call (``lax.scan`` under ``jit``). The port does the same with a
CUDA graph (:func:`..compat.compile`): ``scan_fn`` captures the K steps,
unrolled over the stacked batches, and replays them with one host call.

Padding-bucket contract: the K stacked batches share one padded shape
(``NeighborLoader``'s fixed per-hop caps give it); a batch of another shape
is another graph, as it is another trace of ``scan_fn`` in JAX.

The kernel route: the default loss turns each batch's COO into an
``EdgeIndex`` on the card (padded edges at the ``n_cap`` sentinel, the
sparse size given, so nothing reads a size back from the card under a
capture), caches both sorted orientations (two sorts and two
``searchsorted``s, no host sync) and calls the model on it without an edge
mask, so a SAGE mean runs ``spmm`` and with it the segment-sum kernel,
forward and transposed backward, which adds without atomics: the steps are
repeatable bit for bit. The gather route (:func:`gather_cross_entropy`)
passes the raw COO with the mask, as the JAX package's step does; the two
agree within float32 rounding.

The JAX package is functional, the port stateful: JAX's ``step_fn(params,
opt, X, Y, b) -> (params, opt, loss)`` is the port's ``step_fn(X, Y, b) ->
loss``, which updates ``model``'s parameters and ``optimizer``'s state in
place (``params`` is ``model.parameters()``, ``opt`` is
``optimizer.state``); ``scan_fn`` likewise.
"""

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import compat
from ..backend import resolve_device
from ..edge_index import EdgeIndex

__all__ = ['stack_batches', 'make_device_train_step']

# the stacked keys, in the JAX package's order
KEYS = ('n_id', 'node_mask', 'edge_index', 'edge_mask', 'seed_mask')
# batch-local ids below this fit int16 (the n_cap padding sentinel too)
INT16_BELOW = 2 ** 15 - 1


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def stack_batches(batches: List, device=None) -> Dict[str, torch.Tensor]:
    """Stack K structure-only batches into ``[K, ...]`` tensors for one
    ``scan_fn`` call: ``n_id``, ``node_mask``, ``edge_index`` (batch-local
    ids, ``n_cap`` for a padded edge), ``edge_mask`` and ``seed_mask`` (the
    first ``batch_size`` local nodes). A batch is anything with those
    attributes and ``num_nodes`` (``n_cap``) and ``batch_size``; its
    ``edge_index`` may be an ``EdgeIndex`` or a ``[2, E]`` array.

    While ``n_cap < 2**15 - 1`` the edge ids travel as int16, half the bytes
    of the largest upload; the step widens them on the device. The tensors
    go to ``device``, else to the device of the batches' tensors, else to
    the card (:func:`..backend.resolve_device`)."""
    n_cap = int(batches[0].num_nodes)
    if device is None:
        first = batches[0].n_id
        device = first.device if isinstance(first, torch.Tensor) else None
    device = resolve_device(device)

    def stk(key):
        return np.stack([_np(getattr(b, key)) for b in batches])

    coos = np.stack([_np(getattr(b.edge_index, 'coo', b.edge_index))
                     for b in batches])
    if n_cap < INT16_BELOW:
        coos = coos.astype(np.int16)
    seed = np.stack([np.arange(n_cap) < int(b.batch_size) for b in batches])
    out = {'n_id': stk('n_id'), 'node_mask': stk('node_mask'),
           'edge_index': coos, 'edge_mask': stk('edge_mask'),
           'seed_mask': seed}
    return {k: torch.as_tensor(out[k], device=device) for k in KEYS}


def batch_edge_index(coo: torch.Tensor, edge_mask: torch.Tensor,
                     n_cap: int) -> EdgeIndex:
    """One padded batch's ``[2, E]`` batch-local COO as an ``EdgeIndex`` on
    its device, both orientations cached: the masked-out edges at the
    ``n_cap`` sentinel (past every sorted row, so the sums drop them), the
    sparse size ``(n_cap, n_cap)``. Reads nothing back from the card, so it
    may run inside a capture."""
    coo = torch.where(edge_mask, coo.int(), n_cap)
    return EdgeIndex(coo, (n_cap, n_cap)).fill_cache(blocked=False)


def seed_mean(logits, y, seed_mask):
    """Softmax cross-entropy over the seed nodes only, averaged over them
    (at least one)."""
    loss = F.cross_entropy(logits, y.long(), reduction='none')
    return (torch.where(seed_mask, loss, 0.0).sum()
            / seed_mask.sum().clamp(min=1))


def seed_cross_entropy(model, x, coo, edge_mask, y, seed_mask):
    """The default loss, on the kernel route: the model runs on the batch's
    ``EdgeIndex`` (:func:`batch_edge_index`, the padded edges at the
    sentinel) with no mask and aggregates over the cached CSC; then
    :func:`seed_mean`."""
    ei = batch_edge_index(coo, edge_mask, x.shape[0])
    return seed_mean(model(x, ei), y, seed_mask)


def gather_cross_entropy(model, x, coo, edge_mask, y, seed_mask):
    """The gather route's loss: the model aggregates the raw COO with the
    edge mask (``nn/message_passing.py``'s gather path, the JAX package's
    step; no kernel of the port, atomic adds in the backward); then
    :func:`seed_mean`."""
    return seed_mean(model(x, coo, edge_mask=edge_mask), y, seed_mask)


def make_device_train_step(model, optimizer,
                           loss_fn: Optional[Callable] = None):
    """The device-gather training pair ``(step_fn, scan_fn)``.

    ``step_fn(X, Y, b)`` runs ONE optimiser step over one batch dict (one
    row of :func:`stack_batches`' output); ``scan_fn(X, Y, stacked)`` runs
    the K steps of a stack in ONE graph replay and returns the last loss.
    Both run the same body, so K ``step_fn`` calls and one ``scan_fn`` call
    take the same steps. Both are :func:`..compat.compile` callables: on
    CUDA tensors the first two calls (of a shape) run eagerly, then they
    replay (build ``optimizer`` with ``capturable=True``, whose step count
    stays on the card); on CPU tensors they run eagerly.

    ``X`` / ``Y`` are the feature and label tables on the device, read in
    place (the graphs take them as static arguments: another table is
    another capture); each step gathers its rows by ``n_id`` on the device,
    zeroing the padded ones. ``loss_fn(model, x, coo, edge_mask, y,
    seed_mask)`` gets the batch's ``[2, E]`` int64 COO; it defaults to
    :func:`seed_cross_entropy` (the kernel route, which builds the batch's
    ``EdgeIndex``); :func:`gather_cross_entropy` is the gather route.

    The port updates in place where JAX returns new values: ``model``'s
    parameters are JAX's ``params``, ``optimizer``'s state its ``opt``."""
    if loss_fn is None:
        loss_fn = seed_cross_entropy

    def body(X, Y, b):
        mask = b['node_mask']
        safe = torch.where(mask, b['n_id'], 0).long()
        x = torch.where(mask[:, None], X[safe], 0.0)
        y = Y[safe]
        # the int16 wire format widened on the device (torch indexes with
        # int64)
        coo = b['edge_index'].long()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, x, coo, b['edge_mask'], y, b['seed_mask'])
        loss.backward()
        optimizer.step()
        return loss.detach()

    def scan(X, Y, stacked):
        loss = None
        for k in range(stacked['n_id'].shape[0]):
            loss = body(X, Y, {key: v[k] for key, v in stacked.items()})
        return loss

    return (compat.compile(body, static_argnums=(0, 1)),
            compat.compile(scan, static_argnums=(0, 1)))
