"""Compilation shims: ``compile`` (the port's ``jax.jit``), ``is_compiling``
and ``is_torch_instance``.

Counterpart of ``pytorch_geometric_tpu/compat.py``. In the JAX package
``compile`` is ``jax.jit``: the whole function becomes one device program.
On the card the port's counterpart is a captured CUDA graph: the function's
launches (the hand-written kernels, which launch through ctypes on the
current stream, and PyTorch's own) are recorded once and replayed with one
host call. This is not ``torch.compile``: the kernels are ctypes calls, and
nothing here rewrites the code around them.

A graph replays fixed work on fixed addresses, so ``compile`` serves
fixed-shape work (a serving forward, a full-batch training step, a scan
over stacked batches), as ``jit`` does; the rules are :class:`Compiled`'s.

Launch counts: each kernel wrapper adds one to its count per host call that
launches its kernel, and registers the count where it is defined
(:func:`register_launch_counter`; :func:`launch_counts` reads them all). A
replay makes no host call, so it counts nothing. A capture records its
launches in the compiled callable's ``launches_per_replay`` and leaves the
wrappers' counts as they were, so the launches a run made are
``launch_counts()`` plus each compiled callable's ``replay_launches()``.
"""

import functools
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ['compile', 'Compiled', 'cache_key', 'is_compiling',
           'is_torch_instance', 'launch_counters', 'launch_counts',
           'register_launch_counter']

# name -> (wrapper, attribute) of every kernel arm's launch count
_COUNTERS: Dict[str, Tuple[Any, str]] = {}


def is_compiling() -> bool:
    """Whether the current CUDA stream is capturing a graph (the port's
    counterpart of being inside a ``jax.jit`` trace). False where PyTorch
    has no CUDA."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def is_torch_instance(obj: Any, cls) -> bool:
    """``isinstance`` that sees through :func:`compile`'s wrapper (its
    ``__wrapped__``)."""
    return isinstance(getattr(obj, '__wrapped__', obj), cls)


def register_launch_counter(name: str, fn, attr: str = 'launches'):
    """Make ``fn.<attr>`` the launch count ``name``, starting at 0. A
    kernel wrapper registers each of its counts where it is defined, so a
    capture sets every count back."""
    setattr(fn, attr, 0)
    _COUNTERS[name] = (fn, attr)


def launch_counters() -> List[Tuple[str, Any, str]]:
    """(name, wrapper, attribute) of every kernel arm's launch count."""
    from . import ops  # noqa: F401  (importing the wrappers registers them)
    return [(name, fn, attr) for name, (fn, attr) in _COUNTERS.items()]


def launch_counts() -> Dict[str, int]:
    """Every kernel arm's launch count: host calls that launched it."""
    return {name: getattr(fn, attr) for name, fn, attr in launch_counters()}


def _set_counts(counts: Dict[str, int]):
    for name, fn, attr in launch_counters():
        setattr(fn, attr, counts[name])


# -- argument trees -----------------------------------------------------------
def _static_key(obj, keep: list):
    """A key part for an argument the graph takes as it is. A tensor, or an
    object hashed by its identity (a module, an ``EdgeIndex``), counts by
    identity and is appended to ``keep`` (:class:`Compiled` drops the key's
    capture when the object dies, so that its id is not reused); another
    hashable value counts by value, type included, so 1, 1.0 and True
    differ. An unhashable value is refused, as ``jit`` refuses it."""
    if isinstance(obj, torch.Tensor) or (
            type(obj).__hash__ is object.__hash__
            and hasattr(type(obj), '__weakref__')):
        keep.append(obj)
        return ('id', type(obj), id(obj))
    try:
        hash(obj)
    except TypeError:
        raise TypeError(
            f'compile: an argument of type {type(obj).__name__} is not '
            f'hashable; pass tensors (alone or in tuples, lists and dicts) '
            f'or hashable values') from None
    return ('value', type(obj), obj)


def _spec(obj, leaves: list, keep: list):
    """The key part of ``obj``; its tensors are appended to ``leaves`` in
    the order :func:`_rebuild` takes them back."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ('tensor', tuple(obj.shape), obj.dtype, obj.device,
                obj.requires_grad)
    if isinstance(obj, (tuple, list)):
        return (type(obj), tuple(_spec(o, leaves, keep) for o in obj))
    if isinstance(obj, dict):
        return (dict, tuple((k, _spec(v, leaves, keep))
                            for k, v in obj.items()))
    return _static_key(obj, keep)


def _rebuild(obj, it):
    """``obj`` with its tensors (in :func:`_spec`'s order) taken from
    ``it``."""
    if isinstance(obj, torch.Tensor):
        return next(it)
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return type(obj)(*(_rebuild(o, it) for o in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rebuild(o, it) for o in obj)
    if isinstance(obj, dict):
        return {k: _rebuild(v, it) for k, v in obj.items()}
    return obj


def _split(args, kwargs, static_argnums):
    """``(key, leaves, keep)``: the call's key, the tensors the graph reads
    from its static buffers, and the objects the key names by identity."""
    leaves, keep = [], []
    parts = tuple(_static_key(a, keep) if i in static_argnums
                  else _spec(a, leaves, keep) for i, a in enumerate(args))
    kw = tuple((k, _spec(v, leaves, keep)) for k, v in kwargs.items())
    key = (parts, kw, torch.is_grad_enabled(),
           torch.is_inference_mode_enabled())
    return key, leaves, keep


def cache_key(args: Sequence, kwargs: Optional[Dict[str, Any]] = None,
              static_argnums: Sequence[int] = ()):
    """The key a :class:`Compiled` callable keeps one capture under: the
    tree of the arguments, each tensor's shape, dtype, device and
    ``requires_grad``, every other value (by identity when it is hashed by
    identity, else by value; an unhashable one is refused), the arguments
    at ``static_argnums`` as a whole (a tensor by identity), and whether
    grad mode and inference mode are on. A call with another key captures
    again, as ``jit`` traces again."""
    return _split(tuple(args), dict(kwargs or {}),
                  frozenset(static_argnums))[0]


# -- the compiled callable ----------------------------------------------------
class _Capture:
    """One captured graph with its static input and output buffers."""

    def __init__(self):
        self.eager_calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: List[torch.Tensor] = []
        self.out_tree = None
        self.outputs: List[torch.Tensor] = []
        self.launches_per_replay: Dict[str, int] = {}

    def capture(self, fn, args, kwargs, static_argnums, leaves, device):
        self.inputs = [t.detach().clone() for t in leaves]
        it = iter(self.inputs)
        s_args = tuple(a if i in static_argnums else _rebuild(a, it)
                       for i, a in enumerate(args))
        s_kwargs = {k: _rebuild(v, it) for k, v in kwargs.items()}
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        stream = torch.cuda.current_stream(device)
        try:
            with torch.cuda.device(device), torch.cuda.graph(graph):
                out = fn(*s_args, **s_kwargs)
        except BaseException:
            # a capture_end that raises leaves the capture stream current
            torch.cuda.set_stream(stream)
            raise
        finally:
            after = launch_counts()
            _set_counts(before)
        found = []
        _spec(out, found, [])
        # detached, so that no result links to the capture's autograd graph
        self.outputs = [t.detach() for t in found]
        self.out_tree = _rebuild(out, iter(self.outputs))
        self.launches_per_replay = {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}
        self.graph = graph

    def load(self, leaves):
        for buf, t in zip(self.inputs, leaves):
            buf.copy_(t)

    def replay(self):
        self.graph.replay()
        return _rebuild(self.out_tree, iter([t.clone() for t in self.outputs]))


class Compiled:
    """``fn`` compiled for the card: the port's ``jax.jit``.

    * A call whose arguments hold no CUDA tensor runs ``fn`` as it is: the
      caller asked for the CPU.
    * Per key (:func:`cache_key`), the first ``warmup`` calls run ``fn``
      eagerly on a side stream and return its results. They build the
      kernels and fill lazily made state, such as an optimiser's moments,
      which a capture would otherwise remake at every replay.
    * The next call copies the tensor arguments into static buffers,
      captures ``fn`` over them into a ``torch.cuda.CUDAGraph``, replays it
      once and returns. Every later call copies the tensor arguments into
      the static buffers and replays. So each call is one call of ``fn``,
      and a training step compiled this way follows the eager trajectory
      call for call. A capture that fails raises; nothing falls back to
      eager.
    * Arguments at ``static_argnums``, and every non-tensor argument (an
      ``EdgeIndex``, a module), are part of the key and read in place: a
      tensor there is not copied, and another one captures again. Use them
      for tables that stay put across calls, such as a training set. A
      non-tensor argument that cannot be hashed is refused (``TypeError``).
    * Memory: each key keeps its graph, with the graph's memory pool (the
      static buffers and whatever the captured call allocated), until the
      callable is deleted; a key that names a tensor or another object by
      identity is dropped, graph and pool with it, when that object dies.
      An object made anew for every call is a new key every call: each call
      then runs eagerly as a warm-up and nothing is captured.
    * A result is a fresh copy (a clone of the graph's output buffers), so
      a later call does not overwrite it, as ``jit`` results are not
      overwritten. Non-tensor results are those of the capture call.
    * Tensor arguments must not require grad: gradients flow to the
      parameters ``fn`` closes over, which the graph updates in place.

    ``launches_per_replay``: the kernel launches the latest replayed graph
    holds, per counter (:func:`launch_counts`); ``captures`` and
    ``replays``: the graphs captured and their replays;
    :meth:`replay_launches`: the launches all replays made.
    """

    def __init__(self, fn: Callable, warmup: int = 2,
                 static_argnums: Sequence[int] = ()):
        if warmup < 0:
            raise ValueError(f'compile: warmup must be >= 0, got {warmup}')
        functools.update_wrapper(self, fn, updated=())
        self.__wrapped__ = fn
        self.warmup = warmup
        self.static_argnums = frozenset(static_argnums)
        self._captures: Dict[Any, _Capture] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._replayed: Dict[str, int] = {}
        self.launches_per_replay: Dict[str, int] = {}
        self.captures = 0
        self.replays = 0

    def replay_launches(self) -> Dict[str, int]:
        """Kernel launches made by all replays, per counter."""
        return dict(self._replayed)

    def _new_capture(self, key, keep) -> _Capture:
        cap = self._captures[key] = _Capture()
        me = weakref.ref(self)

        def forget():
            owner = me()
            if owner is not None:
                owner._captures.pop(key, None)

        for obj in keep:
            weakref.finalize(obj, forget)
        return cap

    def _eager(self, device, args, kwargs):
        """One eager call on a side stream, ordered after the work queued
        so far and before the work queued next."""
        side = self._streams.get(device)
        if side is None:
            side = self._streams[device] = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.__wrapped__(*args, **kwargs)
        current.wait_stream(side)
        return out

    def __call__(self, *args, **kwargs):
        key, leaves, keep = _split(args, kwargs, self.static_argnums)
        cuda = [t.device for t in leaves if t.is_cuda] + [
            o.device for o in keep
            if isinstance(o, torch.Tensor) and o.is_cuda]
        if not cuda:
            return self.__wrapped__(*args, **kwargs)
        if any(not t.is_cuda for t in leaves):
            raise ValueError('compile: the tensor arguments mix CUDA and '
                             'other devices')
        if any(t.requires_grad for t in leaves):
            raise ValueError('compile: a tensor argument requires grad; '
                             'gradients flow to the parameters fn closes '
                             'over (pass the tensor at static_argnums to '
                             'read it in place)')
        cap = self._captures.get(key)
        if cap is None:
            cap = self._new_capture(key, keep)
        if cap.graph is None:
            if cap.eager_calls < self.warmup:
                cap.eager_calls += 1
                return self._eager(cuda[0], args, kwargs)
            cap.capture(self.__wrapped__, args, kwargs, self.static_argnums,
                        leaves, cuda[0])
            self.captures += 1
        else:
            cap.load(leaves)
        out = cap.replay()
        self.replays += 1
        self.launches_per_replay = dict(cap.launches_per_replay)
        for k, n in cap.launches_per_replay.items():
            self._replayed[k] = self._replayed.get(k, 0) + n
        return out


def compile(fn: Optional[Callable] = None, *, warmup: int = 2,
            static_argnums: Sequence[int] = ()):
    """``fn`` as a :class:`Compiled` callable (the port's ``jax.jit``);
    without ``fn``, a decorator with these settings."""
    if fn is None:
        return lambda f: Compiled(f, warmup, static_argnums)
    return Compiled(fn, warmup, static_argnums)
