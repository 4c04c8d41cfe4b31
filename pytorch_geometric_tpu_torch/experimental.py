"""The debug flag.

Counterpart of the debug half of ``pytorch_geometric_tpu/experimental.py``
(reference ``torch_geometric/debug.py``): the port's own copy, so that
nothing of the JAX package is imported. ``debug()`` turns on
``MessagePassing``'s bounds check of ``edge_index``.
"""

import contextlib

_debug: bool = False


def is_debug_enabled() -> bool:
    return _debug


def set_debug_enabled(enabled: bool):
    global _debug
    _debug = enabled


@contextlib.contextmanager
def debug():
    set_debug_enabled(True)
    try:
        yield
    finally:
        set_debug_enabled(False)


class set_debug:
    """Sets debug mode on/off; also usable as a context manager that
    restores the previous state (reference ``debug.py:34``)."""
    def __init__(self, mode: bool):
        self.prev = is_debug_enabled()
        set_debug_enabled(mode)

    def __enter__(self):
        return self

    def __exit__(self, *args) -> bool:
        set_debug_enabled(self.prev)
        return False
