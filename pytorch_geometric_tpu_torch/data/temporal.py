"""TemporalData: the event-stream container.

Counterpart of ``pytorch_geometric_tpu/data/temporal.py`` (reference
``torch_geometric/data/temporal.py``). Each event is a ``(src, dst, t,
msg)`` tuple, kept on the host as numpy arrays, as the JAX package keeps
them; slicing and chronological splits preserve event order, which a
temporal model's memory depends on.
"""

from typing import Optional

import numpy as np


class TemporalData:
    """Event stream (src, dst, t, msg) (reference ``data/temporal.py``)."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, t: np.ndarray,
                 msg: Optional[np.ndarray] = None,
                 y: Optional[np.ndarray] = None):
        self.src = np.asarray(src, np.int64)
        self.dst = np.asarray(dst, np.int64)
        self.t = np.asarray(t)
        self.msg = (np.asarray(msg) if msg is not None
                    else np.zeros((len(self.src), 0), np.float32))
        self.y = y

    @property
    def num_events(self) -> int:
        return len(self.src)

    def __len__(self) -> int:
        return self.num_events

    @property
    def num_nodes(self) -> int:
        return int(max(self.src.max(), self.dst.max())) + 1 \
            if self.num_events else 0

    def __getitem__(self, idx):
        return TemporalData(self.src[idx], self.dst[idx], self.t[idx],
                            self.msg[idx],
                            None if self.y is None else self.y[idx])

    def train_val_test_split(self, val_ratio=0.15, test_ratio=0.15):
        """Chronological split (reference ``temporal.py``)."""
        n = self.num_events
        v = int(n * (1 - val_ratio - test_ratio))
        t = int(n * (1 - test_ratio))
        return self[:v], self[v:t], self[t:]

    def seq_batches(self, batch_size: int):
        for i in range(0, self.num_events, batch_size):
            yield self[i:i + batch_size]
