"""KNN index structures (reference ``nn/pool/knn.py``, faiss backed).

Counterpart of ``pytorch_geometric_tpu/nn/pool/knn_index.py``: the "index"
is a growing dense embedding matrix on the device and search is one
distance or inner-product matmul and a top-k, ties to the lowest index as
``jax.lax.top_k`` breaks them. The ``Approx*`` variants keep the reference
API (the IVF parameters set the share of the index searched) and search a
uniformly sampled subset, drawn on the host with numpy as in the JAX
package.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...backend import resolve_device
from ...data.data import as_tensor
from .select import top_k


class KNNOutput(NamedTuple):
    score: torch.Tensor
    index: torch.Tensor


class KNNIndex:
    """(reference ``knn.py:15``). The embeddings live on ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, emb=None, device=None):
        self.device = resolve_device(device)
        self._emb = None
        if emb is not None:
            self.add(emb)

    @property
    def numel(self) -> int:
        return 0 if self._emb is None else self._emb.shape[0]

    def _on_device(self, emb) -> torch.Tensor:
        # an array's 64-bit dtype narrowed as jnp.asarray narrows it
        return as_tensor(emb).to(self.device)

    def add(self, emb):
        emb = self._on_device(emb)
        self._emb = emb if self._emb is None else torch.cat([self._emb, emb])

    def _scores(self, emb) -> torch.Tensor:  # pragma: no cover - abstract
        raise NotImplementedError

    def search(self, emb, k: int,
               exclude_links: Optional[torch.Tensor] = None) -> KNNOutput:
        """The ``k`` best of the index for each row of ``emb``; the pairs
        ``exclude_links`` ``[2, L]`` (query row, index row) score
        ``-inf``."""
        emb = self._on_device(emb)
        scores = self._scores(emb)                   # [B, N], higher=better
        if exclude_links is not None:
            links = as_tensor(exclude_links).to(self.device).long()
            scores = scores.index_put((links[0], links[1]),
                                      scores.new_tensor(-np.inf))
        s, i = top_k(scores, min(k, self.numel))
        return KNNOutput(score=s, index=i)

    def get_emb(self) -> torch.Tensor:
        return self._emb


class L2KNNIndex(KNNIndex):
    """Exact L2 search (reference ``knn.py:215``); score = -distance."""

    def _scores(self, emb):
        d = ((emb ** 2).sum(-1)[:, None]
             + (self._emb ** 2).sum(-1)[None, :]
             - 2 * emb @ self._emb.T)
        return -d.clamp(min=0)


class MIPSKNNIndex(KNNIndex):
    """Exact maximum-inner-product search (reference ``knn.py:231``)."""

    def _scores(self, emb):
        return emb @ self._emb.T


class _ApproxMixin:
    def __init__(self, num_cells: int = 100, num_cells_to_visit: int = 10,
                 bits_per_vector: int = 8, emb=None, seed: int = 0,
                 device=None):
        self.frac = min(1.0, num_cells_to_visit / max(num_cells, 1))
        self._rng = np.random.default_rng(seed)
        super().__init__(emb, device=device)

    def search(self, emb, k: int, exclude_links=None) -> KNNOutput:
        """A search of ``max(k, numel * frac)`` index rows drawn without
        replacement (sorted); ``exclude_links`` applies only when the whole
        index is searched, as in the JAX package."""
        n = self.numel
        m = max(k, int(n * self.frac))
        if m >= n:
            return super().search(emb, k, exclude_links)
        sub = torch.as_tensor(np.sort(self._rng.choice(n, m, replace=False)),
                              device=self.device)
        full, self._emb = self._emb, self._emb[sub]
        try:
            out = super().search(emb, k, None)
        finally:
            self._emb = full
        return KNNOutput(score=out.score, index=sub[out.index])


class ApproxL2KNNIndex(_ApproxMixin, L2KNNIndex):
    """(reference ``knn.py:247``)."""


class ApproxMIPSKNNIndex(_ApproxMixin, MIPSKNNIndex):
    """(reference ``knn.py:290``)."""
