"""HypergraphData.

Counterpart of ``pytorch_geometric_tpu/data/hypergraph.py`` (reference
``torch_geometric/data/hypergraph_data.py``): a ``Data`` whose
``edge_index`` is a ``[2, nnz]`` (node, hyperedge) incidence. The JAX
package registers it as a pytree; a torch ``Data`` needs no registration.
``to`` and ``replace`` keep the class and the hyperedge count.
"""

from typing import Optional

from .data import Data


class HypergraphData(Data):
    def __init__(self, x=None, edge_index=None,
                 num_hyperedges: Optional[int] = None, **kwargs):
        super().__init__(x=x, edge_index=edge_index, **kwargs)
        self._num_hyperedges = num_hyperedges

    @property
    def num_hyperedges(self) -> Optional[int]:
        if self._num_hyperedges is not None:
            return self._num_hyperedges
        ei = self._store.get('edge_index')
        if ei is None:
            return 0
        coo = ei.coo if hasattr(ei, 'coo') else ei
        return int(coo[1].max()) + 1 if coo.numel() else 0
