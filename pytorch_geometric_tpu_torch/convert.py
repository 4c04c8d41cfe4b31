"""Weights carried across: a flax ``params`` tree of the JAX package (as
numpy arrays) -> the ``state_dict`` of the port's module of the same
architecture.

The JAX package's names map one to one onto the port's:

  * ``conv_i``  -> ``convs.i``       (BasicGNN layers)
  * ``conv_{src}__{rel}__{dst}`` -> ``convs.{src}__{rel}__{dst}``
                                     (HeteroConv's per-edge-type convs)
  * ``mlp_i``   -> ``convs.i.mlp``   (GIN's MLPs sit at the model level in
                                      flax, under the conv in the port)
  * ``norm_i``  -> ``norms.i``       (BasicGNN and MLP layer norms)
  * ``lin_i``   -> ``lins.i``        (MLP layers)
  * ``kernel [in, out]`` -> ``weight [out, in]``; a LayerNorm's ``scale``
    -> ``weight``; everything else keeps its name: the convs name their
    submodules and parameters as the flax modules do (GATConv's
    ``lin_src``, ``att_src``; TransformerConv's ``lin_query``, ``lin_key``,
    ``lin_value``, ``lin_edge``, ``lin_skip``, ``lin_beta``; SuperGATConv's
    ``lin``, ``att_l``, ``att_r``, ``bias``; the hetero modules'
    ``k_{t}``, ``a_rel_{edge type}``, ``skip_{t}``, ``proj_{t}``, ``q``,
    ``weight``, ``comp``, ``basis_coef``, ``layer_{i}`` ...). Only a
    ``kernel`` is transposed: the ``[R, F, C]`` banks, HGT's ``[H, D, D]``
    transforms, RGCN's ``comp [R, B]`` and HAN's ``q [1, C]`` keep their
    layout.
"""

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_RULES = ((re.compile(r'^conv_(\d+)$'), r'convs.\1'),
          (re.compile(r'^conv_(.+__.+__.+)$'), r'convs.\1'),
          (re.compile(r'^mlp_(\d+)$'), r'convs.\1.mlp'),
          (re.compile(r'^norm_(\d+)$'), r'norms.\1'),
          (re.compile(r'^lin_(\d+)$'), r'lins.\1'))


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _rename(part: str) -> str:
    for pat, rep in _RULES:
        if pat.match(part):
            return pat.sub(rep, part)
    return part


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax ``params`` tree (the ``'params'`` collection, or the
    variables dict holding it) to a port ``state_dict``. Load it with
    ``module.load_state_dict(sd)``, which checks that every name matches.

    Every array is copied: a tensor made from a numpy view of a JAX buffer
    would alias it."""
    if 'params' in params and isinstance(params['params'], Mapping):
        params = params['params']
    out = {}
    for path, value in _flatten(params):
        arr = np.array(value, dtype=np.float32, copy=True)
        *mods, leaf = path
        if leaf == 'kernel':
            leaf, arr = 'weight', np.ascontiguousarray(arr.T)
        elif leaf == 'scale':
            leaf = 'weight'
        out['.'.join([_rename(m) for m in mods] + [leaf])] = \
            torch.from_numpy(arr)
    return out
