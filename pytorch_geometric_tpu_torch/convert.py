"""Weights carried across: a flax variables tree of the JAX package (as
numpy arrays) -> the ``state_dict`` of the port's module of the same
architecture.

The ``params`` collection gives the parameters; a ``batch_stats``
collection, where the tree has one (flax's ``BatchNorm``: BasicGNN's and
MLP's ``norm_batch``, ``nn/norm``'s ``BatchNorm`` and ``DiffGroupNorm``),
gives the running statistics: ``mean`` -> ``running_mean``, ``var`` ->
``running_var``.

The JAX package's names map one to one onto the port's:

  * ``conv_i``  -> ``convs.i``       (BasicGNN layers)
  * ``conv_{src}__{rel}__{dst}`` -> ``convs.{src}__{rel}__{dst}``
                                     (HeteroConv's per-edge-type convs)
  * ``mlp_i``   -> ``convs.i.mlp``   (GIN's and EdgeCNN's MLPs sit at the
                                      model level in flax, under the conv
                                      in the port; a ``mlp_i`` that is one
                                      Dense, PDNConv's, keeps its name)
  * ``norm_i``  -> ``norms.i``       (BasicGNN's and MLP's batch and layer
                                      norms, DiffGroupNorm's batch norms)
  * ``lin_i``   -> ``lins.i``        (MLP layers, FiLMConv's relations)
  * ``pre_i`` / ``post_i`` / ``edge_enc_i`` -> ``pre_nns.i`` /
    ``post_nns.i`` / ``edge_encoders.i`` (PNAConv's towers)
  * ``film_i``  -> ``films.i``       (FiLMConv's relations)
  * a flax ``LSTMCell`` (``Set2Set``'s ``lstm``: the eight Denses ``ii``,
    ``if``, ``ig``, ``io`` without bias and ``hi``, ``hf``, ``hg``, ``ho``
    with) -> ``weight_ih`` / ``weight_hh`` / ``bias_hh``, the four gates
    stacked in the order i, f, g, o (flax's cell has one bias, so there is
    no ``bias_ih``)
  * ``kernel [in, out]`` -> ``weight [out, in]``; a flax ``Embed``'s
    ``embedding`` -> ``weight``; a ``scale`` beside a ``bias`` (a
    BatchNorm's or LayerNorm's) -> ``weight``, while MsgNorm's lone
    ``scale`` keeps its name; everything else keeps its name: the convs
    name their submodules and parameters as the flax modules do
    (GATConv's ``lin_src``, ``att_src``; TransformerConv's ``lin_query``,
    ``lin_key``, ``lin_value``, ``lin_edge``, ``lin_skip``, ``lin_beta``;
    SuperGATConv's ``lin``, ``att_l``, ``att_r``, ``bias``; GraphConv's
    ``lin_rel`` and ``lin_root``, ClusterGCNConv's ``lin_out`` and
    ``lin_root``; GINEConv's ``lin_edge``; GENConv's ``lin_src``,
    ``lin_dst``, ``lin_edge``, ``aggr.t`` / ``aggr.p``, ``msg_norm``,
    ``mlp``; PDNConv's ``mlp_0``, ``mlp_1``, ``lin``; GeneralConv's
    ``lin_msg``, ``lin_msg_i``, ``lin_self``, ``att``; EGConv's
    ``lin_bases``, ``lin_comb``; the norms' ``mean_scale``, ``bn``,
    ``ln``; the hetero modules' ``k_{t}``, ``a_rel_{edge type}``,
    ``skip_{t}``, ``proj_{t}``, ``q``, ``weight``, ``comp``,
    ``basis_coef``, ``layer_{i}`` ...). Only a ``kernel`` is transposed:
    the ``[R, F, C]`` banks, HGT's ``[H, D, D]`` transforms, RGCN's ``comp
    [R, B]`` and HAN's ``q [1, C]`` keep their layout.
"""

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_RULES = ((re.compile(r'^conv_(\d+)$'), r'convs.\1'),
          (re.compile(r'^conv_(.+__.+__.+)$'), r'convs.\1'),
          (re.compile(r'^mlp_(\d+)$'), r'convs.\1.mlp'),
          (re.compile(r'^norm_(\d+)$'), r'norms.\1'),
          (re.compile(r'^lin_(\d+)$'), r'lins.\1'),
          (re.compile(r'^pre_(\d+)$'), r'pre_nns.\1'),
          (re.compile(r'^post_(\d+)$'), r'post_nns.\1'),
          (re.compile(r'^edge_enc_(\d+)$'), r'edge_encoders.\1'),
          (re.compile(r'^film_(\d+)$'), r'films.\1'))

_LSTM_GATES = ('i', 'f', 'g', 'o')
_STATS = {'mean': 'running_mean', 'var': 'running_var'}


def _rename(part: str, sub: Any) -> str:
    if part.startswith('mlp_') and not (
            isinstance(sub, Mapping) and any(k.startswith('lin_')
                                             for k in sub)):
        return part     # one Dense named mlp_i (PDNConv's), not an MLP
    for pat, rep in _RULES:
        if pat.match(part):
            return pat.sub(rep, part)
    return part


def _array(value) -> np.ndarray:
    # every array is copied: a tensor made from a numpy view of a JAX
    # buffer would alias it
    return np.array(value, dtype=np.float32, copy=True)


def _is_lstm_cell(tree: Mapping) -> bool:
    return set(tree) == {h + g for h in 'ih' for g in _LSTM_GATES}


def _walk(tree: Mapping[str, Any], prefix, out, stats: bool):
    if _is_lstm_cell(tree):
        out[prefix + ('weight_ih',)] = np.concatenate(
            [_array(tree['i' + g]['kernel']).T for g in _LSTM_GATES])
        out[prefix + ('weight_hh',)] = np.concatenate(
            [_array(tree['h' + g]['kernel']).T for g in _LSTM_GATES])
        out[prefix + ('bias_hh',)] = np.concatenate(
            [_array(tree['h' + g]['bias']) for g in _LSTM_GATES])
        return
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _walk(v, prefix + (_rename(k, v),), out, stats)
            continue
        arr = _array(v)
        if stats:
            leaf = _STATS.get(k, k)
        elif k == 'kernel':
            leaf, arr = 'weight', np.ascontiguousarray(arr.T)
        elif k == 'embedding' or (k == 'scale' and 'bias' in tree):
            leaf = 'weight'
        else:
            leaf = k
        out[prefix + (leaf,)] = arr


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax variables tree (the ``'params'`` collection alone, or
    the variables dict holding it and perhaps ``'batch_stats'``) to a port
    ``state_dict``. Of a variables dict, the other collections (``cache``,
    ``intermediates``, ``losses``, ...) are not state and are left out.
    Load it with ``module.load_state_dict(sd)``, which checks that every
    name matches."""
    collections = [(params, False)]
    stats = params.get('batch_stats')
    if isinstance(params.get('params'), Mapping) or (
            isinstance(stats, Mapping) and set(params) <= {'params',
                                                           'batch_stats'}):
        # a variables dict: a BatchNorm without affine has batch_stats only
        collections = [(params.get('params', {}), False)]
        if isinstance(stats, Mapping):
            collections.append((stats, True))
    flat = {}
    for tree, stats in collections:
        _walk(tree, (), flat, stats)
    return {'.'.join(k): torch.from_numpy(v) for k, v in flat.items()}
