"""Gathered binary ops: ``out[i] = left[left_index[i]] (op) right[right_index[i]]``.

Counterpart of ``pytorch_geometric_tpu/ops/sampled.py`` (``pyg_lib.ops.
sampled_add/sub/mul/div`` in the reference). Plain PyTorch: the JAX package
leaves the fusion of the two gathers and the op to XLA. A ``None`` index
takes every row; an out-of-range index row contributes the op's identity, so
padded edge slots stay inert.
"""

from typing import Optional

import torch

__all__ = ['sampled_add', 'sampled_sub', 'sampled_mul', 'sampled_div',
           'sampled_op']

_IDENTITY = {'add': 0.0, 'sub': 0.0, 'mul': 1.0, 'div': 1.0}


def _gather(x: torch.Tensor, index: Optional[torch.Tensor],
            fill: float) -> torch.Tensor:
    if index is None:
        return x
    n = x.shape[0]
    index = index.long()
    out = x[index.clamp(max=n - 1)]
    keep = (index < n).view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, out, torch.full((), fill, dtype=x.dtype,
                                             device=x.device))


def sampled_op(left: torch.Tensor, right: torch.Tensor,
               left_index: Optional[torch.Tensor] = None,
               right_index: Optional[torch.Tensor] = None,
               op: str = 'add') -> torch.Tensor:
    """``left[left_index] (op) right[right_index]``, op one of add, sub,
    mul, div (JAX ``ops/sampled.py:35-59``)."""
    if op not in _IDENTITY:
        raise ValueError(f"sampled_op: unknown op '{op}' (choose from "
                         f'{tuple(_IDENTITY)})')
    a = _gather(left, left_index, _IDENTITY[op])
    b = _gather(right, right_index, _IDENTITY[op])
    if op == 'add':
        return a + b
    if op == 'sub':
        return a - b
    if op == 'mul':
        return a * b
    return a / b


def sampled_add(left, right, left_index=None, right_index=None):
    return sampled_op(left, right, left_index, right_index, op='add')


def sampled_sub(left, right, left_index=None, right_index=None):
    return sampled_op(left, right, left_index, right_index, op='sub')


def sampled_mul(left, right, left_index=None, right_index=None):
    return sampled_op(left, right, left_index, right_index, op='mul')


def sampled_div(left, right, left_index=None, right_index=None):
    return sampled_op(left, right, left_index, right_index, op='div')
