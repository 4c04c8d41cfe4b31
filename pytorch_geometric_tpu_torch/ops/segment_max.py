"""Masked segment-max over slot-ordered values: the hand-written Hopper
kernel, its plain PyTorch version and its launch count.

Counterpart of ``segment_max_blocked`` (``pytorch_geometric_tpu/ops/
pallas_spmm.py:354``), which launches the TPU kernel ``_chunk_max_kernel``
(``:327``). The function

    out[d, h] = max over the slots k of row d of max(vals[k, h], -3.4e38)

gives ``-inf`` for a row with no slot and for a maximum ``<= -3e38``, the
JAX package's output rules (``:369-400``). It has no gradient: the JAX
package meant it for a softmax stabiliser under ``stop_gradient``. No path
of the JAX package calls it (``ops/gat_fused.py:29`` only imports it), so no
path of the port does either; ``chip_smoke.py`` holds the kernel against
its plain version.

Bound on the card: bytes, the values once (``S * H * 4``) plus indptr and
the output. The kernel (``csrc/segment_max.cu``) gives each destination
row a group of lanes (:func:`segment_max_lanes`, from the mean run length),
which reads the row's contiguous ``H``-wide slots in 16-byte loads where it
can and merges through warp shuffles, with no atomics; a maximum is exact,
so kernel and plain version agree bitwise.
"""

import ctypes
from typing import Optional

import torch

from .segment import ptr2index

SENTINEL = -3.4e38   # the TPU kernel's finite stand-in for -inf
EMPTY_BELOW = -3e38  # a maximum at or below this is returned as -inf


def segment_max_lanes(n_slots: int, n_dst: int) -> int:
    """Lanes of a warp per destination row for the kernel: the least power
    of two in [1, 32] at which each lane reads at most 8 slots of a row of
    the mean run length ``n_slots / n_dst`` (more than 4 where that takes
    more than one lane): two batches of the kernel's four loads. Fewer
    lanes per row serve more rows per warp and merge in fewer shuffles; at
    path C's mean of 21 slots, 4 lanes beat 2 and 8 (PERF.md)."""
    mean = n_slots / max(n_dst, 1)
    lanes = 1
    while lanes < 32 and mean > 8 * lanes:
        lanes *= 2
    return lanes


def segment_max_plain(indptr: torch.Tensor, vals: torch.Tensor
                      ) -> torch.Tensor:
    """The plain PyTorch version: ``scatter_reduce`` with ``amax`` from
    the sentinel, then the output rule."""
    n_dst, h = indptr.shape[0] - 1, vals.shape[1]
    e = min(int(indptr[-1]), vals.shape[0])
    dst = ptr2index(indptr.long(), e).long()
    v = vals[:e].clamp(min=SENTINEL)
    out = vals.new_full((n_dst, h), SENTINEL).scatter_reduce_(
        0, dst[:, None].expand(e, h), v, reduce='amax')
    return torch.where(out <= EMPTY_BELOW, float('-inf'), out)


def _check(indptr, vals, num_segments):
    if vals.dtype != torch.float32:
        raise TypeError(f'segment_max takes float32 values, got {vals.dtype}')
    if vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError('segment_max takes contiguous [S, H] values, got '
                         f'shape {tuple(vals.shape)} strides {vals.stride()}')
    if indptr.device != vals.device:
        raise ValueError(f'segment_max: indptr is on {indptr.device}, vals '
                         f'on {vals.device}')
    if (indptr.dtype != torch.int32 or indptr.dim() != 1
            or not indptr.is_contiguous() or indptr.shape[0] < 1):
        raise ValueError('segment_max takes a contiguous 1-D int32 indptr '
                         f'with n + 1 >= 1 entries, got {indptr.dtype} shape '
                         f'{tuple(indptr.shape)}')
    if num_segments != indptr.shape[0] - 1:
        raise ValueError(f'segment_max: num_segments {num_segments} but the '
                         f'layout has {indptr.shape[0] - 1} rows')


def _kernel():
    from .. import csrc
    v, ll = ctypes.c_void_p, ctypes.c_longlong
    return csrc.function('segment_max', 'pgt_segment_max_f32',
                         [v, v, v, ll, ll, ctypes.c_int, ctypes.c_int, v])


def segment_max_blocked(vals: torch.Tensor, layout, num_segments: int,
                        lanes: Optional[int] = None) -> torch.Tensor:
    """``[num_segments, H]`` row maxima of slot-ordered ``vals [S, H]``
    (float32, contiguous) over ``layout`` (a :class:`~..edge_index.Slots`,
    or anything with its int32 ``indptr``). A CPU tensor runs
    :func:`segment_max_plain`; a CUDA tensor launches the kernel (built at
    first use) or raises. ``lanes`` (a power of two in [1, 32]) sets the
    kernel's lanes per row; None takes :func:`segment_max_lanes`. Counted
    in ``segment_max_blocked.launches``."""
    indptr = layout.indptr
    _check(indptr, vals, num_segments)
    if lanes is not None and (lanes < 1 or lanes > 32
                              or lanes & (lanes - 1)):
        raise ValueError(f'segment_max: lanes {lanes} is not a power of two '
                         'in [1, 32]')
    if vals.device.type == 'cpu':
        return segment_max_plain(indptr, vals)
    if vals.device.type != 'cuda':
        raise ValueError(f'segment_max runs on cpu or cuda, not {vals.device}')
    fn = _kernel()
    out = torch.empty((num_segments, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(indptr.data_ptr(), vals.data_ptr(), out.data_ptr(),
                 num_segments, vals.shape[0], vals.shape[1],
                 lanes or segment_max_lanes(vals.shape[0], num_segments),
                 stream)
    if err != 0:
        raise RuntimeError(f'segment_max kernel launch failed: CUDA error '
                           f'{err}')
    segment_max_blocked.launches += 1
    return out


segment_max_blocked.launches = 0
