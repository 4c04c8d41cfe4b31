"""Backend knobs and the device rule of the port.

Counterpart of ``pytorch_geometric_tpu/backend.py``. The port's entry points
(``EdgeIndex``, the convolutions and models, ``spmm``) run on the CUDA card
unless the caller asks for the CPU: ``device=None`` means ``cuda``, and with
no card visible they raise instead of running on the CPU.
"""

from typing import Union

import torch

# Kernel SpMM dispatch (ops/spmm.py), the counterpart of ``use_pallas_spmm``:
# True -> a sum/mean SpMM on a CUDA tensor takes the hand-written kernels
# (segment-sum, or block-sparse over a baked cache); False -> it raises,
# since the port has no other sparse CUDA arm yet. A baked dense cache runs
# its matrix product either way, and a CPU tensor takes the plain versions.
use_kernel_spmm: bool = True


def default_device() -> torch.device:
    """The device an entry point runs on when the caller names none."""
    return torch.device('cuda')


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`default_device`.

    Raises ``RuntimeError`` for a CUDA device when no card is visible."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA card is visible; pass device="cpu" to run the plain '
            'PyTorch versions on the CPU')
    return dev
