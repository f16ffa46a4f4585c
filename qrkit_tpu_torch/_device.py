"""Where the port's entry points put host data.

No counterpart in ``qrkit_tpu`` (JAX puts host arrays on its default
device).  An entry point that takes host data (NumPy arrays, a
:class:`~qrkit_tpu_torch.sparse.SparseCSR`) and moves it to a device runs on
the card unless the caller names another device: ``device=None`` resolves
to CUDA.  There is no fallback: without a card the first tensor made there
raises PyTorch's own error, so nothing quietly runs on the CPU.  A tensor
input keeps its own device.
"""
from __future__ import annotations

import torch

__all__ = ["as_tensor", "resolve"]


def resolve(device=None) -> torch.device:
    """``torch.device(device)``, with None meaning CUDA."""
    return torch.device("cuda" if device is None else device)


def as_tensor(data, device=None, dtype=None) -> torch.Tensor:
    """``torch.as_tensor`` for an entry point's input: a tensor stays on its
    own device unless ``device`` is given; host data goes to
    :func:`resolve` ``(device)``."""
    if isinstance(data, torch.Tensor) and device is None:
        return torch.as_tensor(data, dtype=dtype)
    return torch.as_tensor(data, device=resolve(device), dtype=dtype)
