"""qrkit_tpu_torch — the PyTorch + CUDA port of ``qrkit_tpu``.

Counterpart of ``qrkit_tpu/__init__.py``, exporting what the first slice of
the port holds: the host structure layer (``SparseCSR``, ``Permutation``),
the ``BlockDiagonal`` container, ``BlockDiagonalQR`` with its Q formats and
the ``QRSolver`` protocol, and the differentiable block-diagonal pipelines
in :mod:`~qrkit_tpu_torch.functional`.  The two Pallas kernels on this path
are hand-written CUDA kernels for Hopper here
(:mod:`qrkit_tpu_torch.ops.blockdiag`), built from source at first use.

The package imports torch and NumPy and never jax.
"""

from . import functional
from .containers import BlockDiagonal
from .solvers import BlockDiagonalQR, ComputationInfo, QFormat, QRSolver
from .sparse import Permutation, SparseCSR

__all__ = [
    "BlockDiagonal",
    "BlockDiagonalQR",
    "ComputationInfo",
    "Permutation",
    "QFormat",
    "QRSolver",
    "SparseCSR",
    "functional",
]
