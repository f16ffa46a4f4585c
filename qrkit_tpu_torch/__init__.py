"""qrkit_tpu_torch — the PyTorch + CUDA port of ``qrkit_tpu``.

Counterpart of ``qrkit_tpu/__init__.py``, exporting what the port holds so
far: the host structure layer (``SparseCSR``, ``Permutation``), the
``BlockDiagonal`` and ``BlockMatrix1x2`` containers, ``BlockDiagonalQR``
with its Q formats, the banded family (``BandedBlockedQR``,
``SegmentedBandedQR``), the dense solvers (``DenseHouseholderQR``,
``DenseColPivQR``), ``BlockAngularQR``, the ``QRSolver`` protocol, the
differentiable pipelines in :mod:`~qrkit_tpu_torch.functional`, the
single-device TSQR in :mod:`~qrkit_tpu_torch.parallel` and the
Levenberg–Marquardt drivers in :mod:`~qrkit_tpu_torch.lm` (the ellipse
application in :mod:`qrkit_tpu_torch.examples.ellipse`).  Every Pallas kernel of the reference is
a hand-written CUDA kernel for Hopper here
(:mod:`qrkit_tpu_torch.ops.blockdiag`, :mod:`qrkit_tpu_torch.ops.banded`),
built from source at first use.

The package imports torch and NumPy and never jax.
"""

from . import functional
from .containers import BlockDiagonal, BlockMatrix1x2
from .lm import LMConfig, LMResult, levenberg_marquardt
from .solvers import (
    BandedBlockedQR,
    BlockAngularQR,
    BlockDiagonalQR,
    ComputationInfo,
    DenseColPivQR,
    DenseHouseholderQR,
    QFormat,
    QRSolver,
    SegmentedBandedQR,
)
from .sparse import Permutation, SparseCSR

__all__ = [
    "BandedBlockedQR",
    "BlockAngularQR",
    "BlockDiagonal",
    "BlockDiagonalQR",
    "BlockMatrix1x2",
    "ComputationInfo",
    "DenseColPivQR",
    "DenseHouseholderQR",
    "LMConfig",
    "LMResult",
    "Permutation",
    "QFormat",
    "QRSolver",
    "SegmentedBandedQR",
    "SparseCSR",
    "functional",
    "levenberg_marquardt",
]
