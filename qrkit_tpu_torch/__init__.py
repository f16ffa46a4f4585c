"""qrkit_tpu_torch — the PyTorch + CUDA port of ``qrkit_tpu``.

Counterpart of ``qrkit_tpu/__init__.py``, exporting what the port holds so
far: the host structure layer (``SparseCSR``, ``Permutation``), the
``BlockDiagonal`` container, ``BlockDiagonalQR`` with its Q formats, the
banded family (``BandedBlockedQR``, ``SegmentedBandedQR``), the
``QRSolver`` protocol, and the differentiable block-diagonal pipelines in
:mod:`~qrkit_tpu_torch.functional`.  Every Pallas kernel of the reference is
a hand-written CUDA kernel for Hopper here
(:mod:`qrkit_tpu_torch.ops.blockdiag`, :mod:`qrkit_tpu_torch.ops.banded`),
built from source at first use.

The package imports torch and NumPy and never jax.
"""

from . import functional
from .containers import BlockDiagonal
from .solvers import (
    BandedBlockedQR,
    BlockDiagonalQR,
    ComputationInfo,
    QFormat,
    QRSolver,
    SegmentedBandedQR,
)
from .sparse import Permutation, SparseCSR

__all__ = [
    "BandedBlockedQR",
    "BlockDiagonal",
    "BlockDiagonalQR",
    "ComputationInfo",
    "Permutation",
    "QFormat",
    "QRSolver",
    "SegmentedBandedQR",
    "SparseCSR",
    "functional",
]
