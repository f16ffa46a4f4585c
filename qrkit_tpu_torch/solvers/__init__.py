"""QR solvers of the port (counterpart of ``qrkit_tpu/solvers/__init__.py``;
the protocol, the block-diagonal, banded, dense and block-angular solvers so
far)."""
from .banded_blocked import BandedBlockedQR
from .base import ComputationInfo, QRSolver
from .block_angular import BlockAngularQR
from .block_diagonal import BlockDiagonalQR, QFormat
from .dense import DenseColPivQR, DenseHouseholderQR
from .segmented_banded import SegmentedBandedQR

__all__ = [
    "BandedBlockedQR",
    "BlockAngularQR",
    "BlockDiagonalQR",
    "ComputationInfo",
    "DenseColPivQR",
    "DenseHouseholderQR",
    "QFormat",
    "QRSolver",
    "SegmentedBandedQR",
]
