"""QR solvers of the port (counterpart of ``qrkit_tpu/solvers/__init__.py``;
the protocol, the block-diagonal, banded, blocked thin, dense and
block-angular solvers)."""
from .banded_blocked import BandedBlockedQR
from .base import ComputationInfo, QRSolver
from .block_angular import BlockAngularQR
from .block_diagonal import BlockDiagonalQR, QFormat
from .blocked_thin import BlockedThinDenseQR, BlockedThinSparseQR
from .dense import DenseColPivQR, DenseHouseholderQR
from .segmented_banded import SegmentedBandedQR

__all__ = [
    "BandedBlockedQR",
    "BlockAngularQR",
    "BlockDiagonalQR",
    "BlockedThinDenseQR",
    "BlockedThinSparseQR",
    "ComputationInfo",
    "DenseColPivQR",
    "DenseHouseholderQR",
    "QFormat",
    "QRSolver",
    "SegmentedBandedQR",
]
