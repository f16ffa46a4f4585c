"""QR solvers of the port (counterpart of ``qrkit_tpu/solvers/__init__.py``;
the protocol, the block-diagonal solver and the banded family so far)."""
from .banded_blocked import BandedBlockedQR
from .base import ComputationInfo, QRSolver
from .block_diagonal import BlockDiagonalQR, QFormat
from .segmented_banded import SegmentedBandedQR

__all__ = [
    "BandedBlockedQR",
    "BlockDiagonalQR",
    "ComputationInfo",
    "QFormat",
    "QRSolver",
    "SegmentedBandedQR",
]
