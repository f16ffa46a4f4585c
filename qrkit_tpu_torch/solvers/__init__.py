"""QR solvers of the port (counterpart of ``qrkit_tpu/solvers/__init__.py``;
the block-diagonal solver and the protocol so far)."""
from .base import ComputationInfo, QRSolver
from .block_diagonal import BlockDiagonalQR, QFormat

__all__ = ["BlockDiagonalQR", "ComputationInfo", "QFormat", "QRSolver"]
