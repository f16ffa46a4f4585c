"""Device operations of the port (counterpart of ``qrkit_tpu/ops/``):
batched Householder QR in plain torch, and the hand-written CUDA kernels
with their plain PyTorch versions.  The package exports the reference's
names (``qrkit_tpu/ops/__init__.py``)."""
from .householder import (
    apply_wy,
    batched_panel_qr_yt,
    build_t_factor,
    colpiv_householder_qr,
    form_q,
    householder_qr_unblocked,
    panel_qr_yt,
)
from .compact_wy import CompactWYSeq

__all__ = [
    "apply_wy",
    "batched_panel_qr_yt",
    "build_t_factor",
    "colpiv_householder_qr",
    "form_q",
    "householder_qr_unblocked",
    "panel_qr_yt",
    "CompactWYSeq",
]
