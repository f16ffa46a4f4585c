"""Tall-skinny QR of the port (counterpart of ``qrkit_tpu/parallel``; the
mesh helpers and every ``mesh=`` path wait for the mesh slice)."""
from .tsqr import TSQRDenseQR, tsqr_apply, tsqr_factorize

__all__ = ["TSQRDenseQR", "tsqr_apply", "tsqr_factorize"]
