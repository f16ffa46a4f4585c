"""Device-mesh helpers and tall-skinny QR of the port (counterpart of
``qrkit_tpu/parallel``): ``default_mesh`` and ``shard_leading_axis`` on
``torch.distributed``, and TSQR on one device or over a mesh."""
from .mesh import default_mesh, shard_leading_axis
from .tsqr import TSQRDenseQR, tsqr_apply, tsqr_factorize

__all__ = ["default_mesh", "shard_leading_axis", "TSQRDenseQR", "tsqr_apply", "tsqr_factorize"]
