"""qrkit_tpu_torch — the PyTorch + CUDA port of ``qrkit_tpu``.

Counterpart of ``qrkit_tpu/__init__.py``, exporting the same names: the
host structure layer (``SparseCSR``, ``Permutation``, the plans and the
pattern analysis), the ``BlockDiagonal`` and ``BlockMatrix1x2`` containers,
every solver (``BlockDiagonalQR`` with its Q formats, ``BandedBlockedQR``,
``SegmentedBandedQR``, ``BlockedThinDenseQR``, ``BlockedThinSparseQR``,
``DenseHouseholderQR``, ``DenseColPivQR``, ``BlockAngularQR``) over the
``QRSolver`` protocol, ``auto_qr`` (and ``python -m qrkit_tpu_torch`` on
MatrixMarket files), plan persistence, the Levenberg–Marquardt loops and
the profiling helpers; plus the differentiable pipelines in
:mod:`~qrkit_tpu_torch.functional`, the device mesh (``default_mesh``,
``shard_leading_axis``) and TSQR in :mod:`~qrkit_tpu_torch.parallel`, the
applications in :mod:`qrkit_tpu_torch.examples` (ellipse fitting, bundle
adjustment) and the multi-rank dry run :mod:`qrkit_tpu_torch.dryrun`.
Every Pallas kernel of the reference is a hand-written CUDA kernel for
Hopper here (:mod:`qrkit_tpu_torch.ops.blockdiag`,
:mod:`qrkit_tpu_torch.ops.banded`), built from source at first use.  The
``mesh=`` paths run on ``torch.distributed`` as explicit SPMD: every rank
works on its shard and calls the collectives of
:mod:`qrkit_tpu_torch.parallel.mesh` itself.

The package imports torch and NumPy and never jax.  Its own import is
set-up part ``import`` (``profiling.setup_seconds()``).
"""
import time as _time

_IMPORT_START = _time.perf_counter()

from . import functional  # noqa: E402
from .analysis import (  # noqa: E402
    as_banded_as_possible,
    block_banded_info,
    column_density,
    from_block_banded_pattern,
    from_block_diagonal_pattern,
)
from .auto import auto_qr  # noqa: E402
from .containers import BlockDiagonal, BlockMatrix1x2  # noqa: E402
from .lm import LMConfig, LMResult, levenberg_marquardt  # noqa: E402
from .persist import load_analysis, plan_from_json, plan_to_json, save_analysis  # noqa: E402
from .plan import BlockInfo, StructurePlan  # noqa: E402
from .profiling import Timer, count_dispatches, timed, trace  # noqa: E402
from .solvers import (  # noqa: E402
    BandedBlockedQR,
    BlockAngularQR,
    BlockDiagonalQR,
    BlockedThinDenseQR,
    BlockedThinSparseQR,
    ComputationInfo,
    DenseColPivQR,
    DenseHouseholderQR,
    QFormat,
    QRSolver,
    SegmentedBandedQR,
)
from .sparse import Permutation, SparseCSR  # noqa: E402

__all__ = [
    "BlockInfo",
    "StructurePlan",
    "Permutation",
    "SparseCSR",
    "as_banded_as_possible",
    "block_banded_info",
    "column_density",
    "from_block_banded_pattern",
    "from_block_diagonal_pattern",
    "BlockDiagonal",
    "BlockMatrix1x2",
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
    "auto_qr",
    "LMConfig",
    "LMResult",
    "levenberg_marquardt",
    "load_analysis",
    "plan_from_json",
    "plan_to_json",
    "save_analysis",
    "Timer",
    "count_dispatches",
    "timed",
    "trace",
    "functional",
]

profiling._note_setup("import", _time.perf_counter() - _IMPORT_START)
