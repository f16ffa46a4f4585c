"""Automatic solver selection from detected structure.

Counterpart of ``qrkit_tpu/auto.py`` (``auto_qr``, ``ColumnSplitQR``,
``BlockDiagonalCSRQR``, ``_plan_covers``, ``_csr_solver``,
``_effective_tag``).  The same structure analysis the solvers use
(as-banded-as-possible rows, block detection, column density) picks the
stack:

* block-diagonal plan (no column overlap)        → ``BlockDiagonalQR``
* banded plan (overlapping blocks)               → ``BandedBlockedQR`` for a
  chain shorter than 64 blocks, else ``SegmentedBandedQR``
* a few dense columns over a structured body     → ``BlockAngularQR`` with
  the dense columns split off as the right block
* no exploitable structure                       → thin or dense QR

``auto_qr(mat)`` returns a computed solver under the usual contract (the
caller pre-applies ``rows_permutation()``; the column back-permutation is
folded into ``cols_permutation()``) and reports the stack in
``.selection``, with the reference's tags.  Host input goes to ``device``
(default CUDA, no fallback) in ``dtype`` (a ``SparseCSR``'s factors default
to float64).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _device, profiling
from .analysis import as_banded_as_possible, block_banded_info
from .containers import BlockDiagonal, BlockMatrix1x2
from .solvers import (
    BandedBlockedQR,
    BlockAngularQR,
    BlockDiagonalQR,
    BlockedThinDenseQR,
    BlockedThinSparseQR,
    DenseColPivQR,
    SegmentedBandedQR,
)
from .solvers.base import QRSolver
from .sparse import Permutation, SparseCSR

__all__ = ["auto_qr", "BlockDiagonalCSRQR", "ColumnSplitQR"]


class ColumnSplitQR(QRSolver):
    """Delegate that fed the inner solver ``A * P_pre`` and composes the
    permutations, so callers see one solver over the original column order:
    ``P_r A (P_pre ∘ P_inner) = Q R``."""

    def __init__(self, inner: QRSolver, pre: Permutation, selection: str):
        self.inner = inner
        self._pre = pre
        self.selection = selection

    @property
    def rows(self):
        return self.inner.rows

    @property
    def cols(self):
        return self.inner.cols

    @property
    def rank(self):
        return self.inner.rank

    def info(self):
        return self.inner.info()

    def compute(self, mat, **kwargs):
        raise TypeError("ColumnSplitQR wraps an already-computed solver")

    def apply_q(self, m):
        return self.inner.apply_q(m)

    def apply_qt(self, m):
        return self.inner.apply_qt(m)

    def matrix_r_dense(self):
        return self.inner.matrix_r_dense()

    def matrix_r_sparse(self):
        return self.inner.matrix_r_sparse()

    def matrix_q_sparse(self):
        return self.inner.matrix_q_sparse()  # Q is unaffected by column perms

    def solve_r(self, y):
        return self.inner.solve_r(y)

    def r_diagonal(self):
        return self.inner.r_diagonal()

    def rows_permutation(self):
        return self.inner.rows_permutation()

    def cols_permutation(self):
        # (P1 P2).indices[i] = P1.indices[P2.indices[i]]  (A*P gathers columns)
        return Permutation(self._pre.indices[self.inner.cols_permutation().indices])


class BlockDiagonalCSRQR(BlockDiagonalQR):
    """:class:`BlockDiagonalQR` that takes a raw host :class:`SparseCSR` and
    runs the container detection itself (row sort + block detection), so
    the block-angular composition can hand it a CSR left block.  The dense
    block batch goes to ``device`` (default CUDA) in ``dtype`` (default
    float64).  ``auto_qr`` makes it non-pivoting, so on the card its
    factorization is kernel B2 where the block shape admits it."""

    def __init__(self, suggested_block_cols: int = 3, *, device=None, dtype=None, **kw):
        super().__init__(**kw)
        self._suggested = suggested_block_cols
        self._pre = None
        self.device = _device.resolve(device)
        self.dtype = dtype if dtype is not None else torch.float64

    def set_analysis(self, plan, row_perm):
        """Install a precomputed uniform block-diagonal plan, so compute()
        skips the ordering and detection (``auto_qr`` already ran them)."""
        self._pre = (plan, row_perm)
        return self

    def compute(self, mat, row_perm=None):
        if not isinstance(mat, SparseCSR):
            return super().compute(mat, row_perm=row_perm)
        if self._pre is None:
            blk, perm = BlockDiagonal.from_sparse_matrix(
                mat, self._suggested, device=self.device, dtype=self.dtype
            )
            return super().compute(blk, row_perm=perm)
        plan, perm = self._pre
        sorted_mat = mat.permute_rows(perm) if not perm.is_identity() else mat
        blocks = sorted_mat.blocks_dense(
            [b.astuple() for b in plan.blocks], plan.max_block_rows, plan.max_block_cols
        )
        blk = BlockDiagonal(
            torch.as_tensor(blocks, device=self.device, dtype=self.dtype), mat.nrows, mat.ncols
        )
        return super().compute(blk, row_perm=perm)


def _plan_covers(sorted_mat: SparseCSR, plan) -> bool:
    """Every nonzero falls inside its row block's column span: a plan that
    under-covers would make the banded solver drop entries."""
    rows_, cols_, nrows_, ncols_ = plan.as_arrays()
    row_ids = np.repeat(np.arange(sorted_mat.nrows), np.diff(sorted_mat.indptr))
    pos = np.searchsorted(rows_, row_ids, side="right") - 1
    ok = pos >= 0
    p = np.clip(pos, 0, None)
    inside = (
        ok
        & (row_ids < rows_[p] + nrows_[p])
        & (sorted_mat.indices >= cols_[p])
        & (sorted_mat.indices < cols_[p] + ncols_[p])
    )
    return bool(np.all(inside))


def _csr_solver(mat: SparseCSR, suggested_block_cols: int, prefer_segmented: bool,
                device=None, dtype=None):
    """An uncomputed solver for a plain sparse matrix and its selection tag;
    the analysis run here (row ordering and block detection) is installed
    on the solver, so ``compute()`` does not repeat it."""
    with profiling.span("qrk.setup.analysis", setup=True):
        place = dict(device=device, dtype=dtype)
        perm, has_perm = as_banded_as_possible(mat)
        sorted_mat = mat.permute_rows(perm) if has_perm else mat
        try:
            plan = block_banded_info(sorted_mat, suggested_block_cols)
        except (ValueError, IndexError):
            plan = None
        if plan is not None and not _plan_covers(sorted_mat, plan):
            plan = None
        if plan is not None and plan.num_blocks >= 2:
            rows_, cols_, nrows_, ncols_ = plan.as_arrays()
            overlaps = (cols_ + ncols_)[:-1] - cols_[1:]
            br, bc = int(nrows_[0]), int(ncols_[0])
            uniform_diag = (
                np.all(overlaps == 0)
                and np.all(nrows_ == br) and np.all(ncols_ == bc)
                and np.all(rows_ == np.arange(plan.num_blocks) * br)
                and np.all(cols_ == np.arange(plan.num_blocks) * bc)
            )
            if uniform_diag:
                solver = BlockDiagonalCSRQR(suggested_block_cols, pivot=False, **place)
                solver.set_analysis(plan, perm)
                return solver, "block_diagonal"
            if prefer_segmented is False and plan.num_blocks < 2 * SegmentedBandedQR.DEFAULT_SEGMENT_BLOCKS:
                # short chains keep the plain chain; longer ones take the
                # segmented composition
                solver = BandedBlockedQR(suggested_block_cols=suggested_block_cols, **place)
                solver.set_analysis(plan, perm)
                return solver, "banded_blocked"
            # the segmented composition delegates to the plain chain itself on
            # short or non-uniform plans
            solver = SegmentedBandedQR(suggested_block_cols=suggested_block_cols, **place)
            solver.set_analysis(plan, perm)
            return solver, "segmented_banded"
        if mat.nrows >= 2 * mat.ncols:
            return BlockedThinSparseQR(**place), "blocked_thin_sparse"
        return DenseColPivQR(**place), "dense_colpiv"


def auto_qr(
    mat,
    suggested_block_cols: int = 8,
    dense_col_frac: float = 0.25,
    max_angular_cols: Optional[int] = None,
    prefer_segmented: bool = False,
    *,
    device=None,
    dtype=None,
):
    """Analyze ``mat``'s structure, pick the matching solver stack and
    compute it.

    ``dense_col_frac``: a column with nnz at or above this fraction of the
    rows counts as dense; a small set of dense columns over a structured
    body triggers the block-angular split.  Banded plans take the segmented
    composition for chains of 64 blocks or more and the plain chain below;
    ``prefer_segmented=True`` takes the segmented form regardless.  Host
    input goes to ``device`` (default CUDA) in ``dtype`` (a ``SparseCSR``'s
    factors default to float64, a dense array keeps its dtype); a
    ``BlockDiagonal`` or tensor keeps its own.

    The block-diagonal stacks factor without column pivoting (the kernel
    tier on the card); the reference's defaults pivot, so on a singular
    block the two packages differ (the reference reports a rank, this
    reports ``info()`` NUMERICAL_ISSUE).
    """
    place = dict(device=device, dtype=dtype)
    if isinstance(mat, BlockDiagonal):
        qr = BlockDiagonalQR(pivot=False).compute(mat)
        qr.selection = "block_diagonal"
        return qr
    if isinstance(mat, BlockMatrix1x2):
        if isinstance(mat.left, SparseCSR):
            left_solver, tag = _csr_solver(mat.left, suggested_block_cols, prefer_segmented, **place)
        else:
            left_solver, tag = BlockDiagonalQR(pivot=False), "block_diagonal"
        qr = BlockAngularQR(left_solver, DenseColPivQR(**place)).compute(mat)
        qr.selection = f"block_angular({_effective_tag(left_solver, tag)}, dense_colpiv)"
        return qr
    if not isinstance(mat, SparseCSR):
        a = _device.as_tensor(mat if isinstance(mat, torch.Tensor) else np.asarray(mat), device, dtype)
        thin = a.shape[0] >= 4 * a.shape[1]
        qr = BlockedThinDenseQR().compute(a) if thin else DenseColPivQR().compute(a)
        qr.selection = "blocked_thin_dense" if thin else "dense_colpiv"
        return qr

    m, n = mat.shape
    with profiling.span("qrk.setup.analysis", setup=True):
        dense_cols = np.nonzero(mat.col_nnz() >= max(dense_col_frac * m, 2))[0]
    cap = max_angular_cols if max_angular_cols is not None else max(1, n // 8)
    if 0 < dense_cols.size <= cap and dense_cols.size < n - dense_cols.size:
        # block-angular split: structured body | dense trailing columns
        sparse_cols = np.setdiff1d(np.arange(n), dense_cols)
        split = Permutation(np.concatenate([sparse_cols, dense_cols]))
        pm = mat.permute_cols(split)
        n1 = sparse_cols.size
        left = pm.slice_cols(0, n1)
        right = pm.hstack_dense_block(n1, dense_cols.size)
        left_solver, tag = _csr_solver(left, suggested_block_cols, prefer_segmented, **place)
        inner = BlockAngularQR(left_solver, DenseColPivQR(**place)).compute(
            BlockMatrix1x2(left, right)
        )
        return ColumnSplitQR(
            inner, split, f"block_angular({_effective_tag(left_solver, tag)}, dense_colpiv)"
        )

    solver, tag = _csr_solver(mat, suggested_block_cols, prefer_segmented, **place)
    qr = solver.compute(mat)
    qr.selection = _effective_tag(solver, tag)
    return qr


def _effective_tag(solver, tag: str) -> str:
    """The stack that actually ran: a SegmentedBandedQR that delegated to
    its plain chain reports ``banded_blocked``."""
    if tag == "segmented_banded" and getattr(solver, "_delegate", None) is not None:
        return "banded_blocked"
    return tag
