"""The QR-solver protocol (Eigen SparseSolver analog) on torch tensors.

Counterpart of ``qrkit_tpu/solvers/base.py`` (``ComputationInfo``,
``QRSolver``, ``_diag_health``).  ``compute`` ends by leaving a one-element
health flag on the device; only :meth:`QRSolver.info` reads it back, so a
factorization never waits for the device.  The protocol defaults for the
sparse-operand products and the explicit Q go through dense applies; the
banded family overrides the sparse products
(:mod:`~qrkit_tpu_torch.solvers.sparse_apply`).
"""
from __future__ import annotations

import abc
import enum

import numpy as np
import torch

from ..sparse import Permutation

__all__ = ["ComputationInfo", "QRSolver"]


class ComputationInfo(enum.Enum):
    SUCCESS = 0
    NUMERICAL_ISSUE = 1
    INVALID_INPUT = 2
    NOT_COMPUTED = 3


def _diag_health(d: torch.Tensor, check_zero: bool = True) -> torch.Tensor:
    """One device boolean: R's leading diagonal is finite (and, for
    non-rank-revealing solvers, nonzero).  Computed without a host sync."""
    ok = torch.isfinite(d).all()
    if check_zero and d.numel():
        ok = ok & (d.abs().amin() > 0)
    return ok


class QRSolver(abc.ABC):
    """Abstract QR solver: A (row-permuted, col-permuted) = Q R.

    Contract (mirrors the reference):
      * ``P_rows * A * P_cols = Q * R``
      * callers pre-apply ``rows_permutation()`` to rhs vectors before
        :meth:`solve`
      * :meth:`solve` returns x with ``x[cols_permutation.indices[i]] = y[i]``
        where y solves ``R y = Qᵀ b``.
    """

    _info: ComputationInfo = ComputationInfo.NOT_COMPUTED
    _health = None  # device flag from _set_success, read lazily by info()
    # Rank-revealing (ColPiv) solvers set this False: a zero pivot is a
    # reported condition there, not a numerical issue.
    _health_check_zero_pivot = True

    @property
    @abc.abstractmethod
    def rows(self) -> int: ...

    @property
    @abc.abstractmethod
    def cols(self) -> int: ...

    @property
    def rank(self) -> int:
        return self.cols

    def info(self) -> ComputationInfo:
        """Factorization status.  The health flag ``compute`` left on the
        device is read here, on the first call after ``compute`` — the only
        host synchronization of the factorize path."""
        if self._health is not None:
            healthy = bool(self._health.item())
            self._health = None
            if not healthy and self._info == ComputationInfo.SUCCESS:
                self._info = ComputationInfo.NUMERICAL_ISSUE
        return self._info

    def _set_success(self, health=None):
        """End-of-compute hook: mark SUCCESS and keep the device health flag
        (``health`` when the solver already computed it)."""
        self._info = ComputationInfo.SUCCESS
        self._health = (
            health
            if health is not None
            else _diag_health(self.r_diagonal(), check_zero=self._health_check_zero_pivot)
        )

    @abc.abstractmethod
    def compute(self, mat, **kwargs) -> "QRSolver": ...

    @abc.abstractmethod
    def apply_q(self, m: torch.Tensor) -> torch.Tensor:
        """Q @ m for a vector [rows] or matrix [rows, k]."""

    @abc.abstractmethod
    def apply_qt(self, m: torch.Tensor) -> torch.Tensor:
        """Qᵀ @ m."""

    @abc.abstractmethod
    def matrix_r_dense(self) -> torch.Tensor:
        """Dense R [rows, cols] (tests/interop; large problems use solve_r)."""

    @abc.abstractmethod
    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        """Solve R[:cols,:cols] x = y[:cols] with the structured R, for a
        vector ``y [n]`` or the columns of ``y [n, k]``."""

    def cols_permutation(self) -> Permutation:
        return Permutation.identity(self.cols)

    def rows_permutation(self) -> Permutation:
        return Permutation.identity(self.rows)

    def _unpermute(self, z: torch.Tensor) -> torch.Tensor:
        """x with ``x[cols_permutation.indices[i]] = z[i]`` (rows of z)."""
        perm = self.cols_permutation()
        if perm.is_identity():
            return z
        return z[torch.as_tensor(perm.gather_indices(), device=z.device)]

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Least-squares solve: y = Qᵀ b, structured triangular solve on the
        leading block, column back-permutation.  ``b`` is a vector [rows] or
        a matrix [rows, k] of rhs columns (one back-substitution over them:
        every ``solve_r`` takes ``[n, k]``); the caller pre-applies
        ``rows_permutation()``."""
        y = self.apply_qt(b)
        return self._unpermute(self.solve_r(y[: self.cols]))

    def r_diagonal(self) -> torch.Tensor:
        """Leading diagonal of R [cols]; structured solvers override this so
        no dense R is formed."""
        return torch.diagonal(self.matrix_r_dense()[: self.cols, : self.cols])

    def matrix_r_sparse(self):
        """Explicit sparse R (default: densify, then drop exact zeros)."""
        from ..sparse import SparseCSR

        R = self.matrix_r_dense().detach().cpu().numpy()
        r, c = np.nonzero(R)
        return SparseCSR.from_triplets(r, c, R[r, c], R.shape)

    def validate(self, rtol: float = 0.0) -> ComputationInfo:
        """Numerical-health check: NUMERICAL_ISSUE when R's leading diagonal
        holds a non-finite value or an entry at or below ``rtol * max|diag|``
        (rank collapse a non-rank-revealing solver would propagate).  Reads
        one flag from the device; updates and returns :meth:`info`."""
        d = self.r_diagonal().abs()
        if d.numel():
            bad = (~torch.isfinite(d).all()) | (d.amin() <= rtol * d.amax())
            if bool(bad.item()):
                self._info = ComputationInfo.NUMERICAL_ISSUE
        return self._info

    def _operand(self, s) -> torch.Tensor:
        """A host sparse operand as a dense tensor on the factors' device and
        in their dtype."""
        like = self.r_diagonal()
        return torch.as_tensor(s.to_dense(), dtype=like.dtype, device=like.device)

    def apply_qt_sparse(self, s):
        """``Qᵀ · S`` for a host sparse operand, returned sparse (the
        reference's ``matrixQ().transpose() * SparseMatrix``).  This default
        densifies and drops exact zeros; the banded family overrides it with
        plan-cached products that never form a dense ``[m, k]`` operand of
        the result's fill."""
        from ..sparse import SparseCSR

        return SparseCSR.from_dense(self.apply_qt(self._operand(s)).cpu().numpy())

    def apply_q_sparse(self, s):
        """``Q · S`` for a host sparse operand, returned sparse (see
        :meth:`apply_qt_sparse`)."""
        from ..sparse import SparseCSR

        return SparseCSR.from_dense(self.apply_q(self._operand(s)).cpu().numpy())

    def matrix_q_dense(self) -> torch.Tensor:
        """Explicit dense Q (tests only) = apply_q(I)."""
        like = self.r_diagonal()
        return self.apply_q(torch.eye(self.rows, dtype=like.dtype, device=like.device))

    def matrix_q_sparse(self):
        """Explicit sparse Q by Q·I applied to 512 unit columns at a time
        (device memory O(rows·512)); structured solvers override it where
        they can export Q in O(nnz(Q))."""
        from ..sparse import SparseCSR

        m, chunk = self.rows, 512
        like = self.r_diagonal()
        rows_l, cols_l, vals_l = [], [], []
        for c0 in range(0, m, chunk):
            k = min(chunk, m - c0)
            slab = torch.zeros((m, k), dtype=like.dtype, device=like.device)
            ar = torch.arange(k, device=like.device)
            slab[c0 + ar, ar] = 1.0
            q = self.apply_q(slab).cpu().numpy()
            r, c = np.nonzero(q)
            rows_l.append(r)
            cols_l.append(c + c0)
            vals_l.append(q[r, c])
        return SparseCSR.from_triplets(
            np.concatenate(rows_l), np.concatenate(cols_l), np.concatenate(vals_l), (m, m)
        )
