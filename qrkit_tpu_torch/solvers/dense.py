"""Plain dense QR solvers implementing the QRSolver protocol, on torch tensors.

Counterpart of ``qrkit_tpu/solvers/dense.py`` (``_dense_qr(_h)``,
``_dense_colpiv_qr(_h)``, ``DenseHouseholderQR``, ``DenseColPivQR``): the
raw Eigen ``HouseholderQR`` / ``ColPivHouseholderQR`` that the reference
plugs into its composite solvers, a single compact-WY block over the whole
matrix.  No kernel: batched plain torch on either device.  ``compute`` on
a card tensor is one captured program (:mod:`~qrkit_tpu_torch._program`,
the reference's jitted ``_dense_qr_h`` / ``_dense_colpiv_qr_h``), keyed by
the matrix's shape and dtype; its factors are the program's outputs,
overwritten by the next ``compute`` of that shape.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _device
from .._program import Programs
from ..ops.householder import (
    apply_wy,
    build_t_factor,
    colpiv_householder_qr,
    highest_precision,
    panel_qr_yt,
    rank_from_diag,
    rank_masked_solve,
    upper_solve,
)
from ..sparse import Permutation, SparseCSR
from .base import QRSolver, _diag_health

__all__ = ["DenseHouseholderQR", "DenseColPivQR"]


def _dense_qr(a: torch.Tensor, panel_width: int = 16):
    return panel_qr_yt(a, panel_width=panel_width)


def _dense_colpiv_qr(a: torch.Tensor):
    Y, taus, R, perm = colpiv_householder_qr(a)
    return Y, build_t_factor(Y, taus), R, perm


# compute()-facing variants: triu and the info() health flag come with the
# factors, all on the device
def _dense_qr_h(a: torch.Tensor, panel_width: int = 16):
    Y, T, R = panel_qr_yt(a, panel_width=panel_width)
    R = torch.triu(R)
    return Y, T, R, _diag_health(torch.diagonal(R), check_zero=True)


def _dense_colpiv_qr_h(a: torch.Tensor):
    Y, taus, R, perm = colpiv_householder_qr(a)
    R = torch.triu(R)
    return Y, build_t_factor(Y, taus), R, perm, _diag_health(torch.diagonal(R), check_zero=False)


class _DenseQRBase(QRSolver):
    """``device``/``dtype`` place host input (NumPy, ``SparseCSR``; default
    CUDA, the input's dtype); a tensor keeps its device unless ``device``
    is given."""

    def __init__(self, *, device=None, dtype=None):
        self.device, self.dtype = device, dtype
        self._programs = Programs()

    @property
    def rows(self) -> int:
        return self._m

    @property
    def cols(self) -> int:
        return self._n

    def apply_q(self, m: torch.Tensor) -> torch.Tensor:
        return apply_wy(self._Y, self._T, m)

    def apply_qt(self, m: torch.Tensor) -> torch.Tensor:
        return apply_wy(self._Y, self._T, m, transpose=True)

    def matrix_r_dense(self) -> torch.Tensor:
        """R [rows, cols], a copy: the factor is the compute program's
        output, which the next compute of the same shape overwrites."""
        return self._R.clone()

    def r_diagonal(self) -> torch.Tensor:
        return torch.diagonal(self._R[: self._n, : self._n])

    def _square_r(self) -> torch.Tensor:
        """R's leading [n, n] triangle; for wide input (m < n) the trapezoid
        is embedded in a square with identity dead tail rows, so the basic
        solution (x = 0 beyond the pivots) comes out of one triangular solve."""
        m, n = self._m, self._n
        if m >= n:
            return self._R[:n, :n]
        eye_tail = torch.eye(n, dtype=self._R.dtype, device=self._R.device)[m:]
        return torch.cat([self._R[:m], eye_tail], dim=0)

    def _padded_rhs(self, y: torch.Tensor) -> torch.Tensor:
        n = self._n
        rhs = y[:n]
        if rhs.shape[0] < n:
            rhs = torch.cat([rhs, rhs.new_zeros((n - rhs.shape[0],) + rhs.shape[1:])])
        return rhs

    @highest_precision()
    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        """R x = y[:cols] for ``y [n]`` or ``[n, k]``."""
        return upper_solve(self._square_r(), self._padded_rhs(y))

    def _coerce(self, mat) -> torch.Tensor:
        if isinstance(mat, SparseCSR):
            mat = mat.to_dense()
        # host data goes to the card unless the solver names a device
        return _device.as_tensor(mat, getattr(self, "device", None), getattr(self, "dtype", None))

    def _adopt_factors(self, m, n, Y, T, R, health) -> None:
        """Take factors computed by an enclosing fused program
        (``BlockAngularQR``'s fused dense path), with the post-conditions of
        :meth:`compute`."""
        self._m, self._n = int(m), int(n)
        self._Y, self._T, self._R = Y, T, R
        self._programs.bind_eager()
        self._set_success(health)


class DenseHouseholderQR(_DenseQRBase):
    """Blocked dense Householder QR (Eigen::HouseholderQR analog)."""

    def compute(self, mat) -> "DenseHouseholderQR":
        a = self._coerce(mat)
        self._m, self._n = map(int, a.shape)
        self._Y, self._T, self._R, health = self._programs.factorize(
            self, "DenseHouseholderQR.compute", (), lambda s, a: _dense_qr_h(a), a
        )
        self._set_success(health)
        return self


class DenseColPivQR(_DenseQRBase):
    """Column-pivoted dense QR (Eigen::ColPivHouseholderQR analog)."""

    _health_check_zero_pivot = False  # rank-revealing: deficiency reported via rank

    def compute(self, mat) -> "DenseColPivQR":
        a = self._coerce(mat)
        self._m, self._n = map(int, a.shape)
        self._Y, self._T, self._R, perm, health = self._programs.factorize(
            self, "DenseColPivQR.compute", (), lambda s, a: _dense_colpiv_qr_h(a), a
        )
        # the pivot order stays on the device: fetching it here would make
        # every compute wait for the device; cols_permutation() fetches it
        self._perm_dev = perm
        self._perm = None
        self._set_success(health)
        return self

    def cols_permutation(self) -> Permutation:
        if self._perm is None:
            self._perm = Permutation(self._perm_dev.cpu().numpy().astype(np.int64))
        return self._perm

    def _adopt_factors(self, m, n, Y, T, R, health, perm_dev=None) -> None:
        super()._adopt_factors(m, n, Y, T, R, health)
        self._perm_dev = perm_dev
        self._perm = None

    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        """Rank-aware basic solution: column pivoting clusters dead pivots at
        the tail, so the masked leading solve is the exact least-squares
        minimizer over solutions supported on the live pivot columns (wide
        input included: the trapezoid embeds in a square with identity dead
        rows); ``y [n]`` or ``[n, k]``, the mask on each column."""
        k = rank_from_diag(torch.diagonal(self._R[: min(self._m, self._n)]), self._m, self._n)
        return rank_masked_solve(self._square_r(), self._padded_rhs(y), k)

    @property
    def rank(self) -> int:
        d = torch.diagonal(self._R[: min(self._m, self._n)])
        return int(rank_from_diag(d, self._m, self._n).item())
