"""TSQR: two-stage tall-skinny QR, on one device.

Counterpart of ``qrkit_tpu/parallel/tsqr.py`` (``tsqr_factorize``,
``tsqr_apply``, ``TSQRDenseQR``) without a mesh: ``n_shards`` is a batch
axis.  Each shard's row panel is factored independently (one batched
compact-WY QR), the per-shard R factors are stacked, and a second QR of the
stack gives the global factor.  Implicit Q is the two-level composition
``Q = blkdiag(Q_local_i) · (E Q₂ Eᵀ + I − EEᵀ) · P_selᵀ`` with E embedding the
stacked-R rows; ``apply_q``/``apply_qt`` run it as two compact-WY stages
plus reshapes.  The distributed form (``mesh=``, ``torch.distributed``)
belongs to the mesh slice of the port.
"""
from __future__ import annotations

import torch

from .. import _device
from ..ops.householder import apply_wy, highest_precision, panel_qr_yt
from ..solvers.base import ComputationInfo, QRSolver
from ..sparse import SparseCSR

__all__ = ["tsqr_apply", "tsqr_factorize", "TSQRDenseQR"]


@highest_precision()
def tsqr_factorize(a: torch.Tensor, n_shards: int):
    """Two-stage TSQR of ``[m, n]`` (m divisible by n_shards, m/n_shards >= n).

    Returns ``(Yl [s, mloc, n], Tl [s, n, n], Y2 [s*n, n], T2 [n, n], R [n, n])``.
    """
    m, n = a.shape
    mloc = m // n_shards
    Yl, Tl, Rl = panel_qr_yt(a.reshape(n_shards, mloc, n))  # local stage, batched
    r_stack = torch.triu(Rl)[:, :n].reshape(n_shards * n, n)
    Y2, T2, R2 = panel_qr_yt(r_stack)  # second stage (tiny)
    return Yl, Tl, Y2, T2, torch.triu(R2)[:n]


@highest_precision()
def tsqr_apply(Yl, Tl, Y2, T2, v: torch.Tensor, n_shards: int, transpose: bool) -> torch.Tensor:
    """Apply the implicit two-level Q (or Qᵀ) to ``[m]`` or ``[m, k]``."""
    vec = v.dim() == 1
    v2 = v[:, None] if vec else v
    k = v2.shape[1]
    s = n_shards
    mloc, n = Yl.shape[1], Yl.shape[2]
    if transpose:
        w = apply_wy(Yl, Tl, v2.reshape(s, mloc, k), transpose=True)
        subset = w[:, :n].reshape(s * n, k)
        rest = w[:, n:].reshape(s * (mloc - n), k)
        out = torch.cat([apply_wy(Y2, T2, subset, transpose=True), rest], dim=0)
    else:
        z = apply_wy(Y2, T2, v2[: s * n])
        w = torch.cat([z.reshape(s, n, k), v2[s * n :].reshape(s, mloc - n, k)], dim=1)
        out = apply_wy(Yl, Tl, w).reshape(s * mloc, k)
    return out[:, 0] if vec else out


class TSQRDenseQR(QRSolver):
    """Dense tall-skinny QR with the row panels factored as ``n_shards``
    independent shards, then combined: a drop-in right solver for
    :class:`~qrkit_tpu_torch.solvers.block_angular.BlockAngularQR`, same
    protocol as :class:`~qrkit_tpu_torch.solvers.dense.DenseHouseholderQR`.
    Rows are zero-padded to a multiple of the shard count (padded rows pass
    through Q untouched).  ``mesh=`` (one shard per device) belongs to the
    mesh slice of the port."""

    def __init__(self, n_shards: int, mesh=None, axis: str = "dp"):
        if mesh is not None:
            raise NotImplementedError(
                "TSQRDenseQR(mesh=...) belongs to the mesh slice of the port "
                "(torch.distributed); use mesh=None"
            )
        self.s = n_shards
        self.mesh = None
        self.axis = axis

    @property
    def rows(self) -> int:
        return self._m

    @property
    def cols(self) -> int:
        return self._n

    def compute(self, mat) -> "TSQRDenseQR":
        if isinstance(mat, SparseCSR):
            mat = mat.to_dense()
        mat = _device.as_tensor(mat)  # host data goes to the card
        self._m, self._n = map(int, mat.shape)
        # an effective shard count such that every shard (in particular the
        # last, which takes the zero padding at its tail) holds >= n real
        # rows: padded rows stay out of the stacked-R subset, so Q is the
        # identity on them and cutting the output is exact
        s = max(1, self.s)
        while s > 1:
            mloc = max(-(-self._m // s), self._n)
            if self._m - (s - 1) * mloc >= self._n:
                break
            s -= 1
        self._s_eff = s
        mloc = max(-(-self._m // s), self._n)
        self._mpad = mloc * s
        if self._mpad != self._m:
            mat = torch.cat([mat, mat.new_zeros((self._mpad - self._m, self._n))], dim=0)
        self.Yl, self.Tl, self.Y2, self.T2, self._R = tsqr_factorize(mat, s)
        self._info = ComputationInfo.SUCCESS
        return self

    def _pad(self, v: torch.Tensor) -> torch.Tensor:
        if self._mpad == self._m:
            return v
        return torch.cat([v, v.new_zeros((self._mpad - self._m,) + tuple(v.shape[1:]))], dim=0)

    def apply_q(self, m: torch.Tensor) -> torch.Tensor:
        return tsqr_apply(
            self.Yl, self.Tl, self.Y2, self.T2, self._pad(m), self._s_eff, False
        )[: self._m]

    def apply_qt(self, m: torch.Tensor) -> torch.Tensor:
        return tsqr_apply(
            self.Yl, self.Tl, self.Y2, self.T2, self._pad(m), self._s_eff, True
        )[: self._m]

    def matrix_r_dense(self) -> torch.Tensor:
        R = self._R.new_zeros((self._m, self._n))
        R[: self._n] = self._R
        return R

    @highest_precision()
    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        return torch.linalg.solve_triangular(self._R, y[: self._n, None], upper=True)[:, 0]
