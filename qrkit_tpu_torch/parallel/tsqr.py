"""TSQR: two-stage tall-skinny QR, on one device or over a mesh.

Counterpart of ``qrkit_tpu/parallel/tsqr.py`` (``tsqr_factorize``,
``tsqr_apply``, ``TSQRDenseQR``).  Each shard's row panel is factored
independently (one batched compact-WY QR), the per-shard R factors are
stacked, and a second QR of the stack gives the global factor.  Implicit Q
is the two-level composition ``Q = blkdiag(Q_local_i) · (E Q₂ Eᵀ + I − EEᵀ)
· P_selᵀ`` with E embedding the stacked-R rows; ``apply_q``/``apply_qt`` run
it as two compact-WY stages plus reshapes.

Without a mesh ``n_shards`` is a batch axis on one device.  With ``mesh=``
each rank factors its contiguous chunk of the shards (``shard_sizes``: the
chunks may differ by one shard), one all-gather of the ``[n_shards·n, n]`` R
stack is the only collective of the factorization, and the second stage
runs replicated.  Q products take and return global operands; each gathers
the per-shard stage's output.
"""
from __future__ import annotations

import torch

from .. import _device
from .._program import Programs
from ..ops.householder import apply_wy, highest_precision, panel_qr_yt, upper_solve
from ..solvers.base import ComputationInfo, QRSolver
from ..sparse import SparseCSR
from .mesh import all_gather_leading, mesh_rank, shard_bounds, shard_sizes

__all__ = ["tsqr_apply", "tsqr_factorize", "TSQRDenseQR"]


def _shards(n_shards: int, mesh, axis: str):
    """([lo, hi) of this rank's shards, every rank's shard count)."""
    if mesh is None:
        return 0, n_shards, None
    lo, hi = shard_bounds(n_shards, mesh, axis, even=False)
    return lo, hi, shard_sizes(n_shards, mesh_rank(mesh, axis)[1])


def _gather_shards(t: torch.Tensor, sizes, mesh, axis: str) -> torch.Tensor:
    """Every rank's per-shard outputs ``[own shards, ...]`` → ``[n_shards,
    ...]`` (the identity without a mesh)."""
    return t if mesh is None else all_gather_leading(t, mesh, axis, sizes)


@highest_precision()
def tsqr_factorize(a: torch.Tensor, n_shards: int, *, mesh=None, axis: str = "dp"):
    """Two-stage TSQR of ``[m, n]`` (m divisible by n_shards, m/n_shards >= n).

    Returns ``(Yl [s, mloc, n], Tl [s, n, n], Y2 [s*n, n], T2 [n, n], R [n, n])``;
    with ``mesh=``, ``Yl``/``Tl`` hold this rank's shards only and ``a`` is the
    global matrix (every rank reads its own rows)."""
    m, n = a.shape
    mloc = m // n_shards
    lo, hi, sizes = _shards(n_shards, mesh, axis)
    Yl, Tl, Rl = panel_qr_yt(a[lo * mloc : hi * mloc].reshape(hi - lo, mloc, n))  # local stage
    r_stack = _gather_shards(torch.triu(Rl)[:, :n], sizes, mesh, axis).reshape(n_shards * n, n)
    Y2, T2, R2 = panel_qr_yt(r_stack)  # second stage (tiny, replicated)
    return Yl, Tl, Y2, T2, torch.triu(R2)[:n]


@highest_precision()
def tsqr_apply(
    Yl, Tl, Y2, T2, v: torch.Tensor, n_shards: int, transpose: bool, *, mesh=None, axis: str = "dp"
) -> torch.Tensor:
    """Apply the implicit two-level Q (or Qᵀ) to a global ``[m]`` or ``[m, k]``."""
    vec = v.dim() == 1
    v2 = v[:, None] if vec else v
    k = v2.shape[1]
    s = n_shards
    mloc, n = Yl.shape[1], Yl.shape[2]
    lo, hi, sizes = _shards(s, mesh, axis)
    if transpose:
        w = apply_wy(Yl, Tl, v2[lo * mloc : hi * mloc].reshape(hi - lo, mloc, k), transpose=True)
        w = _gather_shards(w, sizes, mesh, axis)
        subset = w[:, :n].reshape(s * n, k)
        rest = w[:, n:].reshape(s * (mloc - n), k)
        out = torch.cat([apply_wy(Y2, T2, subset, transpose=True), rest], dim=0)
    else:
        z = apply_wy(Y2, T2, v2[: s * n])
        w = torch.cat([z.reshape(s, n, k), v2[s * n :].reshape(s, mloc - n, k)], dim=1)
        out = _gather_shards(apply_wy(Yl, Tl, w[lo:hi]), sizes, mesh, axis).reshape(s * mloc, k)
    return out[:, 0] if vec else out


def _factorize_program(self, mat: torch.Tensor):
    """:meth:`TSQRDenseQR.compute`'s device part: the rows zero-padded to
    whole shards, then the two-stage factorization (one all-gather over a
    mesh)."""
    if self._mpad != self._m:
        mat = torch.cat([mat, mat.new_zeros((self._mpad - self._m, self._n))], dim=0)
    return tsqr_factorize(mat, self._s_eff, mesh=self.mesh, axis=self.axis)


def _apply(self, m: torch.Tensor, transpose: bool) -> torch.Tensor:
    return tsqr_apply(
        self.Yl, self.Tl, self.Y2, self.T2, self._pad(m), self._s_eff, transpose,
        mesh=self.mesh, axis=self.axis,
    )[: self._m]


def _apply_q_program(self, m: torch.Tensor) -> torch.Tensor:
    return _apply(self, m, False)


def _apply_qt_program(self, m: torch.Tensor) -> torch.Tensor:
    return _apply(self, m, True)


@highest_precision()
def _solve_r_program(self, y: torch.Tensor) -> torch.Tensor:
    return upper_solve(self._R, y[: self._n])


class TSQRDenseQR(QRSolver):
    """Dense tall-skinny QR with the row panels factored as ``n_shards``
    independent shards, then combined: a drop-in right solver for
    :class:`~qrkit_tpu_torch.solvers.block_angular.BlockAngularQR`, same
    protocol as :class:`~qrkit_tpu_torch.solvers.dense.DenseHouseholderQR`.
    Rows are zero-padded to a multiple of the shard count (padded rows pass
    through Q untouched).  With ``mesh=`` (a ``DeviceMesh``; every rank
    calls with the same global matrix) each rank factors its chunk of the
    shards and keeps only their local factors; every result is global.

    On the card ``compute``'s factorization (the reference's jitted
    ``tsqr_factorize``), ``apply_q``, ``apply_qt`` (``tsqr_apply``) and
    ``solve_r`` are each one captured program
    (:mod:`~qrkit_tpu_torch._program`), with a mesh or without one: the
    factors are the factorize program's outputs, and over a mesh each graph
    holds its all-gather."""

    def __init__(self, n_shards: int, mesh=None, axis: str = "dp"):
        self.s = n_shards
        self.mesh = mesh
        self.axis = axis
        self._programs = Programs()

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
        self.Yl, self.Tl, self.Y2, self.T2, self._R = self._programs.factorize(
            self, "TSQRDenseQR.factorize", s, _factorize_program, mat,
            mesh=self.mesh, axis=self.axis,
        )
        self._info = ComputationInfo.SUCCESS
        return self

    def _adopt_factors(self, Yl, Tl, Y2, T2, R) -> None:
        """Take the factors of an enclosing program whose function ran
        :meth:`compute` inline (``BlockAngularQR``'s sparse-A2 recompute):
        its outputs, which its replays overwrite."""
        self.Yl, self.Tl, self.Y2, self.T2, self._R = Yl, Tl, Y2, T2, R
        self._programs.bind_eager()

    def _pad(self, v: torch.Tensor) -> torch.Tensor:
        if self._mpad == self._m:
            return v
        return torch.cat([v, v.new_zeros((self._mpad - self._m,) + tuple(v.shape[1:]))], dim=0)

    def apply_q(self, m: torch.Tensor) -> torch.Tensor:
        return self._programs.solve(self, "TSQRDenseQR.apply_q", (), _apply_q_program, m,
                                    mesh=self.mesh, axis=self.axis)

    def apply_qt(self, m: torch.Tensor) -> torch.Tensor:
        return self._programs.solve(self, "TSQRDenseQR.apply_qt", (), _apply_qt_program, m,
                                    mesh=self.mesh, axis=self.axis)

    def matrix_r_dense(self) -> torch.Tensor:
        R = self._R.new_zeros((self._m, self._n))
        R[: self._n] = self._R
        return R

    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        return self._programs.solve(self, "TSQRDenseQR.solve_r", (), _solve_r_program, y)
