"""Block-diagonal QR on torch tensors: batched dense QR, or the CUDA kernels.

Counterpart of ``qrkit_tpu/solvers/block_diagonal.py`` (``QFormat``,
``BlockDiagonalQR``).  Two tiers share the protocol:

* the batched-torch tier: per-block compact-WY QR (optionally column
  pivoted) over the ``[nb, br, bc]`` batch, explicit ``Q [nb, br, br]`` and
  ``R [nb, k, bc]``;
* the kernel tier (``_kernel_compute`` / ``_kernel_solve_vec``, the
  reference's ``_pallas_compute`` / ``_pallas_solve_vec``): ``compute`` runs
  the packed-R kernel on the SoA operand and keeps the operand resident as
  the implicit Q; a vector ``solve`` is one fused QR + solve kernel launch.
  Dense Q/R materialize lazily, only for the surfaces that need them.

Q formats:
* ``FULL_Q``:           Q columns ordered [all economy blocks | all
                        complements]; R is globally upper-triangular.
* ``BLOCK_DIAGONAL_Q``: Q is block-diagonal; R upper-triangular only up to a
                        row permutation.
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from ..containers import BlockDiagonal
from ..functional import block_diagonal_factorize
from ..ops.blockdiag import block_diagonal_lstsq_soa, block_diagonal_qr_r_soa, to_aos
from ..ops.householder import (
    highest_precision,
    rank_from_diag,
    rank_masked_triangular_solve,
)
from ..sparse import Permutation, SparseCSR
from .base import QRSolver, _diag_health

__all__ = ["QFormat", "BlockDiagonalQR"]


class QFormat(enum.Enum):
    FULL_Q = 0
    BLOCK_DIAGONAL_Q = 1


def _diag_rows(bc: int):
    """Rows of the packed (j, c >= j) R holding the diagonal."""
    return [j * bc - j * (j - 1) // 2 for j in range(bc)]


def _packed_diag(r_soa: torch.Tensor, bc: int, ncols: int) -> torch.Tensor:
    # stack row views rather than index with a host list: list indexing
    # copies the index to the device from pageable memory, a host sync
    d = torch.stack([r_soa[i] for i in _diag_rows(bc)], dim=1).reshape(-1)
    return _pad_to(d, ncols)


def _pad_to(v: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-extend a vector to length n (zero tail columns), or cut it."""
    if v.shape[0] < n:
        v = torch.cat([v, v.new_zeros(n - v.shape[0])])
    return v[:n]


@highest_precision()
def _kernel_compute(a_soa: torch.Tensor, *, br: int, ncols: int):
    """Kernel-tier factorize: packed R from the CUDA kernel (plain version on
    a CPU tensor) and the health flag from its diagonal, all on the device.
    Returns ``(r_soa [ntri, nb], health)``."""
    bc = a_soa.shape[0] // br
    r_soa = block_diagonal_qr_r_soa(a_soa, br)
    return r_soa, _diag_health(_packed_diag(r_soa, bc, ncols), check_zero=True)


@highest_precision()
def _kernel_solve_vec(a_soa: torch.Tensor, b: torch.Tensor, *, br: int, ncols: int, nb: int):
    """Kernel-tier least-squares solve against the resident SoA operand:
    relayout b, one fused QR + solve launch, relayout x.  The rhs tail past
    nb*br is ignored; x is zero-padded past nb*bc (zero tail columns)."""
    b_soa = b[: nb * br].reshape(nb, br).T.contiguous()
    x = block_diagonal_lstsq_soa(a_soa, b_soa).T.reshape(-1)
    return _pad_to(x, ncols)


class BlockDiagonalQR(QRSolver):
    """QR of a :class:`~qrkit_tpu_torch.containers.BlockDiagonal` matrix.

    ``pivot=True`` uses per-block column pivoting (the reference's default
    ``ColPivHouseholderQR`` block solver) and composes the per-block
    permutations into the global column permutation.

    ``use_kernel`` picks the tier: ``"auto"`` runs the CUDA kernels for a
    CUDA operand of a supported geometry (non-pivoting, portrait blocks with
    br*bc <= 64, nrows >= nb*br); ``True`` demands the kernel tier (raising
    if the geometry is unsupported; on a CPU operand that tier runs the
    kernels' plain versions); ``False`` keeps the batched-torch tier.  Both
    float32 and float64 run in the kernel tier.
    """

    def __init__(
        self,
        q_format: QFormat = QFormat.FULL_Q,
        pivot: bool = True,
        use_kernel="auto",
    ):
        if use_kernel not in ("auto", True, False):
            raise ValueError(f"use_kernel must be 'auto', True or False, got {use_kernel!r}")
        self.q_format = q_format
        self.pivot = pivot
        self.use_kernel = use_kernel
        self._kernel_mode = False
        self._health_check_zero_pivot = not pivot
        self._computed = False

    def _kernel_supported(self, mat: BlockDiagonal) -> bool:
        br, bc = mat.block_rows, mat.block_cols
        return (
            not self.pivot
            and br >= bc
            and br * bc <= 64
            and mat.nrows >= mat.num_blocks * br
        )

    def _kernel_active(self, mat: BlockDiagonal) -> bool:
        if self.use_kernel is False:
            return False
        sup = self._kernel_supported(mat)
        if self.use_kernel is True:
            if not sup:
                raise ValueError(
                    "use_kernel=True but this factorization is not supported by "
                    "the kernel tier (needs pivot=False and portrait blocks with "
                    "br*bc <= 64); use use_kernel='auto'"
                )
            return True
        return sup and mat.device.type == "cuda"

    # --- QRSolver shape -----------------------------------------------------------
    @property
    def rows(self) -> int:
        return self._nrows

    @property
    def cols(self) -> int:
        return self._ncols

    # --- factorization ------------------------------------------------------------
    def compute(
        self, mat: BlockDiagonal, row_perm: Optional[Permutation] = None
    ) -> "BlockDiagonalQR":
        # Landscape (cols > rows) blocks yield a full [br, br] Q and a wide
        # upper-trapezoidal R, so Q is block-diagonal under both formats and
        # the stacked R rows are already globally upper-triangular.
        self._landscape = mat.block_cols > mat.block_rows
        self._nrows, self._ncols = mat.nrows, mat.ncols
        self._nb = mat.num_blocks
        self._br, self._bc = mat.block_rows, mat.block_cols
        # None stands for the identity, built only if asked for: an explicit
        # identity is O(nrows) host work (56 MB at 1M 7x2 blocks) per compute
        self._row_perm = row_perm
        self._kernel_mode = self._kernel_active(mat)
        if self._kernel_mode:
            self._a_soa = mat.soa()
            self._r_soa, health = _kernel_compute(self._a_soa, br=self._br, ncols=self._ncols)
            self.Q = self.R = None
            self._local_perm = None
            self._computed = True
            self._set_success(health)
            return self

        self.Q, self.R, local_perm = block_diagonal_factorize(mat.blocks, pivot=self.pivot)
        # the pivot order stays on the device; cols_permutation() fetches it
        # on first use, and solve() scatters with it on the device
        self._local_perm = local_perm if self.pivot else None
        self._computed = True
        self._set_success()
        return self

    def _adopt_factors(self, mat: BlockDiagonal, Q, R, health) -> None:
        """Take factors computed by an enclosing fused program
        (``BlockAngularQR``'s fused dense path), with the post-conditions of
        :meth:`compute` for the non-pivoting portrait case in the
        batched-torch tier."""
        if self.pivot:
            raise ValueError("_adopt_factors takes non-pivoting factors only")
        self._kernel_mode = False
        self._landscape = mat.block_cols > mat.block_rows
        self._nrows, self._ncols = mat.nrows, mat.ncols
        self._nb = mat.num_blocks
        self._br, self._bc = mat.block_rows, mat.block_cols
        self._row_perm = None
        self.Q, self.R = Q, R
        self._local_perm = None
        self._computed = True
        self._set_success(health)

    def _ensure_dense_factors(self) -> None:
        """Materialize the explicit per-block Q/R batch from the kernel
        tier's resident SoA operand — only for the surfaces that need a
        dense factor (sparse exports, applies, solve_r, matrix rhs)."""
        if not self._kernel_mode or self.Q is not None:
            return
        blocks = to_aos(self._a_soa, self._br, self._bc)
        self.Q, self.R, _ = block_diagonal_factorize(blocks, pivot=False)

    def r_diagonal(self) -> torch.Tensor:
        """Pivot diagonal of R straight from the factors — no dense R.
        Portrait: [ncols] (columns past nb*bc report 0).  Landscape: the
        nb*br leading pivots."""
        if self._kernel_mode:
            return _packed_diag(self._r_soa, self._bc, self._ncols)
        d = torch.diagonal(self.R, dim1=1, dim2=2).reshape(-1)
        if self._landscape:
            return d
        return _pad_to(d, self._ncols)

    # --- Q application ------------------------------------------------------------
    def _index_maps(self, device):
        """(econ_rows, comp_rows) destination rows for FULL_Q coordinates;
        complement columns start right after the nb*bc economy columns."""
        nb, br, bc = self._nb, self._br, self._bc
        econ = (np.arange(nb)[:, None] * bc + np.arange(bc)).reshape(-1)
        comp_w = br - bc
        comp = (nb * bc + np.arange(nb)[:, None] * comp_w + np.arange(comp_w)).reshape(-1)
        return torch.as_tensor(econ, device=device), torch.as_tensor(comp, device=device)

    def _block_diagonal_q(self) -> bool:
        return self.q_format == QFormat.BLOCK_DIAGONAL_Q or self._landscape

    @highest_precision()
    def apply_qt(self, m: torch.Tensor) -> torch.Tensor:
        self._ensure_dense_factors()
        vec = m.dim() == 1
        m2 = m[:, None] if vec else m
        k = m2.shape[1]
        nb, br, bc = self._nb, self._br, self._bc
        outb = torch.einsum("bij,bik->bjk", self.Q, m2[: nb * br].reshape(nb, br, k))
        if self._block_diagonal_q():
            out = torch.cat([outb.reshape(nb * br, k), m2[nb * br :]], dim=0)
        else:
            econ, comp = self._index_maps(m2.device)
            out = torch.empty_like(m2)
            out[econ] = outb[:, :bc].reshape(nb * bc, k)
            out[comp] = outb[:, bc:].reshape(nb * (br - bc), k)
            out[nb * br :] = m2[nb * br :]  # zero-tail rows: identity Q
        return out[:, 0] if vec else out

    @highest_precision()
    def apply_q(self, m: torch.Tensor) -> torch.Tensor:
        self._ensure_dense_factors()
        vec = m.dim() == 1
        m2 = m[:, None] if vec else m
        k = m2.shape[1]
        nb, br, bc = self._nb, self._br, self._bc
        if self._block_diagonal_q():
            coords = m2[: nb * br].reshape(nb, br, k)
        else:
            econ, comp = self._index_maps(m2.device)
            coords = torch.cat(
                [m2[econ].reshape(nb, bc, k), m2[comp].reshape(nb, br - bc, k)], dim=1
            )
        outb = torch.einsum("bij,bjk->bik", self.Q, coords)
        out = torch.cat([outb.reshape(nb * br, k), m2[nb * br :]], dim=0)
        return out[:, 0] if vec else out

    # --- R --------------------------------------------------------------------------
    def matrix_r_dense(self) -> torch.Tensor:
        self._ensure_dense_factors()
        nb, br, bc = self._nb, self._br, self._bc
        k = min(br, bc)
        if self._landscape:
            row_stride = br  # both formats: stacked rows are upper-triangular
        else:
            row_stride = bc if self.q_format == QFormat.FULL_Q else br
        R = self.R.new_zeros((self._nrows, self._ncols))
        i = torch.arange(nb, device=R.device)
        rows = i[:, None] * row_stride + torch.arange(k, device=R.device)
        cols = i[:, None] * bc + torch.arange(bc, device=R.device)
        R[rows[:, :, None], cols[:, None, :]] = self.R
        return R

    @highest_precision()
    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        self._ensure_dense_factors()
        if self._landscape:
            return self._solve_r_landscape(y)
        if self.q_format != QFormat.FULL_Q:
            raise ValueError("solve_r requires QFormat.FULL_Q")
        nb, br, bc = self._nb, self._br, self._bc
        yb = y[: nb * bc].reshape(nb, bc)
        if self.pivot:
            # per-block rank-masked basic solution: ColPiv clusters each
            # block's dead pivots at its tail
            ks = rank_from_diag(torch.diagonal(self.R, dim1=1, dim2=2), br, bc)
            xb = rank_masked_triangular_solve(self.R, yb, ks)
        else:
            xb = torch.linalg.solve_triangular(self.R, yb[..., None], upper=True)[..., 0]
        return _pad_to(xb.reshape(nb * bc), self._ncols)

    def _solve_r_landscape(self, y: torch.Tensor) -> torch.Tensor:
        """Basic solution of the underdetermined per-block systems: the wide
        [br, bc] trapezoid is embedded in a [bc, bc] triangle whose tail rows
        are identity, so x is supported only on the leading pivot columns."""
        nb, br, bc = self._nb, self._br, self._bc
        yb = y[: nb * br].reshape(nb, br)
        rhs = torch.cat([yb, yb.new_zeros((nb, bc - br))], dim=1)
        eye_tail = torch.eye(bc, dtype=self.R.dtype, device=self.R.device)[br:]
        Rsq = torch.cat([self.R, eye_tail.expand(nb, bc - br, bc)], dim=1)
        if self.pivot:
            ks = rank_from_diag(torch.diagonal(self.R[:, :br], dim1=1, dim2=2), br, bc)
            xb = rank_masked_triangular_solve(Rsq, rhs, ks)
        else:
            xb = torch.linalg.solve_triangular(Rsq, rhs[..., None], upper=True)[..., 0]
        return _pad_to(xb.reshape(nb * bc), self._ncols)

    @highest_precision()
    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Least-squares solve.  In the kernel tier a vector rhs is ONE fused
        QR + solve kernel launch against the resident SoA operand; a matrix
        rhs and the batched-torch tier use the generic path."""
        if self._kernel_mode and b.dim() == 1:
            return _kernel_solve_vec(
                self._a_soa, b, br=self._br, ncols=self._ncols, nb=self._nb
            )
        return super().solve(b)

    def _unpermute(self, z: torch.Tensor) -> torch.Tensor:
        """Per-block pivot scatter on the device (no host fetch of the pivots):
        x[i*bc + perm[i, j]] = z[i*bc + j]."""
        if self._local_perm is None:
            return z
        nb, bc = self._nb, self._bc
        head = z[: nb * bc].reshape((nb, bc) + z.shape[1:])
        idx = self._local_perm.reshape((nb, bc) + (1,) * (z.dim() - 1)).expand(head.shape)
        return torch.cat([torch.zeros_like(head).scatter(1, idx, head).reshape(
            (nb * bc,) + z.shape[1:]), z[nb * bc :]])

    def cols_permutation(self) -> Permutation:
        if self._local_perm is None:
            return Permutation.identity(self._ncols)
        lp = self._local_perm.cpu().numpy()
        base = np.arange(self._nb)[:, None] * self._bc
        return Permutation(
            np.concatenate([(base + lp).reshape(-1), np.arange(self._nb * self._bc, self._ncols)])
        )

    def rows_permutation(self) -> Permutation:
        if self._row_perm is None:
            return Permutation.identity(self._nrows)
        return self._row_perm

    def matrix_r_sparse(self) -> SparseCSR:
        """Sparse R in O(nnz(R)): block-diagonal of per-block upper triangles;
        landscape blocks contribute their wide trapezoids at rows ``i*br``."""
        self._ensure_dense_factors()
        Rb = self.R.detach().cpu().numpy()
        nb, k, bc = Rb.shape
        r, c = np.triu_indices(k, 0, bc)
        row_stride = self._br if self._landscape else bc
        rows = (np.arange(nb)[:, None] * row_stride + r[None, :]).ravel()
        cols = (np.arange(nb)[:, None] * bc + c[None, :]).ravel()
        vals = Rb[:, r, c].ravel()
        keep = vals != 0.0  # the reference prunes exact zeros
        return SparseCSR.from_triplets(
            rows[keep], cols[keep], vals[keep], (self._nrows, self._ncols)
        )

    def matrix_q_sparse(self) -> SparseCSR:
        """Explicit sparse Q in O(nb·br²): FULL_Q orders columns [all economy
        blocks | all complements] (+ identity on zero tail rows);
        BLOCK_DIAGONAL_Q is block-diagonal."""
        self._ensure_dense_factors()
        nb, br, bc = self._nb, self._br, self._bc
        Qb = self.Q.detach().cpu().numpy()
        i = np.arange(nb)[:, None, None]
        r = np.arange(br)[None, :, None]
        c = np.arange(br)[None, None, :]
        rows = np.broadcast_to(i * br + r, (nb, br, br)).reshape(-1)
        if self._block_diagonal_q():
            cols = i * br + c
        else:
            cols = np.where(c < bc, i * bc + c, nb * bc + i * (br - bc) + (c - bc))
        cols = np.broadcast_to(cols, (nb, br, br)).reshape(-1)
        vals = Qb.reshape(-1)
        tail = np.arange(nb * br, self._nrows)
        rows = np.concatenate([rows, tail])
        cols = np.concatenate([cols, tail])
        vals = np.concatenate([vals, np.ones(tail.size, vals.dtype)])
        return SparseCSR.from_triplets(rows, cols, vals, (self._nrows, self._nrows))

    @property
    def rank(self) -> int:
        """Numerical rank = sum of per-block ranks (pivot=True only; without
        pivoting this reports min(rows, cols) like the reference
        HouseholderQR)."""
        if not self.pivot:
            return min(self._ncols, self._nb * self._br)
        d = torch.diagonal(self.R, dim1=1, dim2=2)
        return int(rank_from_diag(d, self._br, self._bc).sum().item())
