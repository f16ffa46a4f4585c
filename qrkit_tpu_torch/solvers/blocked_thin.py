"""Blocked thin QR: tall, mostly dense matrices in fixed-width panels.

Counterpart of ``qrkit_tpu/solvers/blocked_thin.py`` (``BlockedThinDenseQR``,
``BlockedThinSparseQR``, ``_panel_starts``, ``_thin_dense_factorize``,
``_thin_finish_r``), the reference's ``BlockedThinQRBase`` /
``BlockedThinDenseQR`` / ``BlockedThinSparseQR``.  A left-looking panel
factorization: per panel a compact-WY QR, then one trailing-update matrix
product; Q is a :class:`~qrkit_tpu_torch.ops.compact_wy.CompactWYSeq` whose
windows start at each panel's diagonal row.

The sparse variant adds the reference's orderings (column density, then
as-banded-as-possible rows), restricts each panel to its sparsity row
extent and pivots columns inside each panel, composing the pivots into the
output column permutation.  The reference groups the panels into
height-bucketed ``lax.scan`` runs only to bound TPU compile size; its own
docstring states the bucket padding is exact, so here the panels run as one
loop over their true extents, and every panel's pivot order stays on the
device until the first call that needs the column permutation or the rank.
The pattern work (orderings, panel heights, each value's place in the dense
working matrix) is cached per operand layout, so a same-layout compute
uploads the ``nnz`` values and, with ``fused=True`` (the default) on the
card, replays one captured program (:mod:`~qrkit_tpu_torch._program`):
the reference's fused height-bucketed factorize.  ``fused=False`` runs the
same loop eagerly.

No kernel: plain torch on either device (a panel wider than 32 columns goes
to the library's QR, :func:`~qrkit_tpu_torch.ops.householder.panel_qr_yt`).
"""
from __future__ import annotations

import functools
from typing import List, Union

import numpy as np
import torch

from .. import _device
from .._program import Programs
from ..analysis import as_banded_as_possible, column_density
from ..ops.compact_wy import CompactWYSeq
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

__all__ = ["BlockedThinDenseQR", "BlockedThinSparseQR"]


def _thin_finish_r(working: torch.Tensor, n: int, check_zero: bool):
    """(R, pivot diagonal, info() health flag), all on the device; R is
    ``working``, made upper triangular in place."""
    R = working.triu_()
    d = torch.diagonal(R[:n, :n])
    return R, d, _diag_health(d, check_zero=check_zero)


def _panel_starts(n: int, c: int) -> List[int]:
    return list(range(0, n, c))


@highest_precision()
def _thin_dense_factorize(A: torch.Tensor, c: int):
    """Panel loop over a dense ``[m, n]``: returns (Y [nb, m, c], T [nb, c, c],
    R [m, n]); the last panel is zero-padded to width c when n % c != 0."""
    m, n = A.shape
    Ys, Ts = [], []
    R = A.clone()
    for p0 in _panel_starts(n, c):
        pc = min(c, n - p0)
        Y, T, Rp = panel_qr_yt(R[:, p0 : p0 + pc], offset=p0)
        R[:, p0 : p0 + pc] = Rp
        if p0 + pc < n:
            R[:, p0 + pc :] = apply_wy(Y, T, R[:, p0 + pc :], transpose=True)
        if pc < c:  # pad the final narrow panel
            Y = torch.cat([Y, Y.new_zeros((m, c - pc))], dim=1)
            T = torch.nn.functional.pad(T, (0, c - pc, 0, c - pc))
        Ys.append(Y)
        Ts.append(T)
    return torch.stack(Ys), torch.stack(Ts), torch.triu(R)


def _thin_sparse_factorize(self, vals: torch.Tensor, plan: dict):
    """The values of one compute of :class:`BlockedThinSparseQR` into its
    factors, all on the device: the values scattered into the permuted
    dense ``working``, the panel loop over the planned heights, the WY
    stacks and R.  Returns (Y [nb, maxh, c], T [nb, c, c], R [m, n], pivot
    diagonal, health flag, in-panel pivots [n]).  Every panel writes into
    ``working`` and the stacks in place, so a captured program's pool holds
    little more than them (no trailing-update or stacking temporaries)."""
    m, n, c = self._m, self._n, self.c
    heights = plan["heights"]
    working = vals.new_zeros(m * n)
    working[plan["dest"]] = vals
    working = working.view(m, n)
    Y = vals.new_zeros((len(heights), max(heights), c))
    T = vals.new_zeros((len(heights), c, c))
    lperms = torch.empty(n, dtype=torch.int64, device=vals.device)
    for i, (p0, h) in enumerate(zip(_panel_starts(n, c), heights)):
        pc = min(c, n - p0)
        self._panel(working, p0, h, pc, Y[i, :h, :pc], T[i, :pc, :pc], lperms[p0 : p0 + pc])
    R, diag, health = _thin_finish_r(working, n=n, check_zero=self._health_check_zero_pivot)
    return Y, T, R, diag, health, lperms


class BlockedThinDenseQR(QRSolver):
    """Thin QR of a dense matrix in fixed-width panels, no permutations, not
    rank-revealing.  Host input (NumPy, ``SparseCSR``) goes to ``device``
    (default CUDA) in ``dtype`` (default: the input's); a tensor keeps its
    device unless ``device`` is given."""

    def __init__(self, suggested_block_cols: int = 2, *, device=None, dtype=None):
        self.c = suggested_block_cols
        self.device, self.dtype = device, dtype

    @property
    def rows(self) -> int:
        return self._m

    @property
    def cols(self) -> int:
        return self._n

    def compute(self, mat) -> "BlockedThinDenseQR":
        a = _device.as_tensor(
            mat.to_dense() if isinstance(mat, SparseCSR) else mat, self.device, self.dtype
        )
        self._m, self._n = map(int, a.shape)
        if self._n > 64:
            # wide input: one blocked QR of the whole matrix (the library's,
            # through panel_qr_yt) gives the same contract as the panel loop
            Y, T, R = panel_qr_yt(a)
            self.q_seq = CompactWYSeq.single(Y, T, 0, self._m)
            self._R = torch.triu(R)
        else:
            Y, T, self._R = _thin_dense_factorize(a, self.c)
            # every window spans the full height (Y is zero above its panel)
            self.q_seq = CompactWYSeq(Y, T, [0] * Y.shape[0], self._m)
        self._set_success()
        return self

    def apply_q(self, m: torch.Tensor) -> torch.Tensor:
        return self.q_seq.apply_q(m)

    def apply_qt(self, m: torch.Tensor) -> torch.Tensor:
        return self.q_seq.apply_qt(m)

    def matrix_r_dense(self) -> torch.Tensor:
        return self._R

    @highest_precision()
    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        n = self._n
        return upper_solve(self._R[:n, :n], y[:n])


class BlockedThinSparseQR(QRSolver):
    """Thin QR of a sparse (or dense) matrix with orderings and per-panel
    column pivoting.

    Each panel is restricted to its sparsity row extent, so the work tracks
    the structure, not the full height.  Zero-pivot columns are tracked into
    a Householder column permutation with an exact ``rank``; a rank-deficient
    solve completes the decomposition (one ColPiv QR of R) and returns the
    residual-optimal basic solution.  Host input goes to ``device`` (default
    CUDA) in ``dtype`` (default float64)."""

    _health_check_zero_pivot = False  # rank-revealing: deficiency reported via rank

    def __init__(self, suggested_block_cols: int = 2, fused: bool = True, *, device=None,
                 dtype=None):
        self.c = suggested_block_cols
        self.fused = fused
        self.device = _device.resolve(device)
        self.dtype = dtype if dtype is not None else torch.float64
        self._programs = Programs()

    @property
    def rows(self) -> int:
        return self._m

    @property
    def cols(self) -> int:
        return self._n

    def _analyze(self, mat: SparseCSR):
        col_perm = column_density(mat)
        pmat = mat.permute_cols(col_perm)
        row_perm, has_rp = as_banded_as_possible(pmat)
        if has_rp:
            pmat = pmat.permute_rows(row_perm)
        return pmat, col_perm, row_perm

    def _panel_heights(self, pmat: SparseCSR) -> List[int]:
        """Per panel, the rows down to the last nonzero of its columns, never
        shrinking by more than the panel width against the previous panel
        (the reference's ``updateBlockInfo``)."""
        m, n = pmat.shape
        heights = []
        prev_h = 0
        col_max_row = np.full(n, -1, dtype=np.int64)
        row_ids = np.repeat(np.arange(m), np.diff(pmat.indptr))
        np.maximum.at(col_max_row, pmat.indices, row_ids)
        for p0 in _panel_starts(n, self.c):
            pc = min(self.c, n - p0)
            if p0 + pc >= n:
                h = m - p0
            else:
                h = int(col_max_row[p0 : p0 + pc].max()) - p0 + 1
                h = max(h, prev_h - pc)
            h = max(h, pc)  # at least pc rows for a full-rank panel
            h = min(h, m - p0)
            heights.append(h)
            prev_h = h
        return heights

    @highest_precision()
    def _panel(self, working: torch.Tensor, p0: int, h: int, pc: int, Y_out, T_out, perm_out):
        """One panel: ColPiv QR of its ``[h, pc]`` extent, the column reorder
        over the full height (rows above the diagonal included, as the
        reference's R assembly), R into the panel and the trailing update,
        all in ``working``; its Y, T and pivot order into ``Y_out [h, pc]``,
        ``T_out [pc, pc]`` and ``perm_out [pc]``."""
        Y, taus, Rsub, lperm = colpiv_householder_qr(working[p0 : p0 + h, p0 : p0 + pc])
        Y_out.copy_(Y)
        T_out.copy_(build_t_factor(Y, taus))
        perm_out.copy_(lperm)
        working[:, p0 : p0 + pc] = working[:, p0 + lperm]
        working[p0 : p0 + h, p0 : p0 + pc] = torch.triu(Rsub)
        if p0 + pc < self._n:  # Qᵀ on the trailing columns: X += Y (Tᵀ (Yᵀ X)), in place
            X = working[p0 : p0 + h, p0 + pc :]
            X.addmm_(Y, T_out.mT @ (Y.mT @ X))

    def _plan(self, mat: SparseCSR) -> dict:
        """The pattern-only work of a compute, cached under the operand's
        layout: the orderings, the panel heights and each stored value's
        flat position in the permuted dense ``working`` (the CSR value
        order, so a compute uploads ``nnz`` values, not ``m·n``)."""
        key = (mat.pattern_fingerprint(), mat.shape, self.c, self.dtype, self.device)
        plan = getattr(self, "_plan_cache", None)
        if plan is not None and plan["key"] == key:
            return plan
        pmat, col_perm, row_perm = self._analyze(mat)
        m, n = mat.shape
        rows = np.repeat(np.arange(m), np.diff(mat.indptr))
        inv_cols = col_perm.inverse().indices  # old col -> new col
        dest = row_perm.indices[rows] * n + inv_cols[mat.indices]
        self._plan_cache = plan = dict(
            key=key, col_perm=col_perm, row_perm=row_perm, heights=self._panel_heights(pmat),
            dest=torch.as_tensor(dest, dtype=torch.int64, device=self.device),
            starts=torch.as_tensor(_panel_starts(n, self.c), dtype=torch.int64, device=self.device),
        )
        self._programs.drop("BlockedThinSparseQR.compute")  # they read the old maps
        return plan

    def compute(self, mat: Union[SparseCSR, np.ndarray]) -> "BlockedThinSparseQR":
        """Factorize: the pattern work once per layout (:meth:`_plan`), then
        the values uploaded and the panel loop (:func:`_thin_sparse_factorize`),
        one captured program on the card with ``fused=True``.  The
        in-panel pivots stay on the device until the first call that needs
        the column permutation or the rank."""
        if not isinstance(mat, SparseCSR):
            if isinstance(mat, torch.Tensor):
                mat = mat.detach().cpu().numpy()
            mat = SparseCSR.from_dense(np.asarray(mat))
        self._m, self._n = mat.shape
        plan = self._plan(mat)
        self._col_perm, self._row_perm = plan["col_perm"], plan["row_perm"]
        Y, T, self._R, self._diag_dev, health, self._lperms = self._programs.factorize(
            self, "BlockedThinSparseQR.compute", (),
            functools.partial(_thin_sparse_factorize, plan=plan), np.asarray(mat.data),
            capture=self.fused, upload=(self.device, self.dtype),
        )
        self.q_seq = CompactWYSeq(Y, T, plan["starts"], self._m)
        self._out_col_perm = None  # from the pivots, at the first use
        # the zero-pivot bookkeeping reads the diagonal lazily (first rank,
        # deficient_cols or rank-deficient solve), so compute never waits
        self._deficiency_cache = None
        self._repair = None  # lazy ColPiv factors of R for rank-deficient solves
        self._set_success(health)
        return self

    def _cols_perm(self) -> Permutation:
        """Output column permutation: the density ordering, then the
        in-panel pivots, fetched once: house[p0 + j] = p0 + lperm[j] (the
        reference's m_houseColPerm before the zero-pivot reorder)."""
        if self._out_col_perm is None:
            n, c = self._n, self.c
            house = (np.arange(n) // c) * c + self._lperms.cpu().numpy()
            self._out_col_perm = Permutation(self._col_perm.indices[house])
        return self._out_col_perm

    def _deficiency(self):
        """(exact rank, house column permutation), derived once from the
        pivots with Eigen's threshold eps·max(m, n)·max|pivot| (eps of the
        factors' dtype)."""
        if self._deficiency_cache is None:
            diag = np.abs(self._diag_dev.cpu().numpy())
            tol = (diag.max() if diag.size else 0.0) * max(self._m, self._n) * np.finfo(
                diag.dtype
            ).eps
            live = diag > tol
            rank = int(live.sum())
            order = np.concatenate([np.nonzero(live)[0], np.nonzero(~live)[0]])
            house_perm = np.empty(self._n, dtype=np.int64)
            house_perm[order] = np.arange(self._n)
            self._deficiency_cache = (rank, Permutation(house_perm))
        return self._deficiency_cache

    def house_cols_permutation(self) -> Permutation:
        """Permutation pushing the zero-pivot columns (in pivoted working
        order) to the back — the reference's ``m_houseColPerm``."""
        return self._deficiency()[1]

    def deficient_cols(self) -> np.ndarray:
        """Original column indices of the zero-pivot columns."""
        rank, house = self._deficiency()
        inv = house.inverse().indices  # newpos -> workingpos
        return np.asarray(self._cols_perm().indices)[inv[rank:]]

    def apply_q(self, m: torch.Tensor) -> torch.Tensor:
        return self.q_seq.apply_q(m)

    def apply_qt(self, m: torch.Tensor) -> torch.Tensor:
        return self.q_seq.apply_qt(m)

    def matrix_r_dense(self) -> torch.Tensor:
        return self._R

    @highest_precision()
    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        n = self._n
        R = self._R[:n, :n]
        if self._deficiency()[0] == n:
            return upper_solve(R, y[:n])
        # rank-deficient: per-panel pivoting leaves the dead pivots scattered,
        # so complete the decomposition with one n×n ColPiv QR of R
        # (R·P2 = Q2·R2, dead pivots now at the tail) and take the basic
        # solution, residual-optimal over the live pivot columns
        if self._repair is None:
            from .dense import _dense_colpiv_qr

            self._repair = _dense_colpiv_qr(R)
        Y2, T2, R2, perm2 = self._repair
        yq = apply_wy(Y2, T2, y[:n], transpose=True)
        k = rank_from_diag(torch.diagonal(R2[:n]), n, n)
        z = rank_masked_solve(torch.triu(R2[:n]), yq[:n], k)
        return torch.zeros_like(z).index_put_((perm2,), z)

    def cols_permutation(self) -> Permutation:
        return self._cols_perm()

    def rows_permutation(self) -> Permutation:
        return self._row_perm

    @property
    def rank(self) -> int:
        """Exact numerical rank from the R pivots (read lazily)."""
        return self._deficiency()[0]
