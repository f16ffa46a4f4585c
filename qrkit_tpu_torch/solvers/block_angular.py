"""Block-angular ``[A1 | A2]`` QR: solver composition, on torch tensors.

Counterpart of ``qrkit_tpu/solvers/block_angular.py`` (``_RowSubsetQR``,
``BlockAngularQR``), the reference's ``BlockAngularSparseQR``
(``BlockAngularSparseQR.h:79-514``) as object composition over the
:class:`~qrkit_tpu_torch.solvers.base.QRSolver` protocol:

1. left.compute(A1)
2. J2 ← Q1ᵀ (P_row_left · A2), one implicit-Q matrix product
3. right.compute(J2[m1:])
4. R = [[R1, J2top·P2], [0, R2]], assembled lazily
5. column and row permutations composed from both sub-solvers

Q is never formed: ``apply_qt`` runs Q1ᵀ, then (P_r2, Q2ᵀ) on the bottom
rows; ``apply_q`` the reverse.  ``solve`` eliminates the right block first,
then back-substitutes through the left solver's structured R.

The flagship stack (``BlockDiagonalQR`` FULL_Q non-pivoting left, dense
right, dense A2) runs the fused programs of
:mod:`~qrkit_tpu_torch.solvers.block_angular_fused`; the lane-major one
when the caller hands SoA left blocks or a transposed A2.  On the card the
fused dense ``compute`` and its vector ``solve``, and the lane-major
``compute``, vector ``solve`` and ``compute_solve``, are each one captured
program (:mod:`~qrkit_tpu_torch._program`); the children's factors (the
lane-major factors) are the compute program's outputs.  Other stacks run
the generic composition, where a ``BlockDiagonalQR`` left on a CUDA operand
factors with kernel B2 and a ``BandedBlockedQR`` left with kernel B5.  A
sparse A2 stays sparse (:meth:`BlockAngularQR._compute_sparse_a2`): with a
block-diagonal left through per-(block, column) slabs, with a banded or
segmented left through the planned sparse products of
:mod:`~qrkit_tpu_torch.solvers.sparse_apply`; the pattern work is planned
once per A2 layout, and a same-pattern recompute is the left's program
plus one program (J2, the row-subset scatter, the dense right compute
inline), with no host read.

Over a mesh the fully distributed stack is ``BlockDiagonalQR(mesh=m)`` left
and ``TSQRDenseQR(world, mesh=m)`` right: the sharded left's Qᵀ reads only
its rank's rows of a dense A2 (the reference places A2 sharded by rows for
the same product), the TSQR all-gather is the factorization's only other
collective, and every result is global.  The fused programs stay off under
a mesh, as in the reference; a sparse A2 keeps its single-device form on
every rank, over the left's factors gathered inside its program.  The
sparse-A2 recompute and the generic solve are programs over a mesh too,
their collectives inside the graphs.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .. import _device
from .._program import Programs
from ..containers import BlockDiagonal, BlockMatrix1x2
from ..functional import block_diagonal_factorize
from ..ops.blockdiag import to_aos
from ..ops.householder import highest_precision
from ..sparse import Permutation, SparseCSR
from .banded_blocked import BandedBlockedQR
from .base import ComputationInfo, QRSolver, _diag_health
from .block_angular_fused import (
    _inverse_perm,
    fused_dense_compute,
    fused_dense_compute_solve,
    fused_dense_solve,
    fused_soa_compute,
    fused_soa_compute_solve,
    fused_soa_solve,
)
from .block_diagonal import BlockDiagonalQR, QFormat
from .dense import DenseColPivQR, DenseHouseholderQR
from .segmented_banded import SegmentedBandedQR

__all__ = ["BlockAngularQR"]


def _fused_dense_program(self, blocks, a2):
    """The fused dense-A2 compute (:func:`fused_dense_compute`) and the
    composite health flag, all on the device."""
    out = fused_dense_compute(
        blocks, a2, bc=blocks.shape[2], colpiv=isinstance(self.right, DenseColPivQR)
    )
    return out + (out[-2] & out[-1],)


def _fused_dense_solve_program(self, b):
    return fused_dense_solve(
        self.left.Q, self.left.R, self.right._Y, self.right._T, self.right._R,
        self._fused_perm2, self._r12, b, bc=self.left._bc, colpiv=self._fused_colpiv,
    )


def _fused_soa_solve_program(self, b):
    return fused_soa_solve(
        self._sU1, self._sc1, self._sR1, self._sU2, self._sc2, self._sR2, self._fused_perm2,
        self._sr12t, b, colpiv=self._fused_colpiv,
    )


def _pattern(nrows: int, ncols: int, rows, cols) -> SparseCSR:
    """A host CSR pattern of distinct ``(rows, cols)`` pairs already in CSR
    order (its values a zero view: only the structure is read)."""
    indptr = np.zeros(nrows + 1, dtype=np.int64)
    np.add.at(indptr, np.asarray(rows) + 1, 1)
    return SparseCSR((nrows, ncols), np.cumsum(indptr), cols,
                     np.broadcast_to(np.zeros(1), (len(cols),)))


def _factor_state(solver):
    """The program whose outputs are ``solver``'s factors (its serial
    number; the solver that holds them is a segmented solver's delegate),
    or None for factors no program owns."""
    owner = getattr(solver, "_delegate", None) or solver
    return owner._programs.state()


def _row_sum_map(rows: np.ndarray, nrows: int, device) -> torch.Tensor:
    """The entries of each row of a COO matrix, in a fixed order: ``[nrows,
    w]`` entry indices (w the most entries a row holds), each row's in
    their stored order, padded with ``len(rows)`` (a zero appended to the
    products).  Summing the gathered products along ``w`` adds each row's
    entries in one order on every run, where an ``index_add_`` on the card
    adds them with atomics in any order."""
    rows = np.asarray(rows, dtype=np.int64)
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=nrows)
    w = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(rows.size) - np.repeat(starts, counts)
    out = np.full((nrows, w), rows.size, dtype=np.int64)
    out[rows[order], slot] = order
    return torch.as_tensor(out, device=device)


def _row_sum(sum_map: torch.Tensor, prods: torch.Tensor) -> torch.Tensor:
    """Each row's products (``[nnz]`` or ``[nnz, k]``) summed in the map's
    fixed order (:func:`_row_sum_map`) → ``[nrows]`` or ``[nrows, k]``."""
    pad = torch.cat([prods, prods.new_zeros((1,) + prods.shape[1:])])
    return pad[sum_map].sum(1)


def _generic_solve_program(self, b: torch.Tensor) -> torch.Tensor:
    """The generic least-squares solve: Qᵀb through both children, the
    block back-substitution (a matrix rhs in one, over its columns) and the
    column back-permutation on the device; the children's programs run
    inline."""
    y = self.apply_qt(b)
    return self._unpermute_cols(self.solve_r(y[: self.cols]))


def _right_outputs(self, bot: torch.Tensor, plan: dict):
    """The right block from the bottom's values in CSR order: the
    row-subset scatter and the right solver's compute (inline in a
    program), R12's columns in its pivot order, the health flag and the
    right solver's factors."""
    rs = self.right
    rs._factor(bot)
    inner = rs.inner
    pd = getattr(inner, "_perm_dev", None)
    if pd is not None:
        cols12 = _inverse_perm(pd)[plan["top_cols_dev"]]
    elif inner.cols_permutation().is_identity():
        cols12 = plan["top_cols_dev"]
    else:
        inv_s2 = inner.cols_permutation().inverse().indices
        cols12 = torch.as_tensor(inv_s2[plan["top_cols"]], device=bot.device)
    health = rs._health
    if isinstance(inner, DenseColPivQR):
        factors = (inner._Y, inner._T, inner._R, pd)
    elif isinstance(inner, DenseHouseholderQR):
        factors = (inner._Y, inner._T, inner._R)
    elif _is_tsqr(inner):  # no flag of its own: the composite's from its diagonal
        factors = (inner.Yl, inner.Tl, inner.Y2, inner.T2, inner._R)
        health = _diag_health(rs.r_diagonal()[: rs.cols], check_zero=rs._health_check_zero_pivot)
    else:
        factors = ()
    return (cols12, health) + factors


def _is_tsqr(solver) -> bool:
    from ..parallel.tsqr import TSQRDenseQR  # tsqr imports the solvers

    return isinstance(solver, TSQRDenseQR)


def _captured_right(inner) -> bool:
    """Whether a program of this module may hold the right solver's
    factors: a dense solver or TSQR (whose factors it adopts)."""
    return isinstance(inner, (DenseColPivQR, DenseHouseholderQR)) or _is_tsqr(inner)


def _blockdiag_a2_program(self, q_in, vals, plan, kernel: bool):
    """The sparse-A2 recompute over a block-diagonal left: ``q_in`` is the
    left's explicit Q1 ``[nb, br, br]``, or with ``kernel`` its resident
    SoA operand (Q1 and R1 then formed here and returned last); over a mesh
    the rank's blocks, Q1 then gathered here (one all-gather); ``vals``
    A2's values.  Returns (R12 values, R12 columns, health, the right
    solver's factors[, Q1, R1] (the rank's))."""
    left = self.left
    br, bc = left._br, left._bc
    if kernel:
        Q1, R1, _ = block_diagonal_factorize(to_aos(q_in, br, bc), pivot=False)
    else:
        Q1 = q_in
    Qg = left._gather(Q1)
    # one batched per-pair Qᵀ·w on the device, in full precision
    with highest_precision():
        W = torch.cat([vals, vals.new_zeros(1)])[plan["w_gather"]].view(plan["K"], br)
        QtW = (Qg[plan["pair_b"]].mT @ W[:, :, None])[..., 0]  # [K, br]
    top = QtW[:, :bc].reshape(-1)  # economy rows: J2 top, FULL_Q rows b*bc + i
    # complement rows, then A1's zero tail rows (Q1ᵀ leaves them), in CSR order
    bot = torch.cat([QtW[:, bc:].reshape(-1), vals[plan["tail_pos"]]])[plan["bot_order"]]
    return (top,) + _right_outputs(self, bot, plan) + ((Q1, R1) if kernel else ())


def _chunked_a2_program(self, vals, plan):
    """The sparse-A2 recompute over a banded or segmented left: one Qᵀ
    apply of the left over all of A2's columns (the planned value program)
    and the right block (:func:`_right_outputs`)."""
    factors, meta = self.left._sparse_apply_state()
    top, bot = plan["plan"]["run"](factors, meta, vals, plan["plan"]["maps"],
                                   (plan["top_sel"], plan["bot_sel"]))
    return (top,) + _right_outputs(self, bot, plan)


def _to_device_dense(block, device, dtype) -> torch.Tensor:
    """A dense tensor of ``block`` (host SparseCSR, NumPy or tensor); a
    tensor stays where it is."""
    if isinstance(block, torch.Tensor):
        return block
    if isinstance(block, SparseCSR):
        block = block.to_dense()
    return torch.as_tensor(block, device=device, dtype=dtype)


class _RowSubsetQR(QRSolver):
    """Adapter factoring only the structurally nonzero rows of a sparse
    matrix.

    The QR of a matrix whose other rows are all zero is the QR of the
    nonzero rows with an identity Q on the zero rows; the row permutation
    moving the nonzero rows first is reported through
    ``rows_permutation()``.  Peak inner memory is O(nnz-rows × cols).  The
    pattern-only bookkeeping is cached across computes on one sparsity (the
    LM pattern)."""

    def __init__(self, inner: QRSolver, plan_cache: Optional[dict] = None, *, device=None,
                 dtype=None):
        self.inner = inner
        self._plan_cache = plan_cache if plan_cache is not None else {}
        self.device, self.dtype = device, dtype

    @property
    def _health_check_zero_pivot(self):
        return self.inner._health_check_zero_pivot

    @property
    def rows(self) -> int:
        return self._nbot

    @property
    def cols(self) -> int:
        return self._n

    @property
    def rank(self) -> int:
        return self.inner.rank

    def compute(self, mat: SparseCSR) -> "_RowSubsetQR":
        """Factor the nonzero rows of ``mat``."""
        self._prepare(mat)
        self._factor(torch.as_tensor(np.asarray(mat.data), device=self.device, dtype=self.dtype))
        return self

    def _prepare(self, mat: SparseCSR) -> None:
        """The pattern-only bookkeeping, cached across computes on one
        sparsity (the LM pattern): the inner rows, the row permutation and
        each selected value's flat position in the dense ``sub`` (device
        maps)."""
        nbot, n = mat.shape
        fp = ("rowsubset", mat.pattern_fingerprint(), nbot, n, self.device)
        plan = self._plan_cache.get("rowsubset")
        if plan is None or plan["fp"] != fp:
            row_nnz = np.diff(mat.indptr)
            nz = np.nonzero(row_nnz > 0)[0]
            if nz.size < n:  # keep the inner problem portrait
                extra = np.setdiff1d(np.arange(nbot), nz)[: n - nz.size]
                nz = np.sort(np.concatenate([nz, extra]))
            rest = np.setdiff1d(np.arange(nbot), nz)
            k = int(nz.size)
            dest = np.empty(nbot, dtype=np.int64)
            dest[nz] = np.arange(k)
            dest[rest] = k + np.arange(rest.size)
            # gather for the dense copy of just the selected rows
            counts = row_nnz[nz]
            total = int(counts.sum())
            starts = np.concatenate([[0], np.cumsum(counts[:-1])]) if k else np.zeros(0, np.int64)
            pos = np.arange(total) - np.repeat(starts, counts)
            g = np.repeat(mat.indptr[:-1][nz], counts) + pos
            sub_flat = np.repeat(np.arange(k), counts) * n + mat.indices[g]
            plan = {
                "fp": fp,
                "k": k,
                "rows_perm": Permutation(dest),
                "g": torch.as_tensor(g, device=self.device),
                "sub_flat": torch.as_tensor(sub_flat, device=self.device),
            }
            self._plan_cache["rowsubset"] = plan
        self._nbot, self._n, self._k = nbot, n, plan["k"]
        self._rows_perm = plan["rows_perm"]
        self._plan = plan

    def _factor(self, values: torch.Tensor) -> None:
        """The values scattered into the dense ``sub`` on the device (one
        O(nnz) scatter through the cached maps) and the inner compute."""
        plan = self._plan
        sub = values.new_zeros(self._k * self._n)
        sub[plan["sub_flat"]] = values[plan["g"]]
        self.inner.compute(sub.view(self._k, self._n))
        # hand the inner health flag on unread: reading it here would make
        # every compute wait for the device
        self._take_health()

    def _take_health(self) -> None:
        self._info = self.inner._info
        self._health = self.inner._health
        self.inner._health = None

    def apply_qt(self, v: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.inner.apply_qt(v[: self._k]), v[self._k :]], dim=0)

    def apply_q(self, v: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.inner.apply_q(v[: self._k]), v[self._k :]], dim=0)

    def matrix_r_dense(self) -> torch.Tensor:
        r = self.inner.matrix_r_dense()
        return torch.cat([r, r.new_zeros((self._nbot - self._k, self._n))], dim=0)

    def r_diagonal(self) -> torch.Tensor:
        return self.inner.r_diagonal()

    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        return self.inner.solve_r(y)

    def cols_permutation(self) -> Permutation:
        return self.inner.cols_permutation()

    def rows_permutation(self) -> Permutation:
        return self._rows_perm


class BlockAngularQR(QRSolver):
    """QR of ``[A1 | A2]`` parameterized by left and right sub-solvers.

    ``left_solver`` factors A1 (the structured part); ``right_solver``
    factors the bottom rows of ``Q1ᵀA2``.  Any :class:`QRSolver` works on
    either side.  ``mesh``/``axis`` mark the composition as distributed
    (pass the mesh to the sub-solvers too, see the module docstring): the
    fused programs stay off, and with sharded sub-solvers every method is
    collective."""

    def __init__(self, left_solver: QRSolver, right_solver: QRSolver, mesh=None, axis: str = "dp"):
        self.left = left_solver
        self.right = right_solver
        self.mesh = mesh
        self.axis = axis
        # pattern bookkeeping shared across computes on one sparsity (LM
        # refactorizes one structure per iteration)
        self._plan_cache: dict = {}
        self._programs = Programs()
        self._perm_cache: dict = {}  # slot -> (host permutation, device, its device indices)
        self._left_from_program = False
        self._solve_key = None

    @property
    def rows(self) -> int:
        return self._n1

    @property
    def cols(self) -> int:
        return self._m1 + self._m2

    @property
    def rank(self) -> int:
        self._ensure_children_fused()
        return self.left.rank + self.right.rank

    def _compute_preamble(self, mat: BlockMatrix1x2) -> bool:
        # the left block should be the bigger one (BlockAngularSparseQR.h:434)
        if not mat.left_cols > mat.right_cols:
            raise ValueError(
                f"the left block must have more columns than the right "
                f"({mat.left_cols} vs {mat.right_cols})"
            )
        self._m1, self._m2, self._n1 = mat.left_cols, mat.right_cols, mat.left_rows
        self._device = self._home(mat)[0]
        self._r12_coo = None
        self._left_from_program = False
        self._fused_dense = False
        self._fused_soa = False
        if isinstance(self.right, _RowSubsetQR):  # recompute: unwrap
            self.right = self.right.inner
        return isinstance(mat.right, SparseCSR)

    def _home(self, mat: BlockMatrix1x2):
        """(device, dtype) of the composite's dense operands: the left
        container's, else a tensor A2's, else the left solver's (CUDA when
        it names none)."""
        if isinstance(mat.left, (BlockDiagonal, torch.Tensor)):
            return mat.left.device, mat.left.dtype
        if isinstance(mat.right, torch.Tensor):
            return mat.right.device, mat.right.dtype
        return (_device.resolve(getattr(self.left, "device", None)),
                getattr(self.left, "dtype", torch.float64))

    def _uses_fused_soa(self, mat: BlockMatrix1x2, sparse_a2: bool) -> bool:
        """Lane-major fused path gate: the caller handed lane-major storage
        (SoA left blocks or a transposed right block) for the fused dense
        stack."""
        return (
            not sparse_a2
            and (getattr(mat.left, "is_soa", False) or mat.right_t)
            and self._uses_fused_dense(mat)
        )

    def _soa_inputs(self, mat: BlockMatrix1x2, colpiv: bool):
        """The lane-major program's operands and its static arguments."""
        lm = mat.left
        a_in = lm.soa() if lm.is_soa else lm.blocks
        a2_in = mat.right if mat.right_t else _to_device_dense(mat.right, *self._home(mat))
        kw = dict(br=lm.block_rows, bc=lm.block_cols, colpiv=colpiv, aos=not lm.is_soa,
                  a2_aos=not mat.right_t)
        return a_in, a2_in, kw

    def _adopt_soa_outputs(self, mat: BlockMatrix1x2, out, colpiv: bool):
        (self._sU1, self._sc1, self._sR1, self._sj2t, self._sU2,
         self._sc2, self._sR2, self._fused_perm2, self._sr12t, health) = out
        self._fused_soa = True
        self._fused_colpiv = colpiv
        self._soa_children = False
        self._soa_mat = mat
        self._r12 = None
        self._cols_perm = None
        self._rows_perm = Permutation.identity(self._n1)
        self._info = ComputationInfo.SUCCESS
        self._health = health

    def compute_solve(self, mat: BlockMatrix1x2, b: torch.Tensor) -> torch.Tensor:
        """Factorize + least-squares solve in one call, leaving the solver
        fully computed as after :meth:`compute`.  On the fused stacks the
        factorize and the solve run back to back with no host
        synchronization; other stacks run ``compute(mat)`` then ``solve(b)``."""
        sparse_a2 = self._compute_preamble(mat)
        colpiv = isinstance(self.right, DenseColPivQR)
        if self._uses_fused_soa(mat, sparse_a2):
            a_in, a2_in, kw = self._soa_inputs(mat, colpiv)
            out = self._programs.factorize(
                self, "BlockAngularQR.soa_compute_solve", tuple(kw.values()),
                lambda _, a, a2, v: fused_soa_compute_solve(a, a2, v, **kw), a_in, a2_in, b,
            )
            self._adopt_soa_outputs(mat, out[:-1], colpiv)
            return out[-1].clone()  # a replay's x is the program's, overwritten by the next
        if not sparse_a2 and self._uses_fused_dense(mat):
            a2 = _to_device_dense(mat.right, *self._home(mat))
            out = fused_dense_compute_solve(
                mat.left.blocks, a2, b, bc=mat.left.block_cols, colpiv=colpiv
            )
            self._adopt_dense_outputs(mat, out[:-1], colpiv)
            self._programs.bind_eager()
            return out[-1]
        self.compute(mat)
        return self.solve(b)

    def _adopt_dense_outputs(self, mat: BlockMatrix1x2, out, colpiv: bool, health=None):
        (Q, R, j2_top, Y2, T2, R2, perm2, r12, h1, h2) = out
        self.left._adopt_factors(mat.left, Q, R, h1)
        nbot = self._n1 - self._m1
        if colpiv:
            self.right._adopt_factors(nbot, self._m2, Y2, T2, R2, h2, perm_dev=perm2)
        else:
            self.right._adopt_factors(nbot, self._m2, Y2, T2, R2, h2)
        self._j2_top = j2_top
        self._r12 = r12
        self._fused_dense = True
        self._fused_colpiv = colpiv
        self._fused_perm2 = perm2
        self._cols_perm = None
        self._rows_perm = Permutation.identity(self._n1)
        self._set_success(health)

    def compute(self, mat: BlockMatrix1x2) -> "BlockAngularQR":
        sparse_a2 = self._compute_preamble(mat)
        colpiv = isinstance(self.right, DenseColPivQR)
        if self._uses_fused_soa(mat, sparse_a2):
            a_in, a2_in, kw = self._soa_inputs(mat, colpiv)
            out = self._programs.factorize(
                self, "BlockAngularQR.soa_compute", tuple(kw.values()),
                lambda _, a, a2: fused_soa_compute(a, a2, **kw), a_in, a2_in,
            )
            self._adopt_soa_outputs(mat, out, colpiv)
            return self
        # the flagship dense-A2 stack: steps 1-5 in one fused program (one
        # captured program on the card), the children filled from its outputs
        if not sparse_a2 and self._uses_fused_dense(mat):
            a2 = _to_device_dense(mat.right, *self._home(mat))
            out = self._programs.factorize(
                self, "BlockAngularQR.compute", colpiv, _fused_dense_program, mat.left.blocks, a2
            )
            self._adopt_dense_outputs(mat, out[:-1], colpiv, health=out[-1])
            return self

        # 1) left factorization
        self.left.compute(mat.left)

        # 2+3) J2 = Q1ᵀ (P_row_left A2); the right solver factors the bottom
        # rows.  A sparse A2 stays sparse (one captured program on the card).
        if sparse_a2 and (self._left_supports_sparse_a2()
                          or self._left_supports_chunked_sparse_a2()):
            self._compute_sparse_a2(mat)
        else:
            a2 = _to_device_dense(mat.right, *self._home(mat))
            lperm = self.left.rows_permutation()
            if not lperm.is_identity():
                a2 = a2[torch.as_tensor(lperm.gather_indices(), device=a2.device)]
            j2 = self.left.apply_qt(a2)
            self._j2_top = j2[: self._m1]
            self.right.compute(j2[self._m1 :])
            # R's top-right block in the right solver's column order (the
            # device pivot order when there is one: no host fetch)
            pd = self._right_perm_dev()
            sigma2 = pd if pd is not None else torch.as_tensor(
                self.right.cols_permutation().indices, device=j2.device
            )
            self._r12 = self._j2_top[:, sigma2]
            self._programs.bind_eager()

        # 5) composed permutations: the host composition needs the right
        # solver's pivot order from the device, so it waits for the first
        # cols_permutation(); solve() gathers on the device instead
        self._cols_perm = None
        rp = np.arange(self._n1, dtype=np.int64)
        rp[: self.left.rows] = self.left.rows_permutation().indices
        self._rows_perm = Permutation(rp)
        self._set_success()
        return self

    def _right_perm_dev(self):
        """The right solver's pivot order as a device tensor when it kept one
        (:class:`DenseColPivQR`); None otherwise."""
        r = self.right.inner if isinstance(self.right, _RowSubsetQR) else self.right
        return getattr(r, "_perm_dev", None)

    def _uses_fused_dense(self, mat: BlockMatrix1x2) -> bool:
        """Gate of the fused dense-A2 program: the flagship reference stack
        (``BlockDiagonalSparseQR`` left + dense QR right) with portrait
        blocks, no zero-column tail, no mesh and enough bottom rows for the
        right QR."""
        lm = mat.left
        return (
            type(self.left) is BlockDiagonalQR
            and isinstance(lm, BlockDiagonal)
            and not self.left.pivot
            and self.left.q_format == QFormat.FULL_Q
            and self.mesh is None
            and self.left.mesh is None
            and type(self.right) in (DenseColPivQR, DenseHouseholderQR)
            and lm.block_rows >= lm.block_cols
            and lm.ncols == lm.num_blocks * lm.block_cols
            and (lm.nrows - lm.ncols) >= mat.right_cols
        )

    def _left_supports_sparse_a2(self) -> bool:
        return (
            isinstance(self.left, BlockDiagonalQR)
            and self.left.q_format == QFormat.FULL_Q
            # complement rows must all land in the bottom block
            and self.left.cols == self.left._nb * self.left._bc
        )

    def _left_supports_chunked_sparse_a2(self) -> bool:
        return isinstance(self.left, (BandedBlockedQR, SegmentedBandedQR))

    def _a2_cache_key(self, a2: SparseCSR):
        lperm = self.left.rows_permutation()
        ph = None if lperm.is_identity() else hash(lperm.indices.tobytes())
        return (a2.pattern_fingerprint(), a2.shape, ph)

    def _compute_sparse_a2(self, mat: BlockMatrix1x2) -> None:
        """Steps 2+3 for a sparse A2 (the reference's sparse QProduct +
        solveRightBlock, BlockAngularSparseQR.h:360-397): J2 = Q1ᵀ·A2 on the
        device from A2's values (the pattern work planned once per A2
        layout, :meth:`_blockdiag_a2_plan` / :meth:`_chunked_a2_plan`), its
        rows above m1 kept as the device COO R12, its bottom rows scattered
        into the right solver's dense rows (:class:`_RowSubsetQR`) and
        factored there.  With a dense right solver and no mesh, all of it
        is one captured program on the card, the right solver's compute
        inline, its factors the program's outputs; the host reads nothing."""
        device, dtype = self._home(mat)
        inner = self.right
        rs = self.right = _RowSubsetQR(inner, plan_cache=self._plan_cache, device=device,
                                       dtype=dtype)
        left = self.left
        capture = _captured_right(inner)
        if self._left_supports_sparse_a2():
            plan = self._blockdiag_a2_plan(mat.right, device)
            name = "BlockAngularQR.sparse_a2_blockdiag"
            kernel = left._kernel_mode
            q_in = left._a_soa if kernel else left.Q  # the rank's blocks over a mesh
            key, inputs = kernel, (q_in,)
            fn = functools.partial(_blockdiag_a2_program, plan=plan, kernel=kernel)
        else:
            plan = self._chunked_a2_plan(mat.right, device)
            name = "BlockAngularQR.sparse_a2_chunked"
            key, inputs, kernel = None, (), False
            # captured against the left's factorize program, whose outputs
            # stay where they are; eager factors move at every compute
            state = _factor_state(left)
            capture = capture and state is not None
            if capture and plan.get("factor_state") != state:  # the left's program changed
                self._programs.drop(name)
                plan["factor_state"] = state
            fn = functools.partial(_chunked_a2_program, plan=plan)
        rs._prepare(plan["bottom"])
        out = self._programs.factorize(
            self, name, key, fn, *inputs, np.asarray(mat.right.data), capture=capture,
            upload=(device, dtype), mesh=self._program_mesh(), axis=self.axis,
        )
        top_vals, cols12, health = out[:3]
        if kernel:  # the left's explicit factors, for its dense surfaces
            left.Q, left.R = out[-2:]
        if capture:  # the inner factors are the program's outputs
            factors = out[3:-2] if kernel else out[3:]
            if isinstance(inner, DenseColPivQR):
                inner._adopt_factors(rs._k, rs._n, *factors[:3], health, perm_dev=factors[3])
            elif _is_tsqr(inner):
                inner._adopt_factors(*factors)
                inner._health = health
            else:
                inner._adopt_factors(rs._k, rs._n, *factors, health)
            rs._take_health()
        # the left's explicit factors are this program's outputs (the
        # kernel tier's Q1, R1): a captured solve is keyed by this program
        self._left_from_program = kernel and capture
        self._top_rows_dev = plan["top_rows_dev"]
        self._top_cols = plan["top_cols"]
        self._top_vals_dev = top_vals
        self._r12_coo = (self._top_rows_dev, cols12, top_vals)
        self._r12_sum = plan["top_sum"]
        self._r12 = None

    def _blockdiag_a2_plan(self, a2: SparseCSR, dev) -> dict:
        """Pattern plan of the sparse J2 for a block-diagonal left solver.

        A2's nonzeros go into per-(block, column) dense slabs ``[K, br]``,
        the per-block Qᵀ applies as one batched product, the economy rows
        become a device-COO J2-top (O(nnz·br) memory instead of O(n1·m2))
        and the complement and tail rows the right solver's bottom, in CSR
        order.  Everything here is pattern-only, cached under the A2 layout:
        the device maps take A2's value vector to the slabs
        (``w_gather``), the bottom's values to CSR order (``bot_order``)."""
        left = self.left
        nb, br, bc = left._nb, left._br, left._bc
        m1, n1 = self._m1, self._n1
        key = ("blockdiag_a2",) + self._a2_cache_key(a2) + (nb, br, bc, dev)
        plan = self._plan_cache.get("blockdiag_a2")
        if plan is not None and plan["key"] == key:
            return plan
        lperm = left.rows_permutation()
        row_ids = np.repeat(np.arange(a2.nrows), np.diff(a2.indptr))
        if not lperm.is_identity():
            row_ids = lperm.indices[row_ids]  # P*A2 scatters rows
        cols = a2.indices
        body = row_ids < nb * br
        b_of = row_ids[body] // br
        r_of = row_ids[body] % br
        keys = b_of * a2.ncols + cols[body]
        uniq, inv = np.unique(keys, return_inverse=True)
        pair_b = (uniq // a2.ncols).astype(np.int64)
        pair_c = (uniq % a2.ncols).astype(np.int64)
        top_rows = (pair_b[:, None] * bc + np.arange(bc)).reshape(-1)
        comp_w = br - bc
        comp_rows = (nb * bc + pair_b[:, None] * comp_w + np.arange(comp_w)).reshape(-1) - m1
        bot_rows = np.concatenate([comp_rows, row_ids[~body] - m1])
        bot_cols = np.concatenate([np.repeat(pair_c, comp_w), cols[~body]])
        # the bottom (row, col) pairs are distinct by construction, so the
        # CSR build is one cached lexsort applied to the value vector
        order = np.lexsort((bot_cols, bot_rows))
        w_gather = np.full(uniq.size * br, a2.nnz, dtype=np.int64)  # a2.nnz: the zero pad
        w_gather[inv.reshape(-1) * br + r_of] = np.nonzero(body)[0]
        top_cols = np.repeat(pair_c, bc)
        T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        plan = {
            "key": key,
            "K": int(uniq.size),
            "w_gather": T(w_gather),
            "tail_pos": T(np.nonzero(~body)[0]),
            "pair_b": T(pair_b),
            "bot_order": T(order),
            "top_rows_dev": T(top_rows),
            "top_sum": _row_sum_map(top_rows, m1, dev),
            "top_cols": top_cols,
            "top_cols_dev": T(top_cols),
            "bottom": _pattern(n1 - m1, self._m2, bot_rows, bot_cols[order]),
        }
        self._plan_cache["blockdiag_a2"] = plan
        self._programs.drop("BlockAngularQR.sparse_a2_blockdiag")  # they read the old maps
        return plan

    def _chunked_a2_plan(self, a2: SparseCSR, dev) -> dict:
        """Pattern plan of the keep-sparse solveRightBlock for a banded or
        segmented left solver: the structural fill of Q1ᵀA2, planned once
        per A2 layout from the band geometry
        (:mod:`~qrkit_tpu_torch.solvers.sparse_apply`); its rows above m1
        are the COO R12, its bottom rows (fill entries that cancel stored
        as explicit zeros, like setFromTriplets without prune) the right
        solver's pattern."""
        from . import sparse_apply as sa

        left = self.left
        m1, n1 = self._m1, self._n1
        key = ("banded_a2",) + self._a2_cache_key(a2) + (dev,)
        ent = self._plan_cache.get("banded_a2")
        if ent is not None and ent["key"] == key:
            return ent
        lperm = left.rows_permutation()
        row_map = None if lperm.is_identity() else lperm.indices
        fill_fn, apply_fn = left._sparse_apply_parts(True)
        fr, fc = fill_fn(a2, row_map)
        plan = sa.build_fused_sparse_apply(apply_fn, fr, fc, a2, n1, row_map, device=dev)
        top = fr < m1
        b_r, b_c = fr[~top] - m1, fc[~top]
        order_b = np.lexsort((b_c, b_r))
        T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        ent = dict(
            key=key, plan=plan,
            top_sel=T(plan["flat_pos"][top]),
            bot_sel=T(plan["flat_pos"][~top][order_b]),
            top_rows_dev=T(fr[top]),
            top_sum=_row_sum_map(fr[top], m1, dev),
            top_cols=fc[top],
            top_cols_dev=T(fc[top]),
            bottom=_pattern(n1 - m1, self._m2, b_r, b_c[order_b]),
        )
        self._plan_cache["banded_a2"] = ent
        self._programs.drop("BlockAngularQR.sparse_a2_chunked")  # they read the old maps
        return ent

    def _ensure_children_fused(self) -> None:
        """Fill the sub-solver objects from the lane-major factorization,
        only for the protocol surfaces that need the children's explicit
        factors (applies, solve_r, exports): runs the dense fused program
        once on the kept input containers.  compute, solve, r_diagonal and
        info never call this."""
        if not getattr(self, "_fused_soa", False) or self._soa_children:
            return
        mat = self._soa_mat
        a2 = mat.right.T if mat.right_t else _to_device_dense(mat.right, *self._home(mat))
        out = fused_dense_compute(mat.left.blocks, a2, bc=mat.left.block_cols, colpiv=self._fused_colpiv)
        self._adopt_dense_outputs(mat, out, self._fused_colpiv)
        self._soa_children = True

    def r_diagonal(self) -> torch.Tensor:
        """diag(R) of the composite = [diag(R1) | diag(R2)]."""
        if getattr(self, "_fused_soa", False) and not self._soa_children:
            # diagonal over (0, 1) puts the diagonal axis last: [N, bc]
            d1 = torch.diagonal(self._sR1, dim1=0, dim2=1).reshape(-1)
            return torch.cat([d1[: self._m1], torch.diagonal(self._sR2)[: self._m2]])
        return torch.cat(
            [self.left.r_diagonal()[: self._m1], self.right.r_diagonal()[: self._m2]]
        )

    def _set_success(self, health=None):
        """Composite health with each child's own zero-pivot semantics (a
        rank-revealing right solver's deficiency is no numerical issue; a
        non-pivoting left solver's zero pivot is): the flags each child's
        compute left on the device, combined there (``health`` when a fused
        program already combined them)."""
        self._info = ComputationInfo.SUCCESS
        if health is not None:
            self._health = health
            return

        def child_health(c, ncols):
            h = getattr(c, "_health", None)
            if h is not None:
                return h
            return _diag_health(c.r_diagonal()[:ncols], check_zero=c._health_check_zero_pivot)

        self._health = child_health(self.left, self._m1) & child_health(self.right, self._m2)

    # --- implicit Q (BlockAngularSparseQR.h:532-649) ------------------------------
    def _perm_dev(self, slot: str, perm: Permutation, gather: bool) -> Optional[torch.Tensor]:
        """``perm``'s gather indices (``gather``) or its indices on the
        device, None for the identity; uploaded once while the permutation
        stays the same (a pattern's), so a captured call reads them where
        they lie (a copy from the host cannot be captured)."""
        hit = self._perm_cache.get(slot)
        if hit is None or hit[1] != self._device or not (
                hit[0] is perm or np.array_equal(hit[0].indices, perm.indices)):
            idx = None if perm.is_identity() else torch.as_tensor(
                perm.gather_indices() if gather else perm.indices, device=self._device)
            hit = self._perm_cache[slot] = (perm, self._device, idx)
        return hit[2]

    def apply_qt(self, m: torch.Tensor) -> torch.Tensor:
        self._ensure_children_fused()
        vec = m.dim() == 1
        m2d = m[:, None] if vec else m
        top = self.left.apply_qt(m2d)
        bottom = top[self._m1 :]
        g = self._perm_dev("right_rows_gather", self.right.rows_permutation(), True)
        if g is not None:
            bottom = bottom[g]
        out = torch.cat([top[: self._m1], self.right.apply_qt(bottom)], dim=0)
        return out[:, 0] if vec else out

    def apply_q(self, m: torch.Tensor) -> torch.Tensor:
        self._ensure_children_fused()
        vec = m.dim() == 1
        m2d = m[:, None] if vec else m
        bottom = self.right.apply_q(m2d[self._m1 :])
        g = self._perm_dev("right_rows", self.right.rows_permutation(), False)
        if g is not None:
            bottom = bottom[g]  # undo the row permutation applied in apply_qt
        out = self.left.apply_q(torch.cat([m2d[: self._m1], bottom], dim=0))
        return out[:, 0] if vec else out

    # --- R ------------------------------------------------------------------------
    def matrix_r_dense(self) -> torch.Tensor:
        self._ensure_children_fused()
        m1, m2, n1 = self._m1, self._m2, self._n1
        r1 = self.left.matrix_r_dense().cpu().numpy()
        r2 = self.right.matrix_r_dense().cpu().numpy()
        R = np.zeros((n1, m1 + m2), dtype=r1.dtype)
        R[:m1, :m1] = r1[:m1, :m1]
        if self._r12_coo is not None:
            rows, cols, vals = (t.cpu().numpy() for t in self._r12_coo)
            R[rows, m1 + cols] = vals
        else:
            R[:m1, m1:] = self._r12.cpu().numpy()
        R[m1 : m1 + m2, m1:] = r2[:m2, :m2]
        return torch.as_tensor(R, device=self._device)

    def matrix_r_sparse(self) -> SparseCSR:
        """Sparse composite R = [[R1, R12], [0, R2]] in O(nnz) from the
        sub-solvers' sparse exports (makeR, BlockAngularSparseQR.h:284-335)."""
        self._ensure_children_fused()
        m1, m2 = self._m1, self._m2

        def _triplets(csr, max_rows):
            row_ids = np.repeat(np.arange(csr.nrows), np.diff(csr.indptr))
            keep = row_ids < max_rows
            return row_ids[keep], csr.indices[keep], csr.data[keep]

        r1_r, r1_c, r1_v = _triplets(self.left.matrix_r_sparse(), m1)
        r2_r, r2_c, r2_v = _triplets(self.right.matrix_r_sparse(), m2)
        if self._r12_coo is not None:
            rows12, cols12, vals12 = (t.cpu().numpy() for t in self._r12_coo)
        else:
            r12 = self._r12.cpu().numpy()
            rows12, cols12 = np.nonzero(r12)
            vals12 = r12[rows12, cols12]
        rows = np.concatenate([r1_r, rows12, m1 + r2_r])
        cols = np.concatenate([r1_c, m1 + cols12, m1 + r2_c])
        vals = np.concatenate([r1_v, vals12, r2_v])
        return SparseCSR.from_triplets(rows, cols, vals, (self._n1, m1 + m2))

    @highest_precision()
    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        """Block back-substitution of ``y [n]`` or ``[n, k]``: x2 from R2,
        then x1 from the structured R1; a sparse R12's products are summed
        row by row in a fixed order (:func:`_row_sum`)."""
        self._ensure_children_fused()
        m1, m2 = self._m1, self._m2
        x2 = self.right.solve_r(y[m1 : m1 + m2])
        if self._r12_coo is not None:
            _, cols, vals = self._r12_coo
            contrib = _row_sum(self._r12_sum, (vals if x2.dim() == 1 else vals[:, None]) * x2[cols])
        else:
            contrib = self._r12 @ x2
        return torch.cat([self.left.solve_r(y[:m1] - contrib), x2])

    def cols_permutation(self) -> Permutation:
        self._ensure_children_fused()
        if self._cols_perm is None:
            s1 = self.left.cols_permutation().indices
            s2 = self.right.cols_permutation().indices
            self._cols_perm = Permutation(np.concatenate([s1, self._m1 + np.asarray(s2)]))
        return self._cols_perm

    def rows_permutation(self) -> Permutation:
        return self._rows_perm

    def _unpermute_cols(self, z: torch.Tensor) -> torch.Tensor:
        """The composed column back-permutation of ``z`` (rows) on the
        device: ``inverse(concat(s1, m1+s2)) == concat(inverse(s1),
        m1+inverse(s2))`` (the two blocks permute disjoint ranges), the
        left's from its host permutation (a pattern's, uploaded once), the
        right's inverse formed on the device from its unfetched pivot order
        (the base class would compose it on the host and wait for it)."""
        m1 = self._m1
        g1 = self._perm_dev("left_cols", self.left.cols_permutation(), True)
        pd = self._right_perm_dev()
        if pd is None:
            pd = self._perm_dev("right_cols", self.right.cols_permutation(), False)
        x1 = z[:m1] if g1 is None else z[g1]
        x2 = z[m1:] if pd is None else z[m1:][_inverse_perm(pd)]
        return torch.cat([x1, x2])

    def _program_mesh(self):
        """The mesh this solver's programs issue collectives over: its
        own, else a sharded child's (None when nothing is sharded)."""
        if self.mesh is not None:
            return self.mesh
        inner = self.right.inner if isinstance(self.right, _RowSubsetQR) else self.right
        for child in (self.left, inner):
            own = getattr(child, "_program_mesh", None)  # a segmented solver's: when sharded
            mesh = own() if own is not None else getattr(child, "mesh", None)
            if mesh is not None:
                return mesh
        return None

    def _solve_capture(self):
        """(capture, key) of the generic solve's program.  It reads this
        solver's program outputs and plan maps (a compute that makes them
        anew binds eager factors, which drops the program), the children's
        factors and their maps.  Captured when the left's factors are a
        program's outputs: this solver's sparse-A2 program's (the kernel
        tier's Q1, R1) or the left's own, whose serial number keys it; and
        a dense or TSQR right (a TSQR right computed by its own program,
        whose serial number keys it too).  Over a mesh (a sharded left, a
        ``TSQRDenseQR(mesh=)`` right) the program holds their collectives.
        Otherwise the solve is eager glue over the children's programs."""
        left = self.left
        inner = self.right.inner if isinstance(self.right, _RowSubsetQR) else self.right
        if (not _captured_right(inner)
                or not isinstance(left, (BandedBlockedQR, SegmentedBandedQR, BlockDiagonalQR))
                or getattr(left, "pivot", False)):
            return False, None
        right = None
        if _is_tsqr(inner) and inner is self.right:  # factors of its own program
            right = _factor_state(inner)
            if right is None:
                return False, None
        if self._left_from_program:
            return self._programs.state() is not None, right
        state = _factor_state(left)
        return state is not None, (state, right)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Least-squares solve of ``b [rows]`` or ``[rows, k]``; the caller
        pre-applies ``rows_permutation()``.  A vector rhs on a fused stack
        runs the fused solve; otherwise the generic composition, one
        captured program on the card when :meth:`_solve_capture` allows
        (a matrix rhs back-substituted in one pass over its columns)."""
        if b.dim() == 1 and getattr(self, "_fused_soa", False):
            return self._programs.solve(
                self, "BlockAngularQR.soa_solve", (), _fused_soa_solve_program, b
            )
        if b.dim() == 1 and getattr(self, "_fused_dense", False):
            return self._programs.solve(
                self, "BlockAngularQR.solve", (), _fused_dense_solve_program, b
            )
        self._ensure_children_fused()
        capture, key = self._solve_capture()
        if capture and key != self._solve_key:  # the left's program changed
            self._programs.drop("BlockAngularQR.generic_solve")
            self._solve_key = key
        return self._programs.solve(self, "BlockAngularQR.generic_solve", key,
                                    _generic_solve_program, b, capture=capture,
                                    mesh=self._program_mesh(), axis=self.axis)
