"""Segmented banded QR: the sequential chain, parallelized by composition.

Counterpart of ``qrkit_tpu/solvers/segmented_banded.py``
(``SegmentedBandedQR``).  The chain of nb blocks is split into S segments
of L blocks; the first ``o`` columns of each segment (the overlap with the
previous one) become boundary columns.  Under the column permutation
P_split = [interior columns | boundary columns] the matrix is
block-angular: the interior part is block-diagonal over segments, so phase
1 factorizes S independent chains of L steps at once; phase 2 applies each
segment's Qᵀ to its [rows, 2o] boundary slab; the slabs' bottom rows form a
second, short banded chain (after a per-segment CAQR compression), and the
solve back-substitutes the boundary chain first, then the interiors.

Plans the segmentation cannot take (short or non-uniform chains) delegate
to a plain :class:`~qrkit_tpu_torch.solvers.banded_blocked.BandedBlockedQR`
(``fallback=True``) or raise.

With ``mesh=`` the segment axis is the distribution axis.  When S tiles the
mesh axis each rank runs phase 1 and phase 2 on its S/world segments with
no communication (kernels B3 and B4 per rank), one all-gather of the CAQR
R factors feeds the boundary chain, which runs replicated (B5), and the
solve mirrors it: Qᵀ and the interior back-substitution on the rank's
segments, the boundary solve replicated, x gathered.  Each rank keeps only
its segments' factors; Q products and the R exports run on factors
gathered for the call.  When S does not tile the mesh nothing is sharded
(the reference's rule).  The reference itself factors unsharded and only
places the factors on the mesh afterwards.

On the card a refactorize (``compute``'s device part,
``factorize_values``), a solve, ``apply_qt``, ``apply_q`` and ``solve_r``
(vector or matrix rhs) are each one captured program
(:mod:`~qrkit_tpu_torch._program`; the reference's per-plan factorize and
solve programs, ``_seg_qt_program`` and ``_seg_q_program``), B3, B4 and B5
launched inside the factorize's graph; sharded, each graph holds its
collectives (the CAQR R gather, the factors gathered for a Q product).
"""
from __future__ import annotations

from typing import Optional

import copy

import numpy as np
import torch

from .._device import resolve
from .._program import Programs
from ..analysis import as_banded_as_possible, block_banded_info, from_block_banded_pattern
from ..parallel.mesh import all_gather_leading
from ..sparse import Permutation, SparseCSR
from . import segmented_factorize, segmented_plan, segmented_solve
from .banded_blocked import (
    BandedBlockedQR,
    device_values,
    scan_route,
    shifted_gather_map,
    value_perm,
)
from .base import QRSolver
from .segmented_apply import seg_q, seg_qt

__all__ = ["SegmentedBandedQR"]


def _apply(fn, self, m: torch.Tensor) -> torch.Tensor:
    vec = m.dim() == 1
    out = fn(self._full(), m[:, None] if vec else m)
    return out[:, 0] if vec else out


def _apply_qt_program(self, m: torch.Tensor) -> torch.Tensor:
    return _apply(seg_qt, self, m)


def _apply_q_program(self, m: torch.Tensor) -> torch.Tensor:
    return _apply(seg_q, self, m)


def _solve_r_program(self, y: torch.Tensor) -> torch.Tensor:
    vec = y.dim() == 1
    y2 = y[:, None] if vec else y
    m1 = self._m1
    z = segmented_solve.backsub(self, y2[:m1], y2[m1 : m1 + self._m2])
    return z[:, 0] if vec else z


class SegmentedBandedQR(QRSolver):
    """Banded QR with segment-parallel factorization (a drop-in for
    :class:`BandedBlockedQR` on uniform chains).

    ``segment_blocks`` is L, the blocks per segment (segmentation needs at
    least 2L blocks).  The input is a host :class:`SparseCSR`; factors live
    on ``device`` in ``dtype`` (default CUDA, float64).

    ``use_kernel``: ``"auto"`` runs the kernels on a CUDA device when the
    plan admits the segment-chain kernel (B3), with the W-apply kernel (B4)
    and the boundary-chain kernel (B5) where their own gates admit the plan;
    ``True`` demands B3 (raising on a plan it cannot take; on the CPU the
    kernels' plain versions run); ``False`` keeps the general forms.  The Q
    products, the phase-2 slab apply of the segments B4 does not take and
    the back-substitutions take the chain-scan kernels K1 and K2 as
    :class:`BandedBlockedQR` does.

    ``mesh``/``axis`` shard the segment axis over the ranks of a
    ``DeviceMesh`` axis (module docstring); every rank calls with the same
    matrix, and every method is then collective.
    """

    DEFAULT_SEGMENT_BLOCKS = 32

    def __init__(
        self,
        suggested_block_cols: int = 8,
        segment_blocks: int = DEFAULT_SEGMENT_BLOCKS,
        block_rows: Optional[int] = None,
        block_cols: Optional[int] = None,
        block_overlap: Optional[int] = None,
        fallback: bool = True,
        mesh=None,
        axis: str = "dp",
        use_kernel="auto",
        *,
        device=None,
        dtype=None,
    ):
        if use_kernel not in ("auto", True, False):
            raise ValueError(f"use_kernel must be 'auto', True or False, got {use_kernel!r}")
        self._suggested = suggested_block_cols
        self.L = segment_blocks
        self._static = None not in (block_rows, block_cols, block_overlap)
        self._brows, self._bcols, self._boverlap = block_rows, block_cols, block_overlap
        self._fallback = fallback
        self.mesh = mesh
        self.axis = axis
        self.use_kernel = use_kernel
        self.device = resolve(device)
        self.dtype = dtype if dtype is not None else torch.float64
        self._delegate = None
        self._analysis_ok = False
        self._fac_kernel = False
        self._segs, self._lead, self._global_maps = None, 0, {}
        self._programs = Programs()
        self._layout_version = 0  # keys the factorize program: bumped with the maps

    @property
    def rows(self) -> int:
        return self._nrows

    @property
    def cols(self) -> int:
        return self._ncols

    # --- analysis -------------------------------------------------------------------
    def _make_delegate(self) -> BandedBlockedQR:
        return BandedBlockedQR(
            self._brows, self._bcols, self._boverlap, self._suggested,
            use_kernel="auto" if self.use_kernel is True else self.use_kernel,
            device=self.device, dtype=self.dtype,
        )

    def analyze_pattern(self, mat: SparseCSR):
        """Segmented analysis; a plan that cannot be segmented delegates to a
        plain :class:`BandedBlockedQR` (``fallback=True``) or raises."""
        self._delegate = None
        self.plan = None
        try:
            return self._analyze_pattern_segmented(mat)
        except ValueError:
            if not self._fallback:
                raise
            self._delegate = self._make_delegate()
            if self.plan is not None:
                # segmentation failed after pattern analysis succeeded: hand
                # the plan and row permutation over
                self._delegate.set_analysis(self.plan, self._row_perm)
            else:
                self._delegate.analyze_pattern(mat)
            self._nrows, self._ncols = mat.shape
            self._analysis_ok = True
            return self

    def set_analysis(self, plan, row_perm: Optional[Permutation] = None):
        """Install a precomputed plan; falls back like :meth:`analyze_pattern`."""
        self._delegate = None
        self.plan = plan
        self._row_perm = row_perm if row_perm is not None else Permutation.identity(plan.nrows)
        try:
            return segmented_plan.segment_plan(self)
        except ValueError:
            if not self._fallback:
                raise
            self._delegate = self._make_delegate()
            self._delegate.set_analysis(plan, self._row_perm)
            self._nrows, self._ncols = plan.nrows, plan.ncols
            self._analysis_ok = True
            return self

    def _analyze_pattern_segmented(self, mat: SparseCSR):
        self._nrows, self._ncols = mat.shape
        if self._static:
            self._row_perm = Permutation.identity(mat.nrows)
            self.plan = from_block_banded_pattern(
                mat.nrows, mat.ncols, self._brows, self._bcols, self._boverlap, self._suggested
            )
        else:
            self._row_perm, has_perm = as_banded_as_possible(mat)
            sorted_mat = mat.permute_rows(self._row_perm) if has_perm else mat
            self.plan = block_banded_info(sorted_mat, self._suggested)
        return segmented_plan.segment_plan(self)

    def _kernel_active(self) -> bool:
        if self.use_kernel is False:
            return False
        if self.use_kernel is True:
            if not self._kernel_gate:
                raise ValueError(
                    "use_kernel=True but the plan geometry is not supported by "
                    "the segment-chain kernel (non-uniform column step or panel "
                    "too large); use use_kernel='auto'"
                )
            return True
        return self._kernel_gate and self.device.type == "cuda"

    def _scan_route(self) -> bool:
        """Whether the Q products, the phase-2 slab apply and the
        back-substitutions run through the wrappers of K1 and K2
        (:func:`~qrkit_tpu_torch.solvers.banded_blocked.scan_route`)."""
        kw, ckw = self._kw, self._chain_kw
        return scan_route(
            self.use_kernel, self._scan_fits,
            f"segment panels {kw['max_active']}×{kw['max_cols']} (R {kw['max_emit']} rows) "
            f"and boundary panels {ckw['max_active']}×{ckw['max_cols']} (R "
            f"{ckw['max_emit']} rows)",
        )

    # --- factorization ----------------------------------------------------------------
    def _layout_maps(self, mat: SparseCSR, pmat: SparseCSR) -> None:
        """Gather maps keyed on the stored-nonzero layout: interior panels
        ``[S, L, ma, mc]`` (carry shift folded in) and boundary slabs
        ``[S, R, 2o]`` (a segment's rows touch only its two adjacent
        boundary-column groups), both over the value vector plus one zero."""
        S, L, o = self.S, self.L, self._overlap
        nnz = pmat.nnz
        self._vals_nnz, self._data_perm = mat.nnz, value_perm(mat, self._row_perm, self.device)
        lg = self._loc_geom
        gm = pmat.panels_gather_map(self._block_list, self._mRloc, self._max_cols)
        gm = shifted_gather_map(
            gm, lg["carry_rows"].reshape(-1), lg["nrows"].reshape(-1),
            self._kw["max_active"], nnz,
        ).reshape(S, L, self._kw["max_active"], self._max_cols)
        self._panel_gmap = torch.as_tensor(gm, dtype=torch.int64, device=self.device)
        col_pos = np.full(self._ncols, -1, dtype=np.int64)
        col_pos[self._bcols_idx] = np.arange(self._m2)
        row_ids = np.repeat(np.arange(self._nrows), np.diff(pmat.indptr))
        bp = col_pos[pmat.indices]
        sel = bp >= 0
        r_s, b_s = row_ids[sel], bp[sel]
        seg_of = np.searchsorted(self._seg_row0_arr, r_s, side="right") - 1
        seam = b_s // o + 1  # boundary group g sits between segments g and g+1
        lead = seg_of == seam
        ok = lead | (seg_of == seam - 1)  # non-adjacent rows cannot occur
        slabcol = np.where(lead, b_s % o, o + b_s % o)
        sm = np.full((S, self._max_seg_rows, 2 * o), nnz, dtype=np.int64)
        sm[seg_of[ok], (r_s - self._seg_row0_arr[seg_of])[ok], slabcol[ok]] = np.nonzero(sel)[0][ok]
        self._slab_gmap = torch.as_tensor(sm, device=self.device)
        segmented_plan.shard_layout_maps(self, nnz)
        self._layout_version += 1

    # --- the segment shard of a mesh ------------------------------------------------
    def _program_mesh(self):
        """The mesh this solver's programs issue collectives over: the
        solver's when its segments are sharded, else None."""
        return None if self._segs is None else self.mesh

    def _gather_segments(self, t: torch.Tensor) -> torch.Tensor:
        """Per-segment values of this rank's segments → all S (the identity
        when nothing is sharded)."""
        return t if self._segs is None else all_gather_leading(t, self.mesh, self.axis)

    def _full(self) -> "SegmentedBandedQR":
        """This solver with every segment's factors and maps (a shallow copy
        over factors gathered for one call; ``self`` when nothing is
        sharded): the Q products and R exports run on it."""
        if self._segs is None:
            return self
        full = copy.copy(self)
        for name, t in self._global_maps.items():
            setattr(full, name, t)
        g = self._gather_segments
        full._Yws, full._Ts, full._r_panels, full._j2_top, full._Tb = (
            g(t) for t in (self._Yws, self._Ts, self._r_panels, self._j2_top, self._Tb)
        )
        full._Yb = g(self._Yb.permute(2, 0, 1)).permute(1, 2, 0)  # segment axis last
        full._segs, full._lead, full._global_maps = None, 0, {}
        return full

    def compute(self, mat: SparseCSR, force_pattern_analysis: bool = False):
        if not self._analysis_ok or force_pattern_analysis:
            self.analyze_pattern(mat)
        if self._delegate is not None:
            self._delegate.compute(mat)
            return self._take_delegate_status()
        pmat = mat if self._row_perm.is_identity() else mat.permute_rows(self._row_perm)
        fp = pmat.pattern_fingerprint()
        if self._panel_gmap is None or fp != self._gmap_fp:
            self._layout_maps(mat, pmat)
            self._gmap_fp = fp
        self._factorize(np.asarray(mat.data))  # uploaded by the program
        return self

    def _factorize(self, vals) -> None:
        """Refactorize from the stored-order value vector (a device tensor,
        or host values the program uploads): one captured program on the
        card without a mesh."""
        self._fac_kernel = self._kernel_active()
        self._scan_kernel = self._scan_route()
        out = self._programs.factorize(
            self, "SegmentedBandedQR.factorize",
            (self._layout_version, self._fac_kernel, self._scan_kernel),
            segmented_factorize.factorize, vals, mesh=self._program_mesh(), axis=self.axis,
            upload=(self.device, self.dtype),
        )
        segmented_factorize.adopt(self, out)

    def _take_delegate_status(self):
        self._info = self._delegate._info
        self._health = self._delegate._health
        self._delegate._health = None
        return self

    def factorize_values(self, values) -> "SegmentedBandedQR":
        """Refactorize from stored-nonzero values in the analyzed matrix's
        stored order (see :meth:`BandedBlockedQR.factorize_values`)."""
        if self._delegate is not None:
            self._delegate.factorize_values(values)
            return self._take_delegate_status()
        self._factorize(device_values(self, values))
        return self

    # --- QRSolver interface -------------------------------------------------------------
    def r_diagonal(self) -> torch.Tensor:
        """diag(R) in P_split column order."""
        if self._delegate is not None:
            return self._delegate.r_diagonal()
        return segmented_factorize.r_diagonal(self, self._r_panels, self._chain_r)

    def apply_qt(self, m: torch.Tensor) -> torch.Tensor:
        """Qᵀ · m for ``m [rows]`` or ``[rows, k]`` (rows in
        :meth:`solve_r`'s order: per-segment R rows, chain rows,
        pass-through rows); one captured program on the card without a
        mesh."""
        if self._delegate is not None:
            return self._delegate.apply_qt(m)
        return self._programs.solve(self, "SegmentedBandedQR.apply_qt", (), _apply_qt_program,
                                    m, mesh=self._program_mesh(), axis=self.axis)

    def apply_q(self, m: torch.Tensor) -> torch.Tensor:
        """Q · m, the inverse of :meth:`apply_qt`."""
        if self._delegate is not None:
            return self._delegate.apply_q(m)
        return self._programs.solve(self, "SegmentedBandedQR.apply_q", (), _apply_q_program,
                                    m, mesh=self._program_mesh(), axis=self.axis)

    # --- sparse-operand Q products ---------------------------------------------------
    def _sparse_apply_parts(self, transpose: bool):
        """(fill_fn, apply_fn) for :mod:`~qrkit_tpu_torch.solvers.sparse_apply`;
        Qᵀ's output rows follow :meth:`apply_qt`'s order (per-segment R rows,
        chain rows, pass-through rows)."""
        if self._delegate is not None:
            return self._delegate._sparse_apply_parts(transpose)
        from .sparse_apply import segmented_structural_fill

        def fill(op, row_map):
            return segmented_structural_fill(self, op, transpose, row_map)

        fn = seg_qt if transpose else seg_q
        return fill, lambda factors, meta, M: fn(factors, M)

    def _sparse_apply_state(self):
        if self._delegate is not None:
            return self._delegate._sparse_apply_state()
        return self._full(), {}

    def apply_qt_sparse(self, s: SparseCSR) -> SparseCSR:
        """``Qᵀ · S`` for a host sparse operand, kept sparse (plan-cached per
        operand layout; one apply over all of S's columns)."""
        from .sparse_apply import solver_sparse_apply

        if self._delegate is not None:  # its program reads the delegate's factors
            return self._delegate.apply_qt_sparse(s)
        return solver_sparse_apply(self, s, True)

    def apply_q_sparse(self, s: SparseCSR) -> SparseCSR:
        """``Q · S`` for a host sparse operand (see :meth:`apply_qt_sparse`)."""
        from .sparse_apply import solver_sparse_apply

        if self._delegate is not None:
            return self._delegate.apply_q_sparse(s)
        return solver_sparse_apply(self, s, False)

    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        """Two-phase back-substitution (boundary chain, then interiors) of
        ``R z = y`` in P_split order."""
        if self._delegate is not None:
            return self._delegate.solve_r(y)
        return self._programs.solve(self, "SegmentedBandedQR.solve_r", (), _solve_r_program, y,
                                    mesh=self._program_mesh(), axis=self.axis)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Least-squares solve for ``b [rows]`` or ``[rows, k]``; the caller
        pre-applies ``rows_permutation()``.  K1 runs the segments' and the
        boundary chain's Qᵀ, K2 their back-substitutions."""
        if self._delegate is not None:
            return self._delegate.solve(b)
        return self._programs.solve(
            self, "SegmentedBandedQR.solve", (), segmented_solve.solve, b,
            mesh=self._program_mesh(), axis=self.axis,
        )

    def matrix_r_dense(self) -> torch.Tensor:
        """Dense R in P_split column order (tests)."""
        if self._delegate is not None:
            return self._delegate.matrix_r_dense()
        if self._segs is not None:
            return self._full().matrix_r_dense()
        n, m1, m2, o = self._ncols, self._m1, self._m2, self._overlap
        rp = self._r_panels.cpu().numpy()  # [S, L, me, mc]
        R = np.zeros((self._nrows, n), dtype=rp.dtype)
        lg = self._loc_geom
        for s in range(self.S):
            base = int(self._seg_col0[s])
            for j in range(self.L):
                if not self._active[s, j]:
                    continue
                er, nc = int(self._emit[s, j]), int(lg["ncols"][s, j])
                c0 = base + int(lg["cols"][s, j])
                R[c0 : c0 + er, c0 : c0 + nc] = rp[s, j, :er, :nc]
        jt = self._j2_top.cpu().numpy()  # [S, nloc, 2o]
        for s in range(self.S):
            nloc, r0 = self._seg_ncols[s], int(self._seg_col0[s])
            for c in range(2 * o):
                gb = (s - 1) * o + c
                if 0 <= gb < m2:
                    R[r0 : r0 + nloc, m1 + gb] = jt[s, :nloc, c]
        cr = self._chain_r.cpu().numpy()
        cg = self._chain_geom
        for i in range(len(cg["ncols"])):
            er, nc, c0 = int(cg["emit_rows"][i]), int(cg["ncols"][i]), int(cg["cols"][i])
            R[m1 + c0 : m1 + c0 + er, m1 + c0 : m1 + c0 + nc] = cr[i, :er, :nc]
        return torch.as_tensor(R, device=self.device)

    def matrix_r_sparse(self) -> SparseCSR:
        """Sparse R (P_split column order) in O(nnz(R)): interior panels,
        the boundary slabs' top rows and the boundary chain's panels."""
        if self._delegate is not None:
            return self._delegate.matrix_r_sparse()
        if self._segs is not None:
            return self._full().matrix_r_sparse()
        m1, m2, o = self._m1, self._m2, self._overlap
        lg = self._loc_geom
        trips = []
        rp = self._r_panels.cpu().numpy()
        base = (np.asarray(self._seg_col0)[:, None] + lg["cols"])[:, :, None, None]
        er = self._emit[:, :, None, None]
        nc = lg["ncols"][:, :, None, None]
        ri = np.arange(rp.shape[2])[None, None, :, None]
        ci = np.arange(rp.shape[3])[None, None, None, :]
        mask = self._active[:, :, None, None] & (ri < er) & (ci < nc) & (ri <= ci) & (rp != 0.0)
        trips.append((np.broadcast_to(base + ri, rp.shape)[mask],
                      np.broadcast_to(base + ci, rp.shape)[mask], rp[mask]))
        jt = self._j2_top.cpu().numpy()  # [S, nloc, 2o]
        rloc = np.asarray(self._seg_col0)[:, None, None] + np.arange(jt.shape[1])[None, :, None]
        gb = (np.arange(self.S) - 1)[:, None, None] * o + np.arange(2 * o)[None, None, :]
        maskt = (
            (np.arange(jt.shape[1])[None, :, None] < np.asarray(self._seg_ncols)[:, None, None])
            & (gb >= 0) & (gb < m2) & (jt != 0.0)
        )
        trips.append((np.broadcast_to(rloc, jt.shape)[maskt],
                      m1 + np.broadcast_to(gb, jt.shape)[maskt], jt[maskt]))
        cr = self._chain_r.cpu().numpy()
        cg = self._chain_geom
        c0 = cg["cols"][:, None, None]
        ri2 = np.arange(cr.shape[1])[None, :, None]
        ci2 = np.arange(cr.shape[2])[None, None, :]
        mask2 = (ri2 < cg["emit_rows"][:, None, None]) & (ci2 < cg["ncols"][:, None, None])
        mask2 = mask2 & (ri2 <= ci2) & (cr != 0.0)
        trips.append((m1 + np.broadcast_to(c0 + ri2, cr.shape)[mask2],
                      m1 + np.broadcast_to(c0 + ci2, cr.shape)[mask2], cr[mask2]))
        rows, cols, vals = (np.concatenate([t[i] for t in trips]) for i in range(3))
        return SparseCSR.from_triplets(rows, cols, vals, (self._nrows, self._ncols))

    def cols_permutation(self) -> Permutation:
        if self._delegate is not None:
            return self._delegate.cols_permutation()
        return self._cols_perm

    def rows_permutation(self) -> Permutation:
        if self._delegate is not None:
            return self._delegate.rows_permutation()
        return self._row_perm
