"""Banded-blocked QR: the sequential chain, on torch tensors.

Counterpart of ``qrkit_tpu/solvers/banded_blocked.py`` (``banded_geometry``,
``banded_factorize``, ``_shift_panels``, ``_banded_solve_chunk``,
``banded_solve_r``, ``_rdiag_from_panels``, ``BandedBlockedQR``).  The
chain's left-to-right block loop carries the unsolved overlap rows of each
block's R into the next block's panel; Q stays implicit as a
:class:`~qrkit_tpu_torch.ops.compact_wy.TwoSegmentWYSeq` in panel
coordinates.

The factorize runs the whole chain either in one launch of the chain kernel
(``ops.banded.chain_qr``, kernel B5, when the plan has one body column
increment and the panel fits the kernel's shared memory) or through the
general recurrence ``ops.banded.chain_factorize``, whose per-step increments
may vary.  The panel row shift by each step's carry depth (the reference's
``_shift_panels`` on the device) is folded into the host-built gather map,
so a factorize is one gather of the value vector plus the chain.  The
reference's ``_CHUNK`` compile-bounding loop has no counterpart.

On the card a refactorize (``compute``'s device part, ``factorize_values``),
a solve, ``apply_q``, ``apply_qt`` and ``solve_r`` are each one captured
program (:mod:`~qrkit_tpu_torch._program`, the reference's jitted ``_fac`` /
``_fac_k`` and ``_sol``, ``CompactWYSeq._apply_seq`` and ``banded_solve_r``):
the factorize keyed by the layout maps and the route, the others by the rhs
shape and the factors they read; the factors are the factorize program's
outputs.  Inside the solve program, ``apply_qt`` and ``solve_r`` run inline.
The Q products run the chain's two-segment apply in one launch of kernel K1
and ``solve_r`` its back-substitution in one launch of K2
(``csrc/chain_apply.cu``), unless the route keeps their plain versions
(:func:`scan_route`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import resolve
from .._program import Programs, _upload
from ..analysis import as_banded_as_possible, block_banded_info, from_block_banded_pattern
from ..ops.banded import (
    SMEM_LIMIT, _banded_solve_chunk_plain, chain_factorize, chain_qr, chain_smem_bytes,
    solve_chunk_fits,
)
from ..ops.banded import banded_solve_chunk as _banded_solve_chunk  # the reference's name
from ..ops.chain_plan import solve_plan, two_segment_plan
from ..ops.compact_wy import TwoSegmentWYSeq, two_segment_fits
from ..ops.householder import build_t_factor
from ..plan import StructurePlan
from ..sparse import Permutation, SparseCSR
from .base import ComputationInfo, QRSolver, _diag_health

__all__ = [
    "BandedBlockedQR",
    "banded_factorize",
    "banded_geometry",
    "banded_solve_r",
    "device_values",
    "shifted_gather_map",
    "value_perm",
]


def banded_geometry(plan: StructurePlan):
    """Per-step chain geometry of a plan: ``carry_rows[i]`` rows of the
    previous R carried into step i, ``col_inc[i]`` the column shift that
    cuts the next carry, ``num_zeros[i]`` the gap rows between the carry and
    block segments, ``emit_rows[i]`` the R rows block i owns (host NumPy,
    identical to the reference)."""
    nb = plan.num_blocks
    rows_, cols_, nrows_, ncols_ = plan.as_arrays()
    carry_rows = np.zeros(nb, dtype=np.int64)
    num_zeros = np.zeros(nb, dtype=np.int64)
    col_inc = np.zeros(nb, dtype=np.int64)
    active = np.zeros(nb, dtype=np.int64)
    active[0] = nrows_[0]
    for i in range(nb - 1):
        overlap = (cols_[i] + ncols_[i]) - cols_[i + 1]
        ci = ncols_[i] - overlap
        col_inc[i] = ci
        # the carry holds R's live unsolved rows (at most min(active, ncols)
        # - ci) and reserves window space so the panel's top ncols rows map
        # onto the R positions of the next block
        live = max(min(active[i], ncols_[i]) - ci, 0)
        gapcap = rows_[i + 1] - cols_[i + 1]
        carry_rows[i + 1] = max(live, min(ncols_[i + 1], gapcap))
        active[i + 1] = carry_rows[i + 1] + nrows_[i + 1]
        nz = rows_[i + 1] - carry_rows[i + 1] - cols_[i + 1]
        num_zeros[i + 1] = max(nz, 0)
    solved = np.asarray(plan.solved_rows(), dtype=np.int64)
    emit_rows = np.minimum(solved, ncols_)
    return {
        "carry_rows": carry_rows,
        "col_inc": col_inc,
        "num_zeros": num_zeros,
        "active": active,
        "emit_rows": emit_rows,
        "nrows": nrows_,
        "ncols": ncols_,
        "cols": cols_,
        "rows": rows_,
    }


def shifted_gather_map(
    gm: np.ndarray, carry_rows: np.ndarray, nrows: np.ndarray, max_active: int, sentinel: int
) -> np.ndarray:
    """Fold each panel's row shift by its carry depth into a gather map:
    ``gm [nb, mR, mc]`` → ``[nb, max_active, mc]`` whose row ``r`` is panel
    row ``r - carry_rows`` (``sentinel`` outside ``[0, nrows)``) — the
    reference's ``_shift_panels``, done once on the host."""
    nb, mR = gm.shape[:2]
    src = np.arange(max_active)[None, :] - np.asarray(carry_rows)[:, None]
    valid = (src >= 0) & (src < np.asarray(nrows)[:, None])
    out = np.take_along_axis(gm, np.clip(src, 0, max(mR - 1, 0))[:, :, None], axis=1)
    return np.where(valid[:, :, None], out, sentinel)


def banded_factorize(
    shifted: torch.Tensor, geom: dict, *, max_carry: int, max_emit: int
):
    """Banded-chain factorization of pre-shifted panels ``[nb, ma, mc]``
    with the general recurrence.  ``geom`` holds int64 tensors ``col_inc``
    on the panels' device.  Returns ``(Y [nb, ma, mc], taus [nb, mc], R
    panels [nb, max_emit, mc])``."""
    nb = shifted.shape[0]
    active = torch.ones((1, nb), dtype=torch.bool, device=shifted.device)
    Y, taus, V = chain_factorize(shifted[None], geom["col_inc"][None], active, max_carry, max_emit)
    return Y[0], taus[0], V[0]


def _factorize_program(self, vals: torch.Tensor):
    """The refactorize of :class:`BandedBlockedQR` from the stored-order
    value vector: the row permutation's gather, the shifted panels' gather,
    the chain (B5 or the general recurrence), T and the health flag →
    ``(Y, T, R panels, health)``, all on the device."""
    if self._data_perm is not None:
        vals = vals[self._data_perm]
    pad = torch.cat([vals, vals.new_zeros(1)])
    panels = pad[self._panel_gmap]  # [nb, max_active, max_cols]
    g = self._geom_dev
    if self._fac_kernel:
        Y, taus, V = chain_qr(panels, self._chain_act, **self._chain_kernel)
    else:
        Y, taus, V = banded_factorize(panels, g, max_carry=self._max_carry, max_emit=self._max_emit)
    health = _diag_health(_rdiag_from_panels(V, g["cols"], g["emit_rows"], self._ncols))
    return Y, build_t_factor(Y, taus), V, health


def _solve_program(self, b: torch.Tensor) -> torch.Tensor:
    return self.solve_r(self.apply_qt(b))  # the inner programs run inline


def _apply_q_program(self, m: torch.Tensor) -> torch.Tensor:
    return self.q_seq.apply_q(m)


def _apply_qt_program(self, m: torch.Tensor) -> torch.Tensor:
    return self.q_seq.apply_qt(m)


def _solve_r_program(self, y: torch.Tensor) -> torch.Tensor:
    g = self._geom_dev
    return banded_solve_r(
        self._r_panels, g["cols"], g["emit_rows"], g["ncols"], y[: self._ncols],
        max_emit=self._max_emit, max_cols=self._max_cols, n=self._ncols, kernel=self._scan_kernel,
        plan=self._chain_plans["solve"],
    )


def scan_plans(geom: dict, *, h1: int, A: int, m: int, max_emit: int, max_cols: int, n: int,
               device, kernel: bool) -> dict:
    """The chunk plans of a chain's scans from its host geometry
    (:func:`banded_geometry`), uploaded to ``device``: ``"qt"`` / ``"q"``
    for K1's two directions (``TwoSegmentWYSeq(..., plan=)``) and
    ``"solve"`` for K2 (:func:`banded_solve_r`); each None for a chain of
    one chunk, and all None off the kernels' route (``kernel`` False)."""
    if not kernel:
        return {"qt": None, "q": None, "solve": None}
    k1 = dict(h1=h1, A=A, m=m, device=device)
    g = geom
    return {
        "qt": two_segment_plan(g["cols"], g["rows"], g["carry_rows"], transpose=True, **k1),
        "q": two_segment_plan(g["cols"], g["rows"], g["carry_rows"], transpose=False, **k1),
        "solve": solve_plan(g["cols"], g["emit_rows"], g["ncols"], np.ones(len(g["cols"]), bool),
                            max_emit=max_emit, max_cols=max_cols, rows=n + max_cols,
                            device=device),
    }


def scan_route(use_kernel, fits: bool, geometry: str) -> bool:
    """Whether a solver's chain scans run through the wrappers of K1 and K2
    (the kernels on the card, their plain versions on the CPU), from its
    ``use_kernel`` and whether its geometry ``fits`` (decided at analysis):
    ``use_kernel=False`` keeps the plain versions, a geometry the kernels
    cannot hold takes them too under ``"auto"`` and raises under ``True``."""
    if use_kernel is False:
        return False
    if not fits and use_kernel is True:
        raise ValueError(
            f"use_kernel=True but the chain-scan kernels cannot hold {geometry} "
            "in a CTA's shared memory; use use_kernel='auto'"
        )
    return fits


def banded_solve_r(
    r_panels: torch.Tensor,
    cols: torch.Tensor,
    emit_rows: torch.Tensor,
    ncols_arr: torch.Tensor,
    y: torch.Tensor,
    *,
    max_emit: int,
    max_cols: int,
    n: int,
    kernel: bool = True,
    plan=None,
) -> torch.Tensor:
    """Solve R x = y for the banded R stored as per-block panels
    ``[nb, max_emit, max_cols]`` without forming R; ``y`` is ``[n]`` or
    ``[n, k]``.  ``kernel``: through K2's wrapper (the solver's route,
    with its chunk ``plan``), else its plain version."""
    vec = y.dim() == 1
    y2 = y[:, None] if vec else y
    ypad = torch.cat([y2, y2.new_zeros((max_cols, y2.shape[1]))])
    nb = r_panels.shape[0]
    active = torch.ones((1, nb), dtype=torch.bool, device=y.device)
    args = (ypad[None], r_panels[None], cols[None], emit_rows[None], ncols_arr[None], active)
    if kernel:
        xpad = _banded_solve_chunk(*args, max_emit=max_emit, max_cols=max_cols, plan=plan)[0]
    else:
        xpad = _banded_solve_chunk_plain(*args, max_emit=max_emit, max_cols=max_cols)[0]
    return xpad[:n, 0] if vec else xpad[:n]


def value_perm(mat: SparseCSR, row_perm: Permutation, device) -> Optional[torch.Tensor]:
    """The row permutation's effect on a value vector, as a device gather
    (None for the identity)."""
    if row_perm.is_identity():
        return None
    return torch.as_tensor(mat.row_perm_data_map(row_perm), dtype=torch.int64, device=device)


def device_values(solver, values) -> torch.Tensor:
    """``factorize_values``' input as a device vector of the solver's dtype,
    in the analyzed matrix's stored order (the factorize program applies the
    row permutation): a tensor (already on the device: no host work, no
    copy) or a NumPy array (uploaded), ``mat.nnz`` long."""
    if getattr(solver, "_panel_gmap", None) is None:
        raise ValueError(
            "factorize_values requires a prior compute() on a matrix "
            "with this stored-nonzero layout"
        )
    if not isinstance(values, torch.Tensor):
        values = _upload(np.asarray(values), (solver.device, solver.dtype))
    vals = values.to(device=solver.device, dtype=solver.dtype)
    if vals.dim() != 1 or vals.shape[0] != solver._vals_nnz:
        raise ValueError(
            f"values must be [{solver._vals_nnz}] (the analyzed matrix's "
            f"stored-nonzero count), got {tuple(vals.shape)}"
        )
    return vals


def _rdiag_from_panels(r_panels, cols, emit_rows, ncols: int) -> torch.Tensor:
    """diag(R) [ncols] scattered from ``[nb, max_emit, max_cols]`` panels."""
    d = torch.diagonal(r_panels, dim1=1, dim2=2)  # [nb, k]
    j = torch.arange(d.shape[1], device=d.device)
    idx = torch.where(j < emit_rows[:, None], cols[:, None] + j, ncols)
    out = d.new_zeros(ncols + 1).scatter_(0, idx.reshape(-1), d.reshape(-1))
    return out[:ncols]


class BandedBlockedQR(QRSolver):
    """QR of a (row-permuted) block-banded sparse matrix.

    ``block_rows/block_cols/block_overlap`` given → a static known pattern;
    otherwise ``analyze_pattern`` orders the rows as-banded-as-possible and
    detects the blocks.  The input is a host :class:`SparseCSR`; factors
    live on ``device`` in ``dtype`` (default CUDA, float64).

    ``use_kernel``: ``"auto"`` runs the chain kernel B5 on a CUDA device when
    the plan admits it (at least 32 blocks, one column increment on steps
    1..nb-2, the panel within the kernel's shared memory); ``True`` demands
    it (raising on a plan it cannot take; on the CPU it runs the kernel's
    plain version); ``False`` keeps the general recurrence.  The Q products
    and the back-substitution take the kernels K1 and K2 under ``"auto"``
    and ``True`` (on a CUDA device; a panel beyond their shared memory runs
    their plain versions under ``"auto"`` and raises under ``True``) and
    their plain versions under ``False``.
    """

    def __init__(
        self,
        block_rows: Optional[int] = None,
        block_cols: Optional[int] = None,
        block_overlap: Optional[int] = None,
        suggested_block_cols: int = 2,
        use_kernel="auto",
        *,
        device=None,
        dtype=None,
    ):
        if use_kernel not in ("auto", True, False):
            raise ValueError(f"use_kernel must be 'auto', True or False, got {use_kernel!r}")
        self._static = None not in (block_rows, block_cols, block_overlap)
        self._brows, self._bcols, self._boverlap = block_rows, block_cols, block_overlap
        self._suggested = suggested_block_cols
        self.use_kernel = use_kernel
        self.device = resolve(device)
        self.dtype = dtype if dtype is not None else torch.float64
        self._analysis_ok = False
        self._fac_kernel = False
        self._programs = Programs()
        self._layout_version = 0  # keys the factorize program: bumped with the maps

    @property
    def rows(self) -> int:
        return self._nrows

    @property
    def cols(self) -> int:
        return self._ncols

    # --- analysis -----------------------------------------------------------------
    def analyze_pattern(self, mat: SparseCSR):
        self._nrows, self._ncols = mat.shape
        if self._static:
            self._row_perm = Permutation.identity(mat.nrows)
            self.plan = from_block_banded_pattern(
                mat.nrows, mat.ncols, self._brows, self._bcols, self._boverlap,
                self._suggested,
            )
        else:
            self._row_perm, has_perm = as_banded_as_possible(mat)
            sorted_mat = mat.permute_rows(self._row_perm) if has_perm else mat
            self.plan = block_banded_info(sorted_mat, self._suggested)
        return self._finish_analysis()

    def set_analysis(self, plan: StructurePlan, row_perm: Optional[Permutation] = None):
        """Install a precomputed plan (and row permutation)."""
        self._nrows, self._ncols = plan.nrows, plan.ncols
        self._row_perm = row_perm if row_perm is not None else Permutation.identity(plan.nrows)
        self.plan = plan
        return self._finish_analysis()

    def _finish_analysis(self):
        if self.plan.num_blocks == 0:
            self._info = ComputationInfo.INVALID_INPUT
            raise ValueError(
                "pattern analysis found no blocks (matrix empty or no row is "
                "portrait-mergeable); cannot factorize"
            )
        self.geom = g = banded_geometry(self.plan)
        self._max_active = int(g["active"].max())
        self._max_cols = int(g["ncols"].max())
        self._max_carry = max(int(g["carry_rows"].max()), 1)
        self._max_emit = int(g["emit_rows"].max())
        self._mR = int(g["nrows"].max())
        # the static geometry goes to the device once per plan
        self._geom_dev = {
            k: torch.as_tensor(g[k], dtype=torch.int64, device=self.device)
            for k in ("carry_rows", "col_inc", "cols", "rows", "emit_rows", "ncols")
        }
        self._panel_gmap = None  # layout gather map, built at first compute
        # chain-kernel gate: one uniform column increment on steps 1..nb-2
        # (the first may differ; the last step's carry cut is never read)
        # and, replacing the reference's TPU bounds (max_cols <= 32,
        # max_active <= 512), the kernel's shared memory within the H100's
        # 227 KB a CTA
        self._chain_kernel = None
        nb, cis = self.plan.num_blocks, g["col_inc"]
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        # the Q products' and the back-substitution's kernels (K1, K2)
        self._scan_fits = two_segment_fits(
            self._max_active, self._max_cols, itemsize
        ) and solve_chunk_fits(self._max_emit, self._max_cols, itemsize)
        smem = chain_smem_bytes(self._max_active, self._max_cols, self._max_carry, itemsize)
        if nb >= 32 and smem <= SMEM_LIMIT:
            ciu = int(cis[1]) if nb >= 3 else int(cis[0])
            if (cis[1 : nb - 1] == ciu).all():
                self._chain_kernel = dict(
                    mca=self._max_carry, me=self._max_emit, ci=ciu, ci0=int(cis[0])
                )
                self._chain_act = torch.ones(nb, dtype=self.dtype, device=self.device)
        self._scan_kernel = self._scan_route()  # again at each factorize
        # the chunk plans of the Q products and the back-substitution
        self._chain_plans = scan_plans(
            g, h1=self._max_carry, A=self._max_active, m=self._nrows, max_emit=self._max_emit,
            max_cols=self._max_cols, n=self._ncols, device=self.device, kernel=self._scan_kernel,
        )
        self._analysis_ok = True
        return self

    def _kernel_active(self) -> bool:
        if self.use_kernel is False:
            return False
        if self.use_kernel is True:
            if self._chain_kernel is None:
                raise ValueError(
                    "use_kernel=True but the plan geometry is not supported by "
                    "the chain kernel (short chain, non-uniform column step or "
                    "panel too large); use use_kernel='auto'"
                )
            return True
        return self._chain_kernel is not None and self.device.type == "cuda"

    def _scan_route(self) -> bool:
        """Whether the Q products and the back-substitution run through the
        wrappers of K1 and K2 (:func:`scan_route`)."""
        return scan_route(
            self.use_kernel, self._scan_fits,
            f"panels {self._max_active}×{self._max_cols} and R panels "
            f"{self._max_emit}×{self._max_cols}",
        )

    # --- factorization ------------------------------------------------------------
    def _layout_maps(self, mat: SparseCSR, pmat: SparseCSR) -> None:
        """Gather map of the shifted panels ``[nb, max_active, max_cols]``
        over the value vector plus one zero, keyed on the stored-nonzero
        layout (a pruned entry shifts every later data index), and the row
        permutation's effect on a value vector."""
        g = self.geom
        gm = pmat.panels_gather_map(
            [b.astuple() for b in self.plan.blocks], self._mR, self._max_cols
        )
        gms = shifted_gather_map(gm, g["carry_rows"], g["nrows"], self._max_active, pmat.nnz)
        self._panel_gmap = torch.as_tensor(gms, dtype=torch.int64, device=self.device)
        self._vals_nnz, self._data_perm = mat.nnz, value_perm(mat, self._row_perm, self.device)
        self._layout_version += 1

    def compute(self, mat: SparseCSR, force_pattern_analysis: bool = False):
        if not self._analysis_ok or force_pattern_analysis:
            self.analyze_pattern(mat)
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
        card (:func:`_factorize_program`); leaves the health flag on the
        device."""
        self._fac_kernel = self._kernel_active()
        self._scan_kernel = self._scan_route()
        Y, T, self._r_panels, health = self._programs.factorize(
            self, "BandedBlockedQR.factorize",
            (self._layout_version, self._fac_kernel, self._scan_kernel),
            _factorize_program, vals, upload=(self.device, self.dtype),
        )
        g = self._geom_dev
        plans = self._chain_plans
        self.q_seq = TwoSegmentWYSeq(
            Y, T, g["cols"], g["rows"], g["carry_rows"], h1=max(self._max_carry, 1), m=self._nrows,
            kernel=self._scan_kernel, plan=(plans["qt"], plans["q"]),
        )
        self._set_success(health)

    def factorize_values(self, values) -> "BandedBlockedQR":
        """Refactorize from a vector of stored-nonzero values in the analyzed
        matrix's stored order (``mat.data``, length ``mat.nnz``), after one
        :meth:`compute` established the pattern.  A tensor already on the
        device refactorizes with no host work and no host→device copy; a
        NumPy array is uploaded like ``compute`` does."""
        self._factorize(device_values(self, values))
        return self

    @property
    def r_panels(self) -> torch.Tensor:
        """R panels ``[nb, max_emit, max_cols]``, a copy: the factor is the
        factorize program's output, which the next refactorize overwrites."""
        return self._r_panels.clone()

    def r_diagonal(self) -> torch.Tensor:
        g = self._geom_dev
        return _rdiag_from_panels(self._r_panels, g["cols"], g["emit_rows"], self._ncols)

    # --- Q / R --------------------------------------------------------------------
    def apply_q(self, m: torch.Tensor) -> torch.Tensor:
        """Q · m for ``m [rows]`` or ``[rows, k]``: the chain in reverse, one
        captured program on the card."""
        return self._programs.solve(self, "BandedBlockedQR.apply_q", (), _apply_q_program, m)

    def apply_qt(self, m: torch.Tensor) -> torch.Tensor:
        """Qᵀ · m (see :meth:`apply_q`)."""
        return self._programs.solve(self, "BandedBlockedQR.apply_qt", (), _apply_qt_program, m)

    def matrix_q_sparse(self):
        """Explicit sparse Q of the row-permuted matrix (chunked Q·I)."""
        return self.q_seq.to_sparse_q()

    # --- sparse-operand Q products ------------------------------------------------
    def _sparse_apply_parts(self, transpose: bool):
        """(fill_fn, apply_fn) for :mod:`~qrkit_tpu_torch.solvers.sparse_apply`."""
        from .sparse_apply import banded_structural_fill

        geom, nb, m = self.geom, self.plan.num_blocks, self._nrows

        def fill(op, row_map):
            return banded_structural_fill(geom, nb, m, op, transpose, row_map)

        if transpose:
            return fill, lambda factors, meta, M: factors.apply_qt(M)
        return fill, lambda factors, meta, M: factors.apply_q(M)

    def _sparse_apply_state(self):
        return self.q_seq, {}

    def apply_qt_sparse(self, s: SparseCSR) -> SparseCSR:
        """``Qᵀ · S`` for a host sparse operand, kept sparse: one apply of
        the chain over all of S's columns (plan-cached per operand layout)."""
        from .sparse_apply import solver_sparse_apply

        return solver_sparse_apply(self, s, True)

    def apply_q_sparse(self, s: SparseCSR) -> SparseCSR:
        """``Q · S`` for a host sparse operand (see :meth:`apply_qt_sparse`)."""
        from .sparse_apply import solver_sparse_apply

        return solver_sparse_apply(self, s, False)

    def matrix_r_sparse(self) -> SparseCSR:
        """Sparse banded R in O(nnz(R)) from the per-block panels."""
        panels = self._r_panels.cpu().numpy()
        g = self.geom
        er = g["emit_rows"][:, None, None]
        nc = g["ncols"][:, None, None]
        c0 = g["cols"][:, None, None]
        ri = np.arange(panels.shape[1])[None, :, None]
        ci = np.arange(panels.shape[2])[None, None, :]
        mask = (ri < er) & (ci < nc) & (ri <= ci) & (panels != 0.0)
        rows = np.broadcast_to(c0 + ri, panels.shape)[mask]
        cols = np.broadcast_to(c0 + ci, panels.shape)[mask]
        return SparseCSR.from_triplets(rows, cols, panels[mask], (self._nrows, self._ncols))

    def matrix_r_dense(self) -> torch.Tensor:
        g = self.geom
        panels = self._r_panels.cpu().numpy()
        R = np.zeros((self._nrows, self._ncols), dtype=panels.dtype)
        for i, b in enumerate(self.plan.blocks):
            er, nc = int(g["emit_rows"][i]), int(g["ncols"][i])
            R[b.col : b.col + er, b.col : b.col + nc] = panels[i, :er, :nc]
        return torch.as_tensor(R, device=self.device)

    def solve_r(self, y: torch.Tensor) -> torch.Tensor:
        """R x = y[:cols] for ``y [n]`` or ``[n, k]``: the blocked
        back-substitution, one captured program on the card."""
        return self._programs.solve(self, "BandedBlockedQR.solve_r", (), _solve_r_program, y)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Least-squares solve for a vector ``[rows]`` or a matrix ``[rows,
        k]`` rhs: Qᵀb (kernel K1), then one batched back-substitution (K2),
        one captured program on the card.  The caller pre-applies
        ``rows_permutation()``."""
        return self._programs.solve(self, "BandedBlockedQR.solve", (), _solve_program, b)

    def rows_permutation(self) -> Permutation:
        return self._row_perm
