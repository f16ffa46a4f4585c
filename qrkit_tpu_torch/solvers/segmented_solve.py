"""Least-squares solve and back-substitution of the segmented banded solver.

Counterpart of ``qrkit_tpu/solvers/segmented_solve.py`` in its general form
(``build_solve_fn`` and ``build_solve_mat_fn``, one function here for a
vector or a ``[rows, k]`` rhs) and of ``SegmentedBandedQR.solve_r``.  On
the solver's chain-scan route a solve runs K1 twice (the segments' Qᵀ and
the boundary chain's) and K2 twice (the boundary chain's back-substitution
and the interior chains').  The reference's shared-scalar and unrolled
back-substitutions (``_banded_solve_chunk_shared(_static)``,
``_interior_backsub_split``) and its segment-space fast paths are TPU-tier
variants with no counterpart here.

Over a mesh the per-segment maps and factors are the rank's own: Qᵀ, the
CAQR Qbᵀ and the interior back-substitution run on the rank's segments,
their chain rows and interior solutions are gathered, and the boundary
chain's Qᵀ and solve run replicated.
"""
from __future__ import annotations

import torch

from ..ops.householder import highest_precision
from .banded_blocked import _banded_solve_chunk, _banded_solve_chunk_plain, banded_solve_r
from .segmented_apply import _batched_wy_soa, _scatter_rows, _with_zero_row, segments_qt


@highest_precision()
def backsub(self, y1: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    """Two-phase back-substitution in P_split order: the boundary chain
    ``R2 x2 = y2`` (``y2 [m2, k]``), then every segment's interior chain on
    ``y1 - J2_top x2`` (``y1 [m1, k]``).  Returns ``[m1 + m2, k]``."""
    k = y1.shape[1]
    o, m1 = self._overlap, self._m1
    ckw, cg = self._chain_kw, self._chain_geom_dev
    x2 = banded_solve_r(
        self._chain_r, cg["cols"], cg["emit_rows"], cg["ncols"], y2,
        max_emit=ckw["max_emit"], max_cols=ckw["max_cols"], n=self._m2, kernel=self._scan_kernel,
        plan=self._chain_plans["solve"],
    )
    zeros = x2.new_zeros((o, k))
    x2seg = torch.cat([zeros, x2, zeros])[self._x2_idx]  # [S, 2o, k]
    contrib = torch.einsum("snj,sjk->snk", self._j2_top, x2seg)  # [S, nloc, k]
    nloc = self._nloc_max
    sub = y1.new_zeros((m1 + 1, k)).index_add_(
        0, self._col_gather[:, :nloc].reshape(-1), contrib.reshape(-1, k)
    )[:m1]
    ypad = _with_zero_row(y1 - sub)[self._col_gather]  # [S, nloc + mc, k]
    xs = (_banded_solve_chunk if self._scan_kernel else _banded_solve_chunk_plain)(
        ypad, self._r_panels, self._starts, self._emit_d, self._ncols_d, self._active_d,
        max_emit=self._max_emit, max_cols=self._max_cols,
    )
    col_gather = self._global_maps.get("_col_gather", self._col_gather)
    x1 = _scatter_rows(col_gather.reshape(-1), self._gather_segments(xs).reshape(-1, k), m1)
    return torch.cat([x1, x2])


def solve(self, b: torch.Tensor) -> torch.Tensor:
    """Least-squares solve for ``b [rows]`` or ``[rows, k]`` (the caller
    pre-applies ``rows_permutation()``): per-segment Qᵀ, the bottom rows'
    Qbᵀ (only the 2o chain rows formed) and the chain's Qᵀ, the two-phase
    back-substitution, then the column permutation back."""
    vec = b.dim() == 1
    b2 = b[:, None] if vec else b
    k = b2.shape[1]
    o, m1 = self._overlap, self._m1
    out = segments_qt(self, b2)
    top = _scatter_rows(self._seg_gather.reshape(-1), out.reshape(-1, k), self._nrows)
    top = top[self._row_order]
    w = _with_zero_row(top[m1:])[self._rbot_gather]  # [S, rbm, k]
    w2o = _batched_wy_soa(self._Yb, self._Tb, w.permute(1, 2, 0), True, out_rows=2 * o)
    ybot = self._chain_seq.apply_qt(
        self._gather_segments(w2o.permute(2, 0, 1)).reshape(self._nbot2, k)
    )
    z = backsub(self, top[:m1], ybot[: self._m2])
    if self._gather_cols is not None:
        z = z[self._gather_cols]
    return z[:, 0] if vec else z
