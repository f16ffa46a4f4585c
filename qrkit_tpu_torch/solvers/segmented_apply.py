"""Q and Qᵀ of the segmented banded solver on a whole matrix operand.

Counterpart of ``qrkit_tpu/solvers/segmented_apply.py``: ``_batched_wy_soa``
(and ``_batched_wy_cols``, the same apply in another TPU layout),
``_seg_qt_program`` and ``_seg_q_program``.  The per-segment two-segment
applies (the reference's ``_segment_apply`` / ``_segment_apply_cols``) are
:func:`~qrkit_tpu_torch.ops.compact_wy.two_segment_apply` (kernel K1),
batched over segments.  The reference's shared-scalar, statically unrolled and
streaming forms of the phase-2 apply (``_segment_apply_cols_shared``,
``_shared_static``, ``_stream``, ``_stream_gap``, ``_apply_cols_split``)
exist to dodge TPU dispatch latency and lane padding; the port has the
general form only.

Index maps carry a sentinel one past the end of the operand they read (a
zero row is appended) or write (the extra row is cut off), in place of the
reference's out-of-bounds ``mode="drop"`` scatters.
"""
from __future__ import annotations

import torch

from ..ops.compact_wy import _two_segment_apply_plain, two_segment_apply
from ..ops.householder import highest_precision


def two_seg(self):
    """The solver's two-segment apply: K1's wrapper on its kernel route
    (``self._scan_kernel``), else the plain version."""
    return two_segment_apply if self._scan_kernel else _two_segment_apply_plain


@highest_precision()
def _batched_wy_soa(Y_soa, T_aos, w_soa, transpose: bool, out_rows=None):
    """Batched compact-WY apply with the batch axis last: ``Y_soa
    [m, n, S]`` (the CAQR factors as stored), ``T_aos [S, n, n]``, ``w_soa
    [m, k, S]`` → ``w + Y (T or Tᵀ) (Yᵀ w)``; with ``out_rows=r`` only the
    first r output rows are formed."""
    u = torch.einsum("mns,mks->nks", Y_soa, w_soa)
    Tm = T_aos.permute(2, 1, 0) if transpose else T_aos.permute(1, 2, 0)
    z = torch.einsum("ijs,jks->iks", Tm, u)
    Yr = Y_soa if out_rows is None else Y_soa[:out_rows]
    wr = w_soa if out_rows is None else w_soa[:out_rows]
    return wr + torch.einsum("mns,nks->mks", Yr, z)


def _with_zero_row(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, v.new_zeros((1,) + v.shape[1:])])


def _scatter_rows(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """``out[idx[i]] = vals[i]`` into ``n`` rows; index ``n`` is discarded."""
    out = vals.new_zeros((n + 1,) + vals.shape[1:])
    out[idx] = vals
    return out[:n]


def segments_qt(self, v: torch.Tensor) -> torch.Tensor:
    """Phase-1 Qᵀ of every segment on ``v [nrows, k]`` → ``[S, R, k]``
    (segment rows, padded)."""
    vs = _with_zero_row(v)[self._seg_gather]
    return two_seg(self)(
        self._Yws, self._Ts, self._starts, self._rows2d, self._carry2d, vs,
        self._kw["max_carry"], True,
    )


def seg_qt(self, v2: torch.Tensor) -> torch.Tensor:
    """Whole Qᵀ·M, ``M [nrows, k]``: per-segment Qᵀ (block diagonal over
    segments), the R rows of every segment first, then the compressed
    boundary reduction (block-diagonal Qbᵀ, then the chain's Qᵀ) on the
    bottom rows."""
    k = v2.shape[1]
    S, o, m1 = self.S, self._overlap, self._m1
    nbot, nbot2, rbm = self._nbot, self._nbot2, self._rbot_max
    out = segments_qt(self, v2)
    top = _scatter_rows(self._seg_gather.reshape(-1), out.reshape(-1, k), self._nrows)
    top = top[self._row_order]
    w = _with_zero_row(top[m1:])[self._rbot_gather]  # [S, rbm, k]
    w = _batched_wy_soa(self._Yb, self._Tb, w.permute(1, 2, 0), True)  # [rbm, k, S]
    z = self._chain_seq.apply_qt(w[: 2 * o].permute(2, 0, 1).reshape(nbot2, k))
    bout = v2.new_zeros((nbot + 1, k))
    bout[:nbot2] = z
    if rbm > 2 * o:
        bout[self._rest_pos.reshape(-1)] = w[2 * o :].permute(2, 0, 1).reshape(-1, k)
    return torch.cat([top[:m1], bout[:nbot]])


def seg_q(self, v2: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`seg_qt`: the chain's Q and block-diagonal Qb on the
    bottom rows, back to natural row order, then the per-segment Q."""
    k = v2.shape[1]
    S, o, m1 = self.S, self._overlap, self._m1
    nbot, nbot2, rbm = self._nbot, self._nbot2, self._rbot_max
    vb = v2[m1:]
    w = self._chain_seq.apply_q(vb[:nbot2]).reshape(S, 2 * o, k)
    if rbm > 2 * o:
        w = torch.cat([w, _with_zero_row(vb)[self._rest_pos]], dim=1)
    w = _batched_wy_soa(self._Yb, self._Tb, w.permute(1, 2, 0), False)  # [rbm, k, S]
    bout = _scatter_rows(self._rbot_gather.reshape(-1), w.permute(2, 0, 1).reshape(-1, k), nbot)
    nat = torch.cat([v2[:m1], bout])[self._row_order_inv]
    vs = _with_zero_row(nat)[self._seg_gather]
    out = two_seg(self)(
        self._Yws, self._Ts, self._starts, self._rows2d, self._carry2d, vs,
        self._kw["max_carry"], False,
    )
    return _scatter_rows(self._seg_gather.reshape(-1), out.reshape(-1, k), self._nrows)
