"""Factorize pipeline of the segmented banded solver.

Counterpart of ``qrkit_tpu/solvers/segmented_factorize.py``
(``build_factorize_fn``): panel and slab extraction through the gather
maps, phase 1 (the segment chains), phase 2 (Qᵀ of each segment on its
boundary slab), the bottom-row cut, the CAQR compression, the boundary
chain and the health flag, on torch tensors with no host synchronization.

Kernel mode (``SegmentedBandedQR._kernel_active``) runs phase 1 in one
launch of B3 (``ops.banded.segment_chains``), phase 2 for the uniform run of
segments in one launch of B4 (``segment_apply_w``, fed and composed through
the ``prepare_p2w`` maps; the generic segments take the general apply) and
the boundary chain in one launch of B5 (``chain_qr``) when its gate admits
it.  Otherwise every stage runs its general form.  The phase-2 slab apply
of the segments B4 does not take (or of all of them) is one launch of K1
(``two_segment_apply``) on the solver's chain-scan route.  The reference's
gather-free and merged extractions, the ``upto`` probes and the streaming
phase-2 applies are TPU-tier variants with no counterpart here.

Over a mesh every per-segment map and factor here is the rank's own
(``segmented_plan.shard_segments``): phases 1 and 2 and the CAQR run on the
rank's segments, one all-gather of the ``[S, 2o, 2o]`` CAQR R factors feeds
the boundary chain, which every rank runs whole, and the health flag's
interior part is all-reduced.
"""
from __future__ import annotations

import torch

from ..ops.banded import chain_factorize, chain_qr, segment_apply_w, segment_chains
from ..ops.compact_wy import TwoSegmentWYSeq
from ..ops.householder import build_t_factor, highest_precision, panel_qr_yt_soa
from ..parallel.mesh import all_reduce_sum
from .base import _diag_health
from .segmented_apply import two_seg


def p2w_window_rows(self, slab: torch.Tensor) -> torch.Tensor:
    """The W-apply kernel's operand ``[S, L, ma, ko]``: for each step's
    window row, the pristine slab row of a position's first toucher (one
    gather through the ``prepare_p2w`` feed map; sentinel → zero row)."""
    st = self._p2w["statics"]
    S, R, ko = slab.shape
    slab_pad = torch.cat([slab, slab.new_zeros((S, st["padr"] - R, ko))], dim=1)
    return slab_pad[:, self._p2w["feed"].reshape(-1)].reshape(S, self.L, st["ma"], ko)


def _fused_slab(self, slab, Yws, taus, Ts):
    """Phase-2 Qᵀ of the slab ``[S, R, ko]`` through the W-apply kernel: the
    kernel runs the reflector chains on the fed window rows, one gather
    composes the result from the last-writer emissions; the generic
    segments are recomputed by the general apply."""
    p2w = self._p2w
    st = p2w["statics"]
    S, R, ko = slab.shape
    LA = self.L * st["ma"]
    wq = segment_apply_w(
        Yws, taus, p2w_window_rows(self, slab), p2w["ab"],
        mca=st["mca"], h=st["h"], wrows=st["wrows"],
    )
    emitted = torch.cat([wq.reshape(S, LA, ko), slab.new_zeros((S, 1, ko))], dim=1)
    src = p2w["src"]
    qt = torch.where((src == LA)[None, :, None], slab, emitted[:, src])
    ex = p2w["excl"]
    if ex.numel():  # a rank of a mesh may hold no generic segment
        qt[ex] = two_seg(self)(
            Yws[ex], Ts[ex], self._starts[ex], self._rows2d[ex], self._carry2d[ex], slab[ex],
            self._kw["max_carry"], True,
        )
    return qt


def r_diagonal(self, Vs, chain_r) -> torch.Tensor:
    """diag(R) in P_split column order from the interior panels
    ``[S, L, me, mc]`` and the boundary chain's R panels (over a mesh the
    rank's interior part, summed over the ranks: the segments' columns are
    disjoint)."""
    n = self._ncols
    d = torch.diagonal(Vs, dim1=2, dim2=3)  # [S, L, k]
    j = torch.arange(d.shape[2], device=d.device)
    live = (j < self._emit_d[..., None]) & self._active_d[..., None]
    idx = torch.where(live, self._seg_col0_d[:, None, None] + self._starts[..., None] + j, n)
    out = d.new_zeros(n + 1).scatter_(0, idx.reshape(-1), d.reshape(-1))
    if self._segs is not None:
        out = all_reduce_sum(out, self.mesh, self.axis)
    cg = self._chain_geom_dev
    d2 = torch.diagonal(chain_r, dim1=1, dim2=2)
    j2 = torch.arange(d2.shape[1], device=d.device)
    idx2 = torch.where(j2 < cg["emit_rows"][:, None], self._m1 + cg["cols"][:, None] + j2, n)
    out.scatter_(0, idx2.reshape(-1), d2.reshape(-1))
    return out[:n]


@highest_precision()
def factorize(self, vals: torch.Tensor):
    """Factor from the stored-order value vector ``vals [nnz]`` on the
    device (kernels where ``self._fac_kernel``) → ``(Yws, Ts, Vs, j2_top,
    Yb, Tb, Ywc, Tc, chain_r, health)``, the health flag on the device too;
    :func:`adopt` stores them.  This is the segmented solver's factorize
    program."""
    o = self._overlap
    kw, ckw = self._kw, self._chain_kw
    kernel = self._fac_kernel
    if self._data_perm is not None:
        vals = vals[self._data_perm]
    pad = torch.cat([vals, vals.new_zeros(1)])
    slab = pad[self._slab_gmap]  # [S, R, 2o]
    # [S, L, ma, mc], carry shift folded in (behind _lead idle segments on
    # a rank of a mesh whose first segment is not segment 0)
    panels = pad[self._panel_gmap]
    lead = self._lead
    if kernel:
        ci, ci0_rest = self._kernel_ci
        Yws, taus, Vs = (t[lead:] for t in segment_chains(
            panels, self._kernel_act, mca=kw["max_carry"], me=kw["max_emit"],
            ci=ci, ci0_rest=ci0_rest,
        ))
    else:
        Yws, taus, Vs = chain_factorize(
            panels[lead:], self._colinc_d, self._active_d, kw["max_carry"], kw["max_emit"]
        )
    Ts = build_t_factor(Yws, taus)
    if kernel and self._p2w is not None:
        qt_slab = _fused_slab(self, slab, Yws, taus, Ts)
    else:
        qt_slab = two_seg(self)(
            Yws, Ts, self._starts, self._rows2d, self._carry2d, slab, kw["max_carry"], True
        )
    zero = qt_slab.new_zeros(())
    nloc, rbm = self._nloc_max, self._rbot_max
    j2_top = torch.where(self._top_valid[..., None], qt_slab[:, :nloc], zero)
    # each segment's bottom rows: the contiguous run after its local columns
    qs_pad = torch.cat([qt_slab, qt_slab.new_zeros((qt_slab.shape[0], rbm, 2 * o))], dim=1)
    rows = self._bot_starts[:, None] + torch.arange(rbm, device=qt_slab.device)
    bot = qs_pad.gather(1, rows[..., None].expand(-1, -1, 2 * o))
    bot = torch.where(self._bot_valid[..., None], bot, zero)
    # chain block 0 has no leading boundary: its columns are the slab's last o
    if self._segs is None or self._segs[0] == 0:
        bot = torch.cat([bot[:1].roll(-o, dims=2), bot[1:]])
    # CAQR: one batched QR reduces each [rbot, 2o] slab to its [2o, 2o] R
    Yb, Tb_soa, Rb_top = panel_qr_yt_soa(bot.permute(1, 2, 0))
    Tb = Tb_soa.permute(2, 0, 1)
    comp = self._gather_segments(torch.triu(Rb_top.permute(2, 0, 1)))
    pan = torch.cat([comp.reshape(-1), comp.new_zeros(1)])[self._chain_map]
    cg = self._chain_geom_dev
    if kernel and self._chain_kernel is not None:
        Ywc, taus_c, chain_r = chain_qr(pan, self._chain_act, **self._chain_kernel)
    else:
        active = torch.ones((1, pan.shape[0]), dtype=torch.bool, device=pan.device)
        Ywc, taus_c, chain_r = (
            t[0]
            for t in chain_factorize(
                pan[None], cg["col_inc"][None], active, ckw["max_carry"], ckw["max_emit"]
            )
        )
    health = _diag_health(r_diagonal(self, Vs, chain_r))
    return Yws, Ts, Vs, j2_top, Yb, Tb, Ywc, build_t_factor(Ywc, taus_c), chain_r, health


def adopt(self, out) -> None:
    """Store :func:`factorize`'s outputs as the solver's factors and leave
    the health flag on the device."""
    Yws, Ts, Vs, j2_top, Yb, Tb, Ywc, Tc, chain_r, health = out
    cg, ckw, plans = self._chain_geom_dev, self._chain_kw, self._chain_plans
    self._chain_seq = TwoSegmentWYSeq(
        Ywc, Tc, cg["cols"], cg["rows"], cg["carry_rows"], h1=max(ckw["max_carry"], 1),
        m=self._nbot2, kernel=self._scan_kernel, plan=(plans["qt"], plans["q"]),
    )
    self._Yws, self._Ts, self._r_panels, self._j2_top = Yws, Ts, Vs, j2_top
    self._Yb, self._Tb, self._chain_r = Yb, Tb, chain_r
    self._set_success(health)
