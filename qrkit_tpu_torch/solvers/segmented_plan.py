"""Plan-time preparation for the segmented banded solver (host NumPy).

Counterpart of ``qrkit_tpu/solvers/segmented_plan.py`` (``segment_plan``,
``prepare_segmentation``, ``prepare_p2_gate``, ``prepare_pallas_gate``,
``_p2w_sim_segment``, ``prepare_p2w``) and of ``_p2_stream_plan``
(``segmented_apply.py:167``), of which the phase-2 gate needs the
validity test (``_p2_stream_ok``).  Functions take
the :class:`~qrkit_tpu_torch.solvers.segmented_banded.SegmentedBandedQR`
instance as ``self``.  Every map and geometry array goes to the solver's
device once, here, per plan; the layout-keyed gather maps follow at the
first ``compute``.

The host arrays equal the reference's (tests/test_torch_host.py holds them
to it).  What differs:

* the gates' size limits are the CUDA kernels' shared memory
  (``ops.banded.chain_smem_bytes`` / ``apply_w_smem_bytes`` against 227 KB)
  in place of the TPU's VMEM budgets and unroll bounds;
* the W-apply kernel takes all ``ko`` operand columns in one pass, so the
  TPU's column group ``kg`` does not exist;
* the boundary chain has ONE gather map over the CAQR factors, with the
  regrouping and each step's carry-row shift folded in; the chain kernel
  and the general recurrence both read it (the reference keeps an unshifted
  regroup map for its XLA scan and a shifted X-layout map for its kernel);
* the interior back-substitution's shared-scalar gate (``_bs_*``), the
  streaming-apply plans and the gather-free extraction detection serve
  TPU-tier variants the port does not have;
* over a mesh (:func:`shard_segments`) each rank cuts every per-segment map
  to its own segments at plan time, where the reference places the
  computed factors sharded.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.banded import SMEM_LIMIT, apply_w_smem_bytes, chain_smem_bytes, solve_chunk_fits
from ..ops.compact_wy import two_segment_fits
from ..parallel.mesh import mesh_rank, shard_bounds
from ..plan import BlockInfo, StructurePlan
from ..sparse import Permutation
from .banded_blocked import banded_geometry, scan_plans


def _dev(self, a, dtype=torch.int64) -> torch.Tensor:
    """A plan array on the solver's device."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)


def _itemsize(self) -> int:
    return torch.empty((), dtype=self.dtype).element_size()


def segment_plan(self):
    """Segmentation bookkeeping for an installed ``self.plan``; raises
    ValueError on a plan that cannot be segmented."""
    self._nrows, self._ncols = self.plan.nrows, self.plan.ncols
    p = self.plan
    nb = p.num_blocks
    if nb < 2 * self.L:
        raise ValueError("chain too short for segmentation; use BandedBlockedQR")
    b0 = p.blocks[0]
    body = p.blocks[1:-1]
    if not all(b.nrows == b0.nrows and b.ncols == b0.ncols for b in body):
        raise ValueError("non-uniform plan; use BandedBlockedQR")
    g = banded_geometry(p)
    step = int(g["col_inc"][0])
    if not np.all(g["col_inc"][:-1] == step):
        raise ValueError("non-uniform column step; use BandedBlockedQR")
    self._overlap = b0.ncols - step
    if self._overlap <= 0:
        raise ValueError("no overlap: use BlockDiagonalQR for this structure")
    if self._overlap > step:
        raise ValueError("overlap exceeds column step; use BandedBlockedQR")
    self.geom = g
    self._panel_gmap = None  # layout-keyed maps, rebuilt at the next compute
    prepare_segmentation(self)
    self._analysis_ok = True
    return self


def prepare_segmentation(self):
    """Pattern-only segmentation bookkeeping, run once per plan: segment
    spans, per-segment local plans and geometry, the panel descriptor list,
    the P_split column permutation, the boundary chain and the row/column
    maps of the solve, then the kernel gates."""
    p = self.plan
    nb, L = p.num_blocks, self.L
    o = self._overlap
    S = -(-nb // L)
    self.S = S
    rows_, cols_, nrows_, ncols_ = p.as_arrays()

    # --- segment row/column spans ---------------------------------------------
    seg_first = [s * L for s in range(S)]
    seg_last = [min((s + 1) * L, nb) - 1 for s in range(S)]
    seg_row0 = [int(rows_[f]) for f in seg_first]
    seg_row1 = [
        int(rows_[l] + nrows_[l]) if l == nb - 1 else int(rows_[seg_first[s + 1]])
        for s, l in enumerate(seg_last)
    ]
    self._seg_rows = [r1 - r0 for r0, r1 in zip(seg_row0, seg_row1)]
    self._seg_row0 = seg_row0
    max_seg_rows = max(self._seg_rows)

    # boundary columns: the first o columns of segments 1..S-1
    bcols = []
    for s in range(1, S):
        c0 = int(cols_[seg_first[s]])
        bcols.extend(range(c0, c0 + o))
    self._bcols_idx = np.asarray(bcols, dtype=np.int64)
    interior_mask = np.ones(self._ncols, dtype=bool)
    interior_mask[self._bcols_idx] = False
    self._icols_idx = np.nonzero(interior_mask)[0]
    self._m1 = int(self._icols_idx.size)
    self._m2 = int(self._bcols_idx.size)

    self._seg_ncols = []
    for s in range(S):
        f, l = seg_first[s], seg_last[s]
        c_end = int(cols_[l] + ncols_[l]) - o if l < nb - 1 else self._ncols
        c_begin = int(cols_[f]) + (o if s > 0 else 0)
        self._seg_ncols.append(c_end - c_begin)
    self._seg_col0 = np.concatenate([[0], np.cumsum(self._seg_ncols)])[:-1]

    # --- per-segment local plans: a standalone chain over the interior
    # columns (leading o columns of segments 1.. and trailing o columns of
    # segments ..S-2 are boundary columns, excluded) ------------------------------
    mR = int(nrows_.max())
    seg_geoms, seg_plans = [], []
    for s_i in range(S):
        f, l = seg_first[s_i], seg_last[s_i]
        colbase = int(cols_[f]) + (o if s_i > 0 else 0)
        blocks_s = []
        for i in range(f, l + 1):
            drop_lead = o if (s_i > 0 and i == f) else 0
            drop_tail = o if (s_i < S - 1 and i == l) else 0
            blocks_s.append(
                BlockInfo(
                    int(rows_[i]) - seg_row0[s_i],
                    int(cols_[i]) + drop_lead - colbase,
                    int(nrows_[i]),
                    int(ncols_[i]) - drop_lead - drop_tail,
                )
            )
        plan_s = StructurePlan(self._seg_rows[s_i], self._seg_ncols[s_i], tuple(blocks_s))
        seg_plans.append(plan_s)
        seg_geoms.append(banded_geometry(plan_s))

    # stacked [S, L] geometry (padded steps inactive)
    loc_geom = {
        k: np.zeros((S, L), dtype=np.int64)
        for k in ("carry_rows", "col_inc", "ncols", "nrows", "cols", "rows")
    }
    active = np.zeros((S, L), dtype=bool)
    emit = np.zeros((S, L), dtype=np.int64)
    max_cols = 1
    for s_i in range(S):
        gs = seg_geoms[s_i]
        nsteps = seg_last[s_i] - seg_first[s_i] + 1
        active[s_i, :nsteps] = True
        emit[s_i, :nsteps] = gs["emit_rows"]
        for k in loc_geom:
            loc_geom[k][s_i, :nsteps] = gs[k]
        max_cols = max(max_cols, int(gs["ncols"].max()))
    self._emit = emit

    # dense-panel descriptors (rows local to the segment's matrix rows,
    # columns global), one per (segment, step); padding steps are empty
    block_list = []
    for s_i in range(S):
        colbase = int(cols_[seg_first[s_i]]) + (o if s_i > 0 else 0)
        blocks_s = list(seg_plans[s_i].blocks)
        for j in range(L):
            if j < len(blocks_s):
                b = blocks_s[j]
                block_list.append((seg_row0[s_i] + b.row, colbase + b.col, b.nrows, b.ncols))
            else:
                block_list.append((0, 0, 0, 0))
    self._block_list = block_list
    self._mRloc = mR

    self._kw = dict(
        max_active=max(int(g_s["active"].max()) for g_s in seg_geoms),
        max_cols=max_cols,
        max_carry=max(max(int(g_s["carry_rows"].max()) for g_s in seg_geoms), 1),
        max_emit=int(emit.max()),
    )
    self._max_cols = max_cols
    self._max_emit = self._kw["max_emit"]
    self._max_seg_rows = max_seg_rows
    self._loc_geom = loc_geom
    self._active = active
    self._starts = _dev(self, loc_geom["cols"])
    self._rows2d = _dev(self, loc_geom["rows"])
    self._carry2d = _dev(self, loc_geom["carry_rows"])
    self._colinc_d = _dev(self, loc_geom["col_inc"])
    self._ncols_d = _dev(self, loc_geom["ncols"])
    self._active_d = _dev(self, active, torch.bool)
    self._emit_d = _dev(self, emit)
    self._seg_col0_d = _dev(self, self._seg_col0)

    # column permutation P_split (interior first): A · P = Q · R
    self._cols_perm = Permutation(np.concatenate([self._icols_idx, self._bcols_idx]))
    self._gather_cols = (
        None if self._cols_perm.is_identity() else _dev(self, self._cols_perm.gather_indices())
    )

    # --- boundary chain: segment s's bottom rows live in boundary columns
    # [(s-1)o, (s+1)o), so stacked in segment order they form a banded chain
    # of S blocks stepping o columns; each [rbot, 2o] slab is first reduced
    # by a batched QR (CAQR) to its [2o, 2o] R factor ------------------------------
    nloc_max = max(self._seg_ncols)
    self._nloc_max = nloc_max
    rbot = [self._seg_rows[si] - self._seg_ncols[si] for si in range(S)]
    if min(rbot) < 2 * o:
        raise ValueError("segment bottom rows too few for the boundary chain; use BandedBlockedQR")
    self._rbot = rbot
    rbot_max = max(rbot)
    self._rbot_max = rbot_max
    cum = np.concatenate([[0], np.cumsum(rbot)])
    self._nbot = int(cum[-1])
    self._nbot2 = S * 2 * o
    chain_blocks = []
    for si in range(S):
        c0b = max(0, si - 1) * o
        ncb = min(2 * o, self._m2 - c0b) if 0 < si < S - 1 else o
        chain_blocks.append(BlockInfo(si * 2 * o, int(c0b), 2 * o, int(ncb)))
    # groups of G consecutive factors per chain step on long chains: fewer
    # sequential steps and one carry overlap refactorized per group
    G = 1
    if S >= 24:
        G = max(1, min(32 // o - 1, S // 8))
    self._chain_group = G
    groups = [chain_blocks[g0 : g0 + G] for g0 in range(0, S, G)]
    gblocks = []
    for blks in groups:
        c0g = min(b.col for b in blks)
        c1g = max(b.col + b.ncols for b in blks)
        gblocks.append(BlockInfo(blks[0].row, c0g, sum(b.nrows for b in blks), c1g - c0g))
    chain_plan = StructurePlan(self._nbot2, self._m2, tuple(gblocks))
    cg = banded_geometry(chain_plan)
    self._chain_geom = cg
    self._chain_kw = dict(
        max_active=int(cg["active"].max()),
        max_cols=int(cg["ncols"].max()),
        max_carry=max(int(cg["carry_rows"].max()), 1),
        max_emit=int(cg["emit_rows"].max()),
    )
    self._chain_geom_dev = {
        k: _dev(self, cg[k])
        for k in ("carry_rows", "col_inc", "cols", "rows", "emit_rows", "ncols")
    }
    # the chain's panels gathered from the flattened CAQR factors [S, 2o, 2o]
    # (sentinel: the appended zero), grouped and shifted down by each
    # step's carry rows
    nbc = len(gblocks)
    mac, mcc = self._chain_kw["max_active"], self._chain_kw["max_cols"]
    sent = S * 4 * o * o
    cmap = np.full((nbc, mac, mcc), sent, dtype=np.int64)
    for g, blks in enumerate(groups):
        c0g = min(b.col for b in blks)
        r0g = blks[0].row
        cr_g = int(cg["carry_rows"][g])
        for b in blks:
            si = b.row // (2 * o)
            rr = np.arange(2 * o)[:, None]
            cc = np.arange(b.ncols)[None, :]
            cmap[g, (b.row - r0g) + cr_g + rr, (b.col - c0g) + cc] = si * 4 * o * o + rr * 2 * o + cc
    self._chain_map = _dev(self, cmap)
    # chain-kernel gate (B5): at least 8 steps, no carry into step 0, one
    # column increment on steps 1..nbc-2, panel + carry within the kernel's
    # shared memory (the reference's TPU bound is mcc <= 32)
    crs, cis = cg["carry_rows"], cg["col_inc"]
    mcac = self._chain_kw["max_carry"]
    ciu = int(cis[1]) if nbc >= 3 else int(cis[0])
    self._chain_kernel = None
    if (
        nbc >= 8
        and crs[0] == 0
        and (cis[1 : nbc - 1] == ciu).all()
        and chain_smem_bytes(mac, mcc, mcac, _itemsize(self)) <= SMEM_LIMIT
    ):
        self._chain_kernel = dict(mca=mcac, me=self._chain_kw["max_emit"], ci=ciu, ci0=int(cis[0]))
        self._chain_act = torch.ones(nbc, dtype=self.dtype, device=self.device)

    # --- maps between padded segment rows and the chain layout ------------------
    seg_ncols_a = np.asarray(self._seg_ncols)
    self._top_valid = _dev(self, np.arange(nloc_max)[None, :] < seg_ncols_a[:, None], torch.bool)
    # each segment's bottom rows are the contiguous run right after its
    # local columns
    self._bot_starts = _dev(self, np.minimum(seg_ncols_a, max_seg_rows))
    self._bot_valid = _dev(self, np.arange(rbot_max)[None, :] < np.asarray(rbot)[:, None], torch.bool)
    # x2 window per segment: x2seg[s, j] = x2[(s-1)o + j] (zero out of range)
    self._x2_idx = _dev(self, np.arange(S)[:, None] * o + np.arange(2 * o)[None, :])
    self._seg_row0_arr = np.asarray(self._seg_row0)

    # the [nbot] bottom vector (segment-major, rbot[s] rows each) as a
    # padded [S, rbot_max] batch; after Qbᵀ the leading 2o rows of each
    # segment feed the chain and the rest pass through behind them
    rg = np.full((S, rbot_max), self._nbot, dtype=np.int64)
    for s in range(S):
        rg[s, : rbot[s]] = int(cum[s]) + np.arange(rbot[s])
    rest_w = max(rbot_max - 2 * o, 1)
    cum_rest = np.concatenate([[0], np.cumsum([r - 2 * o for r in rbot])])
    rp = np.full((S, rest_w), self._nbot, dtype=np.int64)
    for s in range(S):
        n = rbot[s] - 2 * o
        rp[s, :n] = self._nbot2 + int(cum_rest[s]) + np.arange(n)
    self._rbot_gather = _dev(self, rg)
    self._rest_pos = _dev(self, rp)

    # global rows <-> padded segment rows; padded lanes point at row nrows
    # (one past the end), where scatters land in a discarded slot
    R = max_seg_rows
    gather = np.full((S, R), self._nrows, dtype=np.int64)
    for s in range(S):
        gather[s, : self._seg_rows[s]] = self._seg_row0[s] + np.arange(self._seg_rows[s])
    self._seg_gather = _dev(self, gather)
    # output row order: every segment's R rows first, then the bottom rows
    order = np.concatenate(
        [np.arange(self._seg_row0[s], self._seg_row0[s] + self._seg_ncols[s]) for s in range(S)]
        + [
            np.arange(self._seg_row0[s] + self._seg_ncols[s], self._seg_row0[s] + self._seg_rows[s])
            for s in range(S)
        ]
    )
    self._row_order = _dev(self, order)
    self._row_order_inv = _dev(self, np.argsort(order))
    # padded per-segment column slot -> global interior column (m1: discarded)
    cgat = np.full((S, nloc_max + max_cols), self._m1, dtype=np.int64)
    for s in range(S):
        cgat[s, : self._seg_ncols[s]] = self._seg_col0[s] + np.arange(self._seg_ncols[s])
    self._col_gather = _dev(self, cgat)

    # the chain scans' kernels (K1, K2) take both chains' geometries
    isz = _itemsize(self)
    self._scan_fits = all(
        two_segment_fits(g["max_active"], g["max_cols"], isz)
        and solve_chunk_fits(g["max_emit"], g["max_cols"], isz)
        for g in (self._kw, self._chain_kw)
    )
    self._scan_kernel = self._scan_route()  # again at each factorize
    # the boundary chain's chunk plans (one chunk, None, unless it is long;
    # every segment is one chunk)
    ckw = self._chain_kw
    self._chain_plans = scan_plans(
        cg, h1=ckw["max_carry"], A=ckw["max_active"], m=self._nbot2, max_emit=ckw["max_emit"],
        max_cols=ckw["max_cols"], n=self._m2, device=self.device, kernel=self._scan_kernel,
    )
    prepare_kernel_gate(self)
    prepare_p2_gate(self)
    prepare_p2w(self)
    shard_segments(self)


# per-segment device maps (leading axis S) that a rank of a mesh cuts to its
# own segments; the layout-keyed panel and slab maps follow at compute
SEGMENT_MAPS = (
    "_starts", "_rows2d", "_carry2d", "_colinc_d", "_ncols_d", "_active_d", "_emit_d",
    "_seg_col0_d", "_top_valid", "_bot_starts", "_bot_valid", "_x2_idx", "_rbot_gather",
    "_rest_pos", "_seg_gather", "_col_gather",
)


def shard_segments(self):
    """The segment shard of a mesh: when S tiles the mesh axis, this rank
    keeps segments ``[lo, hi)`` of every per-segment map (the whole maps stay
    in ``_global_maps`` for the surfaces that run on gathered factors);
    otherwise nothing is sharded, the reference's rule
    (``segmented_banded.py:373``).

    The segment-chain kernel (B3) cuts segment 0's first carry at ``ci`` and
    every other segment's at ``ci0_rest``, by its index in the launch.  A
    rank whose first segment is not segment 0 therefore launches one idle
    leading segment (``_lead``: a panel map of sentinels, activity 0) ahead
    of its own, so that every segment keeps its index class."""
    self._segs, self._lead, self._global_maps = None, 0, {}
    if self.mesh is None or self.S % mesh_rank(self.mesh, self.axis)[1]:
        return
    lo, hi = self._segs = shard_bounds(self.S, self.mesh, self.axis)
    for name in SEGMENT_MAPS:
        self._global_maps[name] = t = getattr(self, name)
        setattr(self, name, t[lo:hi])
    self._lead = int(lo > 0)
    if self._kernel_gate:
        act = self._kernel_act
        self._global_maps["_kernel_act"] = act
        self._kernel_act = torch.cat([act.new_zeros((self._lead, self.L)), act[lo:hi]])
    if self._p2w is not None:
        ex = self._p2w["excl"]
        self._p2w = dict(self._p2w, excl=ex[(ex >= lo) & (ex < hi)] - lo)


def shard_layout_maps(self, sentinel: int):
    """Cut the layout-keyed maps (panels ``[S, L, ma, mc]``, slabs ``[S, R,
    2o]``) to this rank's segments, the panel map behind ``_lead`` segments
    of ``sentinel`` (the appended zero value; see :func:`shard_segments`)."""
    if self._segs is None:
        return
    lo, hi = self._segs
    for name in ("_panel_gmap", "_slab_gmap"):
        self._global_maps[name] = getattr(self, name)
    gm = self._panel_gmap
    self._panel_gmap = torch.cat([torch.full_like(gm[: self._lead], sentinel), gm[lo:hi]])
    self._slab_gmap = self._slab_gmap[lo:hi]


def _p2_stream_ok(s1t, s2t, spt) -> bool:
    """Whether a phase-2 window sequence (Qᵀ order) admits the reference's
    rolling-window apply (``_p2_stream_plan`` is not None): ``s1``
    nondecreasing, and each step's head ``[s1, s1+sp)`` before its tail
    ``[s2, s2+A-sp)``.  The port reads only this, for the W-apply gate."""
    for l, (s1, s2, sp) in enumerate(zip(s1t, s2t, spt)):
        if (sp and s2 < s1 + sp) or s2 < s1 or (l and s1 < s1t[l - 1]):
            return False
    return True


def prepare_p2_gate(self):
    """The uniform run of the phase-2 windows: segments 1.. that share one
    s1/s2/split sequence on their active prefixes (``_p2_nuni`` of them,
    0 unless at least 2), the shared sequences ``_p2_static`` and the
    per-segment sequences of the other ("generic") segments
    ``_p2_gen_static`` (None when one of them has no rolling-window plan)."""
    S = self.S
    lg, act = self._loc_geom, self._active
    nuni = 0
    if S >= 2:
        s1u = lg["cols"][1]
        s2u = lg["rows"][1]
        spu = lg["carry_rows"][1]
        if bool((s2u >= spu).all()):
            for s in range(1, S):
                n = int(act[s].sum())
                if (
                    (lg["cols"][s][:n] == s1u[:n]).all()
                    and (lg["rows"][s][:n] == s2u[:n]).all()
                    and (lg["carry_rows"][s][:n] == spu[:n]).all()
                ):
                    nuni += 1
                else:
                    break
    self._p2_nuni = nuni if nuni >= 2 else 0
    self._p2_uniform = self._p2_nuni > 0
    self._p2_static = self._p2_gen_static = None
    if not self._p2_uniform:
        return
    self._p2_static = tuple(tuple(int(x) for x in a) for a in (s1u, s2u, spu))
    gen = []
    for s in [0] + list(range(1 + self._p2_nuni, S)):
        n = int(act[s].sum())
        g = tuple(tuple(int(x) for x in lg[k][s][:n]) for k in ("cols", "rows", "carry_rows"))
        if not _p2_stream_ok(*g):
            return
        gen.append(g)
    self._p2_gen_static = tuple(gen)


def prepare_kernel_gate(self):
    """Whether the segment-chain kernel (B3) can run phase 1, and its
    static increments.  Beyond the solver's own uniformity: one body column
    increment, with at most a distinct first-step increment on segments 1..
    (their dropped leading overlap); the final step's increment is never
    read.  The size limit is the kernel's shared memory (the reference's TPU
    bounds mc <= 16, ma*mc <= 512 and its VMEM budget do not apply)."""
    S = self.S
    lg, act = self._loc_geom, self._active
    kw = self._kw
    ma, mc, mca = kw["max_active"], kw["max_cols"], kw["max_carry"]
    ns = act.sum(axis=1)
    ci_a = lg["col_inc"]
    ok = chain_smem_bytes(ma, mc, mca, _itemsize(self)) <= SMEM_LIMIT
    ci_body = int(ci_a[0, 0]) if ns[0] >= 2 else 0
    ci0_rest = int(ci_a[1, 0]) if S > 1 and ns[1] >= 2 else ci_body
    for s in range(S):
        n = int(ns[s])
        if n >= 2:
            first = ci_body if s == 0 else ci0_rest
            ok = ok and int(ci_a[s, 0]) == first
            ok = ok and bool((ci_a[s, 1 : n - 1] == ci_body).all())
    ok = ok and 0 <= ci_body <= mc and 0 <= ci0_rest <= mc
    self._kernel_gate = bool(ok)
    self._kernel_ci = (ci_body, ci0_rest)
    if ok:
        self._kernel_act = _dev(self, act, self.dtype)


def _p2w_sim_segment(s1, s2, sp, nact, a_arr, b_arr, A, mca, h, R, L):
    """Provenance simulation of ONE segment's phase-2 window apply against
    the W-apply kernel's position-indexed model.

    Replays the window algebra of the general apply (head read ``[s1_l,
    s1_l+sp_l)``, tail read ``[s2_l, s2_l+A-sp_l)``, full write-back) while
    tracking which value lives at each work-vector position (a pristine
    operand row, or post-transform window row ``(l, r)``), and in parallel
    the kernel's W state under the shared window starts ``(a_l, b_l)``.
    Every kernel row must read exactly what the true algebra reads: carried
    values must sit in W at the kernel's row, first-touch pristine reads
    must see a still-zero W row, rows at positions ``>= h`` must fall into
    W's never-written pad.  Any divergence returns ``None``.

    Returns ``(rowmap [L, A] int32, src [R] int32)``: ``rowmap[l, r]`` the
    position whose pristine value feeds window row r of step l (sentinel
    R: zero), ``src[p]`` the flat ``l*A + r`` emission that finalizes
    position p (sentinel ``L*A``: pristine)."""
    PAD = R + mca + A + 8  # the apply's work buffer pads R by h1 + A rows
    P = np.full(PAD, -1, np.int64)  # -1 = pristine, else writer l*A + r
    KW = np.full(h, -1, np.int64)  # kernel W provenance; -1 = zero
    rowmap = np.full((L, A), R, np.int32)
    arr = np.arange(A)
    for l in range(nact):
        s1l, s2l, spl = int(s1[l]), int(s2[l]), int(sp[l])
        al, bl = int(a_arr[l]), int(b_arr[l])
        if spl > mca:
            return None
        p = np.where(arr < spl, s1l + arr, s2l + arr - spl)
        if np.unique(p).size != A or p.max() >= PAD or p.min() < 0:
            return None
        i = np.where(arr < mca, min(al, h) + arr, min(bl, h) + arr - mca)
        wpos = np.where(arr < mca, al + arr, bl + arr - mca)
        wi = i[wpos < h]
        if np.unique(wi).size != wi.size:  # write order would matter
            return None
        for r in range(A):
            tag = P[p[r]]
            if tag == -1:  # pristine: the kernel's W row must still be zero
                if i[r] < h and KW[i[r]] != -1:
                    return None
                if p[r] < R:
                    rowmap[l, r] = p[r]
            elif i[r] >= h or KW[i[r]] != tag:  # carried: W must hold it
                return None
        # writes after all reads, in both models
        P[p] = l * A + arr
        below = wpos < h
        KW[i[below]] = l * A + arr[below]
    src = np.full(R, L * A, np.int32)
    fin = P[:R] >= 0
    src[fin] = P[:R][fin].astype(np.int32)
    return rowmap, src


def prepare_p2w(self):
    """Gate and maps of the phase-2 W-apply kernel (B4).

    From the uniform run's shared window sequences: the shared window
    starts ``ab``, the W height ``h`` (the top of the positions touched more
    than once; singly touched positions flow straight through the emission
    stream) and ``wrows``, one provenance simulation of the longest active
    prefix, the first-touch feed map ``[L, A]`` (slab row per window row,
    sentinel R: the zero pad row) and the last-writer map ``[R]`` (flat
    emission per position, sentinel ``L*A``: pristine).  Only the uniform
    run rides the kernel; the generic segments (0 and an irregular tail,
    ``excl``) keep the general apply and overwrite their kernel lanes.
    ``self._p2w`` stays None when any condition fails."""
    self._p2w = None
    if not (self._kernel_gate and self._p2_uniform and self._p2_gen_static is not None):
        return
    s1u, s2u, spu = self._p2_static
    S, L = self.S, self.L
    kw = self._kw
    A, mca, mc = kw["max_active"], kw["max_carry"], kw["max_cols"]
    R = int(self._max_seg_rows)
    ko = 2 * self._overlap
    # mca >= 1 and mca < A: the kernel's window has head and tail rows
    if any(sp > mca for sp in spu) or mca >= A or mca < 1:
        return
    top = max(s2 + A - sp for s2, sp in zip(s2u, spu)) + 1
    cover = np.zeros(top, np.int64)
    for s1, s2, sp in zip(s1u, s2u, spu):
        cover[s1 : s1 + sp] += 1
        cover[s2 : s2 + A - sp] += 1
    multi = np.nonzero(cover >= 2)[0]
    h = int(multi.max()) + 1 if multi.size else 0
    wrows = h + max(A - mca, mca)
    # the reference searched a column group kg that fits TPU VMEM; the CUDA
    # kernel takes all ko columns, each column's W rows in shared memory
    if apply_w_smem_bytes(A, mc, ko, wrows, _itemsize(self)) > SMEM_LIMIT:
        return
    # shared starts: rows [0, mca) at a_l + r, rows [mca, A) at b_l + r - mca
    a_arr = np.asarray([s1 if sp > 0 else s2 for s1, s2, sp in zip(s1u, s2u, spu)], np.int64)
    b_arr = np.asarray([s2 + (mca - sp) for s2, sp in zip(s2u, spu)], np.int64)
    act = self._active
    # every uniform segment matches the shared sequences on its active
    # prefix, and its remaining steps are exact pass-throughs (tau = 0), so
    # one simulation of the longest prefix validates them all
    n1 = max(int(act[s].sum()) for s in range(1, 1 + self._p2_nuni))
    if _p2w_sim_segment(s1u[:n1], s2u[:n1], spu[:n1], n1, a_arr, b_arr, A, mca, h, R, L) is None:
        return
    padr = R + mca + A + 8  # the simulation's work-buffer padding
    last = np.full(padr, -1, np.int64)
    feed = np.full((L, A), R, np.int64)
    arr = np.arange(A)
    for l in range(n1):
        p = np.where(arr < int(spu[l]), int(s1u[l]) + arr, int(s2u[l]) + arr - int(spu[l]))
        fresh = last[p] == -1
        feed[l][fresh] = p[fresh]
        last[p] = l * A + arr
    src = np.full(R, L * A, np.int64)
    fin = last[:R] >= 0
    src[fin] = last[:R][fin]
    ab = np.stack([a_arr, b_arr], axis=1)
    self._p2w = dict(
        feed=_dev(self, feed),
        src=_dev(self, src),
        ab=_dev(self, ab, torch.int32),
        statics=dict(ma=A, mc=mc, mca=mca, ko=ko, h=h, wrows=wrows, padr=padr),
        excl=_dev(self, [0] + list(range(1 + self._p2_nuni, S))),
    )
