"""Chunk plans of the banded chain scans (``qrkit_tpu_torch.ops.chain_plan``)
and the torch models of the chunked kernels K1 and K2.

A plan is checked against its definitions by a direct set-based replay of
each step's footprint: every hazard (read-after-write, write-after-read,
write-after-write) between two chunks sits between neighbours of one level
or across levels; each row a level writes has one writer, its serially last
writer there; a chunk's interface is the rows it reads first whose last
writer is its neighbour; a chunk's layout holds every row its steps touch.
Geometries: the kernel tests' cases, random ones (rows written by no step
and by a step long before, rows both scatters write, inactive steps, Y = T
= 0 steps) and BASELINE.json config 3's at 2,499 blocks and the banded
ellipse stack's 4×1 left at N = 2,000 (geometry only).

The models (``_two_segment_apply_chunked_plain``,
``_banded_solve_chunked_plain``) run P1–P3 on a plan; they agree with the
serial plain versions and with the reference's ``lax.scan`` bodies
(``qrkit_tpu.ops.compact_wy._apply_two_seg``,
``qrkit_tpu.solvers.banded_blocked._banded_solve_chunk``) at chunk lengths
1, 2, 3, 7 and n: fp64 rtol 1e-10; fp32 rtol 1e-4 (atol 1e-5·max|·|), as
the kernels' tolerance, since a chunk's interface values reach it through
P2's products rather than the serial order.  The banded solvers on the CPU
give the same results with their plans, and their plans reach the wrappers.
"""
import numpy as np
import pytest
import torch

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import profiling
from qrkit_tpu_torch.ops import banded as bk
from qrkit_tpu_torch.ops import chain_plan as cp
from qrkit_tpu_torch.ops import compact_wy as cw
from qrkit_tpu_torch.solvers import banded_blocked, segmented_solve

from test_torch_chain_kernels import (
    SOLVE_CASES, TWO_SEG_CASES, _banded, _OnCuda1, _t, launch_recorder, solve_case, two_seg_case,
)

assert launch_recorder  # a fixture, used by name

CHUNKS = (1, 2, 3, 7, None)  # None: the whole chain (n steps)


# --- the definitions, replayed with sets -------------------------------------------

def k1_footprints(s1, s2, sp, A, h1, transpose):
    """[(reads, writes, touched)] of one sequence's K1 steps in serial order."""
    n = len(s1)
    order = range(n) if transpose else range(n - 1, -1, -1)
    out = []
    for l in order:
        p = int(min(max(sp[l], 0), min(h1, A)))
        rows = {int(s1[l]) + j for j in range(p)} | {int(s2[l]) + j for j in range(A - p)}
        out.append((rows, rows, rows | {int(s2[l]) + j for j in range(A)}))
    return out


def k2_footprints(cols, er, nc, act, me, mc):
    """[(reads, writes, touched)] of one chain's K2 steps in serial order."""
    out = []
    for l in range(len(cols) - 1, -1, -1):
        c0, e, w = int(cols[l]), int(er[l]), int(nc[l])
        lo, hi, live = max(e, 0), min(max(w, 0), mc), min(max(e, 0), me)
        reads = set(range(c0 + lo, c0 + hi))
        writes = set(range(c0, c0 + live)) if act[l] else set()
        out.append((reads, writes, set(range(c0, c0 + max(hi, live)))))
    return out


def first_reads(fps):
    """Rows a run of steps reads before writing them."""
    seen, first = set(), set()
    for reads, writes, _ in fps:
        first |= reads - seen
        seen |= reads | writes
    return first


def check_plan(plan, footprints, local_of):
    """``footprints[b]``: sequence b's steps in serial order;
    ``local_of(b, pos)``: the operand rows a step's local indices name,
    given the chunk's layout (a list of (local index, operand row) pairs to
    check)."""
    ch, rows = plan.chunks, plan.rows
    level_of = np.zeros(ch.shape[0], dtype=np.int64)
    for lv, level in enumerate(plan.levels):
        level_of[level.begin:level.end] = lv
        assert level.iface == bool(ch[level.begin:level.end, cp.WIN].any())
    for b, fps in enumerate(footprints):
        mine = sorted(np.nonzero(ch[:, cp.SEQ] == b)[0], key=lambda c: ch[c, cp.START])
        assert [int(ch[c, cp.START]) for c in mine] == list(
            np.cumsum([0] + [int(ch[c, cp.LEN]) for c in mine])[:-1])
        assert sum(int(ch[c, cp.LEN]) for c in mine) == len(fps)
        assert list(level_of[mine]) == sorted(level_of[mine])
        steps = {c: fps[ch[c, cp.START]: ch[c, cp.START] + ch[c, cp.LEN]] for c in mine}
        R = {c: set().union(*(f[0] for f in steps[c])) for c in mine}
        W = {c: set().union(*(f[1] for f in steps[c])) for c in mine}
        layout = {c: rows[ch[c, cp.ROW0]: ch[c, cp.ROW0] + ch[c, cp.NROWS]] for c in mine}
        for i, x in enumerate(mine):
            touched = set().union(*(f[2] for f in steps[x]))
            assert touched <= set(layout[x][:, cp.ROW].tolist())
            assert list(layout[x][:, cp.ROW]) == sorted(set(layout[x][:, cp.ROW]))
            for row, name in local_of(b, x, layout[x]):
                assert row == name
            for j, y in enumerate(mine[i + 1:], start=i + 1):
                hazard = (W[x] & R[y]) | (R[x] & W[y]) | (W[x] & W[y])
                if hazard:
                    assert level_of[y] > level_of[x] or (
                        level_of[y] == level_of[x] and j == i + 1), (x, y, sorted(hazard)[:5])
            # the interface: first reads whose last writer is the neighbour
            prev = mine[i - 1] if i and level_of[mine[i - 1]] == level_of[x] else None
            want = set()
            if prev is not None:
                later = set().union(*(W[c] for c in mine[mine.index(prev) + 1: i]))
                want = (first_reads(steps[x]) & W[prev]) - later
            lay = layout[x]
            got = {int(r): int(q) for r, q in zip(lay[:, cp.ROW], lay[:, cp.IFACE]) if q >= 0}
            assert set(got) == want and ch[x, cp.WIN] == len(want)
            assert sorted(got.values()) == list(range(len(want)))
            if prev is not None:
                assert ch[prev, cp.WOUT] == len(want)
                out_rows = layout[prev][plan.iface_out[prev, : len(want)], cp.ROW]
                assert {int(r): q for q, r in enumerate(out_rows)} == got
        # one writer per row and level: its serially last writer there
        for lv in set(level_of[mine]):
            cs = [c for c in mine if level_of[c] == lv]
            for c in cs:
                flagged = set(layout[c][layout[c][:, cp.WRITER] == 1, cp.ROW].tolist())
                later = set().union(*(W[d] for d in cs[cs.index(c) + 1:]))
                assert flagged == W[c] - later
    return level_of


def k1_plan_checked(s1, s2, sp, A, h1, m, transpose, chunk):
    s1, s2, sp = (np.atleast_2d(np.asarray(a, dtype=np.int64)) for a in (s1, s2, sp))
    plan = cp.two_segment_plan(s1, s2, sp, h1=h1, A=A, m=m, transpose=transpose, device="cpu",
                               chunk_steps=chunk)
    n = s1.shape[1]

    def local_of(b, c, layout):
        st = int(plan.chunks[c, cp.START])
        order = range(st, st + int(plan.chunks[c, cp.LEN]))
        for i in order:
            l = i if transpose else n - 1 - i
            if A - min(max(sp[b, l], 0), min(h1, A)) > 0:
                yield layout[plan.steps[1, b, l], cp.ROW], s2[b, l]
            if sp[b, l] > 0:
                yield layout[plan.steps[0, b, l], cp.ROW], s1[b, l]

    check_plan(plan, [k1_footprints(s1[b], s2[b], sp[b], A, h1, transpose)
                      for b in range(s1.shape[0])], local_of)
    return plan


def k2_plan_checked(cols, er, nc, act, me, mc, rows, chunk):
    cols, er, nc = (np.atleast_2d(np.asarray(a, dtype=np.int64)) for a in (cols, er, nc))
    act = np.asarray(act, dtype=bool).reshape(cols.shape)
    plan = cp.solve_plan(cols, er, nc, act, max_emit=me, max_cols=mc, rows=rows, device="cpu",
                         chunk_steps=chunk)
    L = cols.shape[1]

    def local_of(b, c, layout):
        st = int(plan.chunks[c, cp.START])
        for i in range(st, st + int(plan.chunks[c, cp.LEN])):
            l = L - 1 - i
            if max(min(max(nc[b, l], 0), mc), min(max(er[b, l], 0), me)) > 0:
                yield layout[plan.steps[b, l], cp.ROW], cols[b, l]

    check_plan(plan, [k2_footprints(cols[b], er[b], nc[b], act[b], me, mc)
                      for b in range(cols.shape[0])], local_of)
    return plan


# --- plans obey their definitions ---------------------------------------------------

@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda c: f"chunk{c or 'n'}")
@pytest.mark.parametrize("transpose", [True, False], ids=["qt", "q"])
@pytest.mark.parametrize("case", list(TWO_SEG_CASES))
def test_two_segment_plan_definitions(case, transpose, chunk):
    B, n, A, C, h1, m, k, opts = TWO_SEG_CASES[case]
    _, _, s1, s2, sp, _ = two_seg_case(np.random.default_rng(3), B, n, A, C, h1, m, k, **opts)
    k1_plan_checked(s1, s2, sp, A, h1, m, transpose, chunk or n)


@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda c: f"chunk{c or 'n'}")
@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_plan_definitions(case, chunk):
    B, L, E, me, mc, n, k, inactive = SOLVE_CASES[case]
    _, _, cols, er, nc, act = solve_case(np.random.default_rng(4), B, L, E, me, mc, n, k,
                                         inactive=inactive)
    k2_plan_checked(cols, er, nc, act, me, mc, n + mc, chunk or L)


def random_banded_geometry(rng, n, A, h1, m):
    """A banded-like two-segment geometry: the carry segments walk forward
    slowly, the block segments fast, so carry rows were written by a step
    long before; some block segments start inside their carry segment (rows
    both scatters write) and some rows are touched by no step."""
    s1 = np.cumsum(rng.integers(0, 3, size=n))
    s2 = np.cumsum(rng.integers(A // 2, A + 3, size=n))
    sp = rng.integers(0, min(h1, A) + 1, size=n)
    shared = rng.random(n) < 0.2
    s2 = np.where(shared, s1 + np.maximum(sp - 2, 0), s2)
    top = m + h1
    return np.minimum(s1, top), np.minimum(s2, top), sp


@pytest.mark.parametrize("seed", range(6))
def test_random_geometry_plans(seed):
    """Random banded-like K1 geometries (both directions, several chunk
    lengths, two sequences) and K2 geometries with inactive steps."""
    rng = np.random.default_rng(100 + seed)
    n, A, h1 = int(rng.integers(20, 60)), int(rng.integers(3, 12)), int(rng.integers(1, 6))
    m = int(n * (A + 2))
    geo = [random_banded_geometry(rng, n, A, h1, m) for _ in range(2)]
    s1, s2, sp = (np.stack([g[i] for g in geo]) for i in range(3))
    for transpose in (True, False):
        for chunk in (2, 5, 9):
            k1_plan_checked(s1, s2, sp, A, h1, m, transpose, chunk)
    L, me, mc = n, int(rng.integers(1, 6)), 8
    cols = np.sort(np.cumsum(rng.integers(0, 4, size=(2, L)), axis=1), axis=1)
    er = rng.integers(0, me + 1, size=(2, L))
    nc = rng.integers(0, mc + 1, size=(2, L))
    act = rng.random((2, L)) > 0.3
    for chunk in (2, 5, 9):
        k2_plan_checked(cols, er, nc, act, me, mc, int(cols.max()) + mc + 1, chunk)


def _config3_geometry():
    mat = _banded(np.random.default_rng(0), 2499, 40, 8, 4)
    qr = qt.BandedBlockedQR(suggested_block_cols=8, device="cpu", dtype=torch.float32)
    qr.analyze_pattern(mat)
    return qr


@pytest.mark.parametrize("chunk", [16, 32])
def test_config3_plans(chunk):
    """BASELINE.json config 3's plain chain (2,499 steps of 48×8 panels,
    geometry only): at 16- and 32-step chunks K1 falls into at most 4
    levels each way with interfaces of at most 4 rows, K2 into one level of
    width 4; the solver builds its plans at analysis with CHUNK_STEPS."""
    qr = _config3_geometry()
    g = qr.geom
    h1, A, m = qr._max_carry, qr._max_active, qr.rows
    plans = qr._chain_plans
    for transpose, name in ((True, "qt"), (False, "q")):
        plan = k1_plan_checked(g["cols"], g["rows"], g["carry_rows"], A, h1, m, transpose, chunk)
        assert plan.n_levels <= 4 and plan.chunks[:, cp.WIN].max() <= 4
        assert plan.n_chunks >= 2499 // chunk - 2
        if chunk == cp.CHUNK_STEPS["two_seg"]:
            assert np.array_equal(plans[name].chunks, plan.chunks)
    plan = k2_plan_checked(g["cols"], g["emit_rows"], g["ncols"], np.ones(2499, bool),
                           qr._max_emit, qr._max_cols, qr.cols + qr._max_cols, chunk)
    assert plan.n_levels == 1 and plan.chunks[:, cp.WIN].max() <= 4
    if chunk == cp.CHUNK_STEPS["solve"]:
        assert np.array_equal(plans["solve"].chunks, plan.chunks)


@pytest.mark.parametrize("chunk", [16, 32])
def test_ellipse_left_plans(chunk):
    """The banded ellipse stack's 3×1-block left at N = 2,000 (2,000 steps
    of 4×1 panels): at most 5 levels each way, K2 one level, and no
    interface."""
    n = 2000
    left = qt.SparseCSR.from_triplets(np.arange(3 * n), np.repeat(np.arange(n), 3),
                                      np.ones(3 * n), (3 * n + 5, n))
    qr = qt.BandedBlockedQR(3, 1, 0, 1, device="cpu").analyze_pattern(left)
    g = qr.geom
    for transpose in (True, False):
        plan = k1_plan_checked(g["cols"], g["rows"], g["carry_rows"], qr._max_active,
                               qr._max_carry, qr.rows, transpose, chunk)
        assert plan.n_levels <= 5 and not plan.chunks[:, cp.WIN].any()
        assert not any(lv.iface for lv in plan.levels)
    plan = k2_plan_checked(g["cols"], g["emit_rows"], g["ncols"], np.ones(n, bool),
                           qr._max_emit, qr._max_cols, qr.cols + qr._max_cols, chunk)
    assert plan.n_levels == 1 and not plan.chunks[:, cp.WIN].any()


def test_short_chains_keep_one_chunk():
    """Fewer than MIN_CHUNKS chunks' worth of steps: no plan (one launch),
    as for the segmented solver's 32-step segments and its boundary chain."""
    for kind, build in (("two_seg", lambda s1, n: cp.two_segment_plan(
            s1, s1 * 10, np.full(n, 8), h1=8, A=48, m=40 * n, transpose=True, device="cpu")),
            ("solve", lambda s1, n: cp.solve_plan(
                s1, np.full(n, 4), np.full(n, 8), np.ones(n, bool), max_emit=4, max_cols=8,
                rows=4 * n + 8, device="cpu"))):
        n = cp.MIN_CHUNKS * cp.CHUNK_STEPS[kind]
        assert build(np.arange(n - 1) * 4, n - 1) is None
        assert build(np.arange(n) * 4, n) is not None
    seg = qt.SegmentedBandedQR(8, 32, fallback=False, device="cpu").analyze_pattern(
        _banded(np.random.default_rng(1), 320, 40, 8, 4))
    assert all(p is None for p in seg._chain_plans.values())


# --- the chunked models against the serial plain versions and the reference -----------

@pytest.mark.parametrize("transpose", [True, False], ids=["qt", "q"])
@pytest.mark.parametrize("case", list(TWO_SEG_CASES))
def test_two_segment_chunked_model(case, transpose):
    import jax.numpy as jnp
    from qrkit_tpu.ops.compact_wy import TwoSegmentWYSeq as JSeq
    from qrkit_tpu.ops.compact_wy import _apply_two_seg

    B, n, A, C, h1, m, k, opts = TWO_SEG_CASES[case]
    arrs = two_seg_case(np.random.default_rng(3), B, n, A, C, h1, m, k, **opts)
    ref = np.stack([np.asarray(_apply_two_seg(
        JSeq(*(jnp.asarray(a[b]) for a in arrs[:5]), h1=h1, m=m), jnp.asarray(arrs[5][b]),
        transpose, False)) for b in range(B)])
    for dtype, rtol, atol in ((torch.float64, 1e-10, 1e-12), (torch.float32, 1e-4, 1e-5)):
        ops = [_t(a, dtype) for a in arrs]
        serial = cw._two_segment_apply_plain(*ops, h1, transpose)
        for chunk in CHUNKS:
            plan = cp.two_segment_plan(arrs[2], arrs[3], arrs[4], h1=h1, A=A, m=m,
                                       transpose=transpose, device="cpu", chunk_steps=chunk or n)
            got = cw._two_segment_apply_chunked_plain(*ops, h1, transpose, plan)
            scale = ref.__abs__().max()
            np.testing.assert_allclose(got.double().numpy(), serial.double().numpy(), rtol=rtol,
                                       atol=atol * scale)
            np.testing.assert_allclose(got.double().numpy(), ref, rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_chunked_model(case):
    import jax.numpy as jnp
    from qrkit_tpu.solvers.banded_blocked import _banded_solve_chunk as ref_chunk

    B, L, E, me, mc, n, k, inactive = SOLVE_CASES[case]
    arrs = solve_case(np.random.default_rng(4), B, L, E, me, mc, n, k, inactive=inactive)
    ypad, V, cols, er, nc, act = arrs
    ref = np.stack([np.stack([np.asarray(ref_chunk(
        jnp.zeros(n + mc), jnp.asarray(ypad[b, :, j]), jnp.asarray(V[b, :, :me]),
        *(jnp.asarray(a[b]) for a in (cols, er, nc, act)), max_emit=me, max_cols=mc))
        for j in range(k)], axis=1) for b in range(B)])
    for dtype, rtol, atol in ((torch.float64, 1e-10, 1e-12), (torch.float32, 1e-4, 1e-5)):
        ops = [_t(a, dtype) for a in arrs]
        serial = bk._banded_solve_chunk_plain(*ops, max_emit=me, max_cols=mc)
        for chunk in CHUNKS:
            plan = cp.solve_plan(cols, er, nc, act, max_emit=me, max_cols=mc, rows=n + mc,
                                 device="cpu", chunk_steps=chunk or L)
            got = bk._banded_solve_chunked_plain(*ops, max_emit=me, max_cols=mc, plan=plan)
            scale = np.abs(ref).max()
            np.testing.assert_allclose(got.double().numpy(), serial.double().numpy(), rtol=rtol,
                                       atol=atol * scale)
            np.testing.assert_allclose(got.double().numpy(), ref, rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("chunk", (3, 8, 32))
def test_chunked_models_on_solver_chains(chunk):
    """The models on a solver's own factors (config 3's blocks, 300 of
    them, fp64) at several chunk lengths, 1 and 3 columns."""
    rng = np.random.default_rng(chunk)
    qr = qt.BandedBlockedQR(suggested_block_cols=8, device="cpu").compute(
        _banded(rng, 300, 40, 8, 4))
    s, g, gd = qr.q_seq, qr.geom, qr._geom_dev
    k1 = (s.Y[None], s.T[None], s.s1[None], s.s2[None], s.split[None])
    for k in (1, 3):
        M = torch.as_tensor(rng.normal(size=(1, s.m, k)))
        for transpose in (True, False):
            plan = cp.two_segment_plan(g["cols"], g["rows"], g["carry_rows"], h1=s.h1,
                                       A=s.Y.shape[1], m=s.m, transpose=transpose, device="cpu",
                                       chunk_steps=chunk)
            want = cw._two_segment_apply_plain(*k1, M, s.h1, transpose)
            got = cw._two_segment_apply_chunked_plain(*k1, M, s.h1, transpose, plan)
            torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12 * want.abs().max().item())
        nb = s.Y.shape[0]
        plan = cp.solve_plan(g["cols"], g["emit_rows"], g["ncols"], np.ones(nb, bool),
                             max_emit=qr._max_emit, max_cols=qr._max_cols,
                             rows=qr.cols + qr._max_cols, device="cpu", chunk_steps=chunk)
        ypad = torch.as_tensor(rng.normal(size=(1, qr.cols + qr._max_cols, k)))
        args = (ypad, qr._r_panels[None], gd["cols"][None], gd["emit_rows"][None],
                gd["ncols"][None], torch.ones((1, nb), dtype=torch.bool))
        want = bk._banded_solve_chunk_plain(*args, max_emit=qr._max_emit, max_cols=qr._max_cols)
        got = bk._banded_solve_chunked_plain(*args, max_emit=qr._max_emit,
                                             max_cols=qr._max_cols, plan=plan)
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12 * want.abs().max().item())


# --- the solvers carry their plans --------------------------------------------------

@pytest.fixture
def chunked_backend(monkeypatch):
    """K1's and K2's wrappers, where the solvers look them up, replaced by
    their chunked models whenever a plan is passed; records the plans."""
    seen = []

    def two_seg(Y, T, s1, s2, split, M, h1, transpose, plan=None):
        seen.append(("two_seg", transpose, plan))
        if plan is None:
            return cw._two_segment_apply_plain(Y, T, s1, s2, split, M, h1, transpose)
        return cw._two_segment_apply_chunked_plain(Y, T, s1, s2, split, M, h1, transpose, plan)

    def solve(*args, max_emit, max_cols, plan=None):
        seen.append(("solve", None, plan))
        if plan is None:
            return bk._banded_solve_chunk_plain(*args, max_emit=max_emit, max_cols=max_cols)
        return bk._banded_solve_chunked_plain(*args, max_emit=max_emit, max_cols=max_cols,
                                              plan=plan)

    monkeypatch.setattr(cw, "two_segment_apply", two_seg)
    monkeypatch.setattr(banded_blocked, "_banded_solve_chunk", solve)
    monkeypatch.setattr(segmented_solve, "_banded_solve_chunk", solve)
    return seen


def test_banded_solver_results_with_plans(chunked_backend):
    """``BandedBlockedQR`` on 300 of config 3's blocks builds its plans at
    analysis and hands each call its own (Qᵀ, Q, solve); the chunked models
    on them give the serial results."""
    rng = np.random.default_rng(21)
    mat = _banded(rng, 300, 40, 8, 4)
    qr = qt.BandedBlockedQR(suggested_block_cols=8, device="cpu").compute(mat)
    plans = qr._chain_plans
    assert all(plans[k] is not None for k in ("qt", "q", "solve"))
    b = torch.as_tensor(rng.normal(size=(mat.nrows, 2)))
    with qt._program.eager():
        got = (qr.apply_qt(b), qr.apply_q(b), qr.solve(b))
    kinds = [(kind, tr, plan) for kind, tr, plan in chunked_backend]
    assert ("two_seg", True, plans["qt"]) in kinds and ("two_seg", False, plans["q"]) in kinds
    assert ("solve", None, plans["solve"]) in kinds
    ref = qt.BandedBlockedQR(suggested_block_cols=8, use_kernel=False, device="cpu").compute(mat)
    assert all(p is None for p in ref._chain_plans.values())
    with qt._program.eager():
        want = (ref.apply_qt(b), ref.apply_q(b), ref.solve(b))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12 * w.abs().max().item())


def test_segmented_boundary_chain_plans(chunked_backend, monkeypatch):
    """The segmented solver builds its boundary chain's plans (forced here
    with 2-step chunks: config 3's is one chunk) and its solve gives the
    serial result through them; its segments stay one chunk each."""
    monkeypatch.setattr(cp, "CHUNK_STEPS", {"two_seg": 2, "solve": 2})
    monkeypatch.setattr(cp, "MIN_CHUNKS", 1)
    rng = np.random.default_rng(22)
    mat = _banded(rng, 320, 40, 8, 4)
    seg = qt.SegmentedBandedQR(8, 32, fallback=False, device="cpu").compute(mat)
    plans = seg._chain_plans
    assert plans["qt"] is not None and plans["solve"] is not None
    b = torch.as_tensor(rng.normal(size=mat.nrows))
    with qt._program.eager():
        got = seg.solve(b)
    assert ("two_seg", True, plans["qt"]) in chunked_backend
    assert ("solve", None, plans["solve"]) in chunked_backend
    monkeypatch.setattr(cp, "MIN_CHUNKS", 1000)
    ref = qt.SegmentedBandedQR(8, 32, fallback=False, device="cpu").compute(mat)
    assert all(p is None for p in ref._chain_plans.values())
    with qt._program.eager():
        want = ref.solve(b)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12 * want.abs().max().item())


def test_cpu_solvers_ignore_plans():
    """On the CPU the wrappers run the serial plain versions whatever the
    plan: a solver with plans gives its results bit for bit, and counts no
    launch."""
    rng = np.random.default_rng(23)
    mat = _banded(rng, 300, 40, 8, 4)
    qr = qt.BandedBlockedQR(suggested_block_cols=8, device="cpu").compute(mat)
    b = torch.as_tensor(rng.normal(size=mat.nrows))
    profiling.reset_launch_counts()
    x = qr.solve(b)
    s, gd = qr.q_seq, qr._geom_dev
    qtb = cw._two_segment_apply_plain(s.Y[None], s.T[None], s.s1[None], s.s2[None],
                                      s.split[None], b[:, None][None], s.h1, True)[0, :, 0]
    z = banded_blocked.banded_solve_r(qr._r_panels, gd["cols"], gd["emit_rows"], gd["ncols"],
                                      qtb[: qr.cols], max_emit=qr._max_emit,
                                      max_cols=qr._max_cols, n=qr.cols, kernel=False)
    assert torch.equal(x, qr._unpermute(z))
    assert not any(profiling.launch_counts().values())


# --- the wrappers' chunked route (CPU, the library recorded) ---------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_chunked_wrappers_reach_their_launchers(launch_recorder, dtype):
    """With a plan, an operand on cuda:1 reaches each level's phases in
    order (P1 and P2 where a boundary carries rows; P3's gathers alone where
    a level could race) with ordinal 1 and cuda:1's stream, and each
    wrapper counts one launch however many phases it ran."""
    sfx = "f32" if dtype == torch.float32 else "f64"
    rng = np.random.default_rng(24)
    qr = _config3_geometry()
    g = qr.geom
    nb, A, C, h1, m = 2499, qr._max_active, qr._max_cols, qr._max_carry, qr.rows
    plan = cp.two_segment_plan(g["cols"], g["rows"], g["carry_rows"], h1=h1, A=A, m=m,
                               transpose=True, device="cpu")
    plan.tensors = {k: v.as_subclass(_OnCuda1) for k, v in plan.tensors.items()}
    Y, T = (torch.zeros((1, nb) + s, dtype=dtype).as_subclass(_OnCuda1) for s in ((A, C), (C, C)))
    idx = [torch.as_tensor(np.ascontiguousarray(g[k][None])).as_subclass(_OnCuda1)
           for k in ("cols", "rows", "carry_rows")]
    M = torch.as_tensor(rng.normal(size=(1, m, 2)), dtype=dtype).as_subclass(_OnCuda1)
    cw.two_segment_apply(Y, T, *idx, M, h1, True, plan=plan)
    want = []
    for lv in plan.levels:
        if lv.iface:
            want += [("two_seg_chunk", cp.FIRST_PASS), ("join", None)]
        want += ([("two_seg_chunk", cp.GATHER), ("two_seg_chunk", cp.FINISH)] if lv.split
                 else [("two_seg_chunk", cp.FINISH_ALL)])
    got = [(name[len("qrk_chain_"): -len(sfx) - 1], None if "join" in name else args[-2])
           for name, args in launch_recorder]
    assert got == want
    assert all(args[0] == 1 and args[-1] == 1001 for _, args in launch_recorder)
    assert profiling.launch_counts()["chain_two_seg"] == 1
    for bad in (qr._chain_plans["solve"], plan):  # K2's plan; Qᵀ's plan for Q
        with pytest.raises(ValueError, match="ChainPlan"):
            cw.two_segment_apply(Y, T, *idx, M, h1, bad is not plan, plan=bad)
    launch_recorder.clear()
    splan = cp.solve_plan(g["cols"], g["emit_rows"], g["ncols"], np.ones(nb, bool),
                          max_emit=qr._max_emit, max_cols=C, rows=qr.cols + C, device="cpu")
    splan.tensors = {k: v.as_subclass(_OnCuda1) for k, v in splan.tensors.items()}
    sops = [torch.as_tensor(np.ascontiguousarray(a)).as_subclass(_OnCuda1) for a in (
        rng.normal(size=(1, qr.cols + C, 3)).astype(np.float32 if dtype == torch.float32
                                                     else np.float64),
        np.ones((1, nb, qr._max_emit, C), dtype=np.float32 if dtype == torch.float32
                else np.float64),
        g["cols"][None], g["emit_rows"][None], g["ncols"][None], np.ones((1, nb), bool))]
    bk.banded_solve_chunk(*sops, max_emit=qr._max_emit, max_cols=C, plan=splan)
    got = [name[len("qrk_chain_"): -len(sfx) - 1] for name, _ in launch_recorder]
    assert got == ["solve_chunk", "join", "solve_chunk"]  # one level: P1, P2, P3 whole
    assert profiling.launch_counts()["chain_solve"] == 1
