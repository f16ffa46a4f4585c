"""The banded family's two chain scans: the two-segment compact-WY apply
(kernel K1, ``ops.compact_wy.two_segment_apply``) and the blocked banded
back-substitution (kernel K2, ``ops.banded.banded_solve_chunk``, the
``_banded_solve_chunk`` of ``solvers.banded_blocked``).

On the CPU each wrapper runs its plain version, held here against the
reference's ``lax.scan`` bodies (``qrkit_tpu.ops.compact_wy._apply_two_seg``
and ``_apply_two_seg_cols``, ``qrkit_tpu.solvers.banded_blocked.
_banded_solve_chunk``, jitted on the CPU) at rtol 1e-12, fp64, over the
edges: split 0 and A, padded inactive steps (Y = T = 0), rows shared by the
two padded segments, inactive back-substitution steps, one and several
columns, several sequences.  The routes are pinned too: a CPU tensor never
reaches the CUDA build, a tensor that reports a card reaches the launcher
with its ordinal, its stream and the launch shape, the solvers decide the
route once from the geometry.

The CUDA cases carry the ``cuda`` marker and skip without a card; on a GPU
machine without JAX they run alone with ``python -m pytest --noconftest -m
cuda tests/test_torch_chain_kernels.py``.  Kernel against plain version at
the main paths' geometries (the plain chain of BASELINE.json config 3's
blocks, the segmented solver's segments and boundary chain, the banded
ellipse stack's 4×1 chain; 1, 5, 16 and 48 columns), fp32 (rtol 1e-4, atol
1e-5·max|·|) and fp64 (rtol 1e-10, atol 1e-12·max|·|: the kernels sum in
another order than the plain versions' products); Q·(Qᵀb) = b; a captured
replay bitwise equal to its eager call; bad operands refused.  The same
for the chunked forms (a chunk plan, ``ops.chain_plan``): on the solvers'
chains and on the edge geometries at 1- and 3-step chunks, two calls and a
replay bitwise equal.
"""
import numpy as np
import pytest
import torch

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import profiling
from qrkit_tpu_torch.ops import _build
from qrkit_tpu_torch.ops import banded as bk
from qrkit_tpu_torch.ops import chain_plan as cp
from qrkit_tpu_torch.ops import compact_wy as cw
from qrkit_tpu_torch.ops.householder import build_t_factor
from qrkit_tpu_torch.solvers import banded_blocked

DEV = "cpu"


# --- operands ----------------------------------------------------------------------

def _orthogonal_steps(rng, lead, A, C, dtype=torch.float64):
    """Y [*lead, A, C] and T [*lead, C, C] of genuine Householder panels, so
    a long chain of steps stays orthogonal."""
    n = int(np.prod(lead))
    Y, taus, _ = bk._panel_qr(torch.as_tensor(rng.normal(size=(n, A, C)), dtype=dtype))
    T = build_t_factor(Y, taus)
    return Y.reshape(*lead, A, C), T.reshape(*lead, C, C)


def two_seg_case(rng, B, n, A, C, h1, m, k, *, split="rand", inactive=(), shared=False):
    """K1's operands as numpy: Y, T, s1, s2, split, M.  ``inactive``: (b, l)
    steps zeroed; ``shared``: every block segment starts inside its step's
    carry segment, so rows are written by both scatters."""
    Y, T = (t.numpy().copy() for t in _orthogonal_steps(rng, (B, n), A, C))
    for b, l in inactive:
        Y[b, l] = 0.0
        T[b, l] = 0.0
    spmax = min(h1, A)
    sp = {"rand": rng.integers(0, spmax + 1, size=(B, n)), "zero": np.zeros((B, n), np.int64),
          "full": np.full((B, n), spmax)}[split]
    s1 = rng.integers(0, m + A + 1, size=(B, n))
    s2 = rng.integers(0, m + h1 + 1, size=(B, n))
    if shared:
        s2 = np.minimum(s1 + np.maximum(sp - 2, 0), m + h1)
    M = rng.normal(size=(B, m, k))
    return Y, T, s1.astype(np.int64), s2.astype(np.int64), sp.astype(np.int64), M


TWO_SEG_CASES = {  # id -> (B, n, A, C, h1, m, k, options)
    "k1_random_split": (1, 9, 12, 4, 3, 40, 1, {}),
    "k1_split_zero": (1, 6, 10, 3, 4, 30, 1, {"split": "zero"}),
    "k1_split_full": (1, 6, 10, 3, 10, 30, 1, {"split": "full"}),
    "k1_shared_rows": (1, 8, 12, 4, 5, 40, 1, {"shared": True}),
    "k3_padded_steps": (1, 7, 9, 3, 3, 25, 3, {"inactive": [(0, 0), (0, 3), (0, 6)]}),
    "k20_two_sequences": (2, 5, 16, 5, 4, 60, 20, {"shared": True}),
    "k2_three_sequences_padded": (3, 4, 8, 2, 2, 20, 2, {"inactive": [(1, 1), (2, 0)]}),
}


def solve_case(rng, B, L, E, me, mc, n, k, *, inactive=0.0):
    """K2's operands as numpy: ypad, r_panels, cols, emit_rows, ncols,
    active (diagonals bounded away from zero)."""
    V = rng.normal(size=(B, L, E, mc))
    for r in range(me):
        V[:, :, r, r] = rng.uniform(2.0, 4.0, size=(B, L)) * rng.choice([-1.0, 1.0], size=(B, L))
    cols = np.sort(rng.integers(0, n + 1, size=(B, L)), axis=1)
    emit = rng.integers(0, me + 1, size=(B, L))
    ncols = rng.integers(0, mc + 1, size=(B, L))
    active = rng.random((B, L)) >= inactive
    ypad = rng.normal(size=(B, n + mc, k))
    return ypad, V, cols, emit, ncols, active


SOLVE_CASES = {  # id -> (B, L, E, me, mc, n, k, inactive share)
    "k1": (1, 9, 4, 4, 6, 40, 1, 0.0),
    "k3_inactive": (1, 8, 5, 5, 5, 30, 3, 0.4),
    "two_chains_k4_extra_rows": (2, 6, 7, 5, 6, 30, 4, 0.2),
    "three_chains_k1": (3, 5, 3, 3, 3, 20, 1, 0.0),
}


def _t(a, dtype=torch.float64, device=DEV):
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, dtype=torch.int64, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _close(got, want, rtol, atol_rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * max(np.abs(want).max(), 1e-300))


# --- against the reference (CPU, fp64) -------------------------------------------

@pytest.mark.parametrize("transpose", [True, False], ids=["qt", "q"])
@pytest.mark.parametrize("case", list(TWO_SEG_CASES))
def test_two_segment_apply_matches_reference(case, transpose):
    """The port's two-segment apply (its plain version on the CPU) against
    the reference's row-major and lane-major scans, sequence by sequence."""
    import jax.numpy as jnp
    from qrkit_tpu.ops.compact_wy import TwoSegmentWYSeq as JSeq
    from qrkit_tpu.ops.compact_wy import _apply_two_seg, _apply_two_seg_cols

    B, n, A, C, h1, m, k, opts = TWO_SEG_CASES[case]
    Y, T, s1, s2, sp, M = two_seg_case(np.random.default_rng(3), B, n, A, C, h1, m, k, **opts)
    before = cw.two_segment_apply.launches
    got = cw.two_segment_apply(*map(_t, (Y, T, s1, s2, sp, M)), h1, transpose)
    assert cw.two_segment_apply.launches == before
    for b in range(B):
        seq = JSeq(*(jnp.asarray(a[b]) for a in (Y, T, s1, s2, sp)), h1=h1, m=m)
        for ref in (_apply_two_seg, _apply_two_seg_cols):
            _close(got[b].numpy(), ref(seq, jnp.asarray(M[b]), transpose, False), 1e-12, 1e-14)
    if opts.get("inactive") == [(0, 0), (0, 3), (0, 6)]:
        # padded steps are exact no-ops: dropping them changes no bit
        keep = [1, 2, 4, 5]
        sub = cw.two_segment_apply(*(_t(a[:, keep]) for a in (Y, T, s1, s2, sp)), _t(M), h1,
                                   transpose)
        assert torch.equal(sub, got)


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_banded_solve_chunk_matches_reference(case):
    """The port's blocked back-substitution (plain on the CPU) against the
    reference's scan, chain by chain and column by column."""
    import jax.numpy as jnp
    from qrkit_tpu.solvers.banded_blocked import _banded_solve_chunk as ref_chunk

    B, L, E, me, mc, n, k, inactive = SOLVE_CASES[case]
    ypad, V, cols, emit, ncols, active = solve_case(
        np.random.default_rng(4), B, L, E, me, mc, n, k, inactive=inactive
    )
    before = bk.banded_solve_chunk.launches
    got = banded_blocked._banded_solve_chunk(
        *map(_t, (ypad, V, cols, emit, ncols, active)), max_emit=me, max_cols=mc
    )
    assert bk.banded_solve_chunk.launches == before
    assert not active.all() or inactive == 0.0
    for b in range(B):
        for j in range(k):
            want = ref_chunk(
                jnp.zeros(n + mc), jnp.asarray(ypad[b, :, j]), jnp.asarray(V[b, :, :me]),
                *(jnp.asarray(a[b]) for a in (cols, emit, ncols, active)),
                max_emit=me, max_cols=mc,
            )
            _close(got[b, :, j].numpy(), want, 1e-12, 1e-14)


# --- routes (CPU) -----------------------------------------------------------------

def _banded(rng, nb, br, bc, ov):
    """Row-sorted banded matrix: nb blocks of br×bc overlapping ov columns,
    uniform(0.5, 5) values (BASELINE.json config 3's layout at nb = 2,499,
    40×8, ov 4)."""
    step = bc - ov
    ncols = step * nb + ov
    i, r, c = np.meshgrid(np.arange(nb), np.arange(br), np.arange(bc), indexing="ij")
    rows, cols = (i * br + r).ravel(), (i * step + c).ravel()
    keep = cols < ncols
    vals = rng.uniform(0.5, 5.0, size=rows.size)
    return qt.SparseCSR.from_triplets(rows[keep], cols[keep], vals[keep], (br * nb, ncols))


def test_cpu_wrappers_run_plain_and_count_nothing(monkeypatch):
    """On CPU tensors both wrappers give their plain versions' bits, never
    reach the CUDA build and count no launch; so do the solvers' paths."""
    def no_build(*args):
        raise AssertionError("a CPU tensor must not reach the CUDA build")

    monkeypatch.setattr(_build, "load_chain", no_build)
    _build.chain_launcher.cache_clear()
    profiling.reset_launch_counts()
    rng = np.random.default_rng(5)
    ops = [_t(a) for a in two_seg_case(rng, 2, 5, 10, 3, 3, 30, 2)]
    assert torch.equal(cw.two_segment_apply(*ops, 3, True),
                       cw._two_segment_apply_plain(*ops, 3, True))
    sops = [_t(a) for a in solve_case(rng, 2, 6, 4, 4, 5, 30, 2)]
    assert torch.equal(bk.banded_solve_chunk(*sops, max_emit=4, max_cols=5),
                       bk._banded_solve_chunk_plain(*sops, max_emit=4, max_cols=5))
    mat = _banded(rng, 64, 10, 4, 2)
    b = torch.as_tensor(rng.normal(size=mat.nrows))
    for qr in (qt.BandedBlockedQR(suggested_block_cols=4, device=DEV),
               qt.SegmentedBandedQR(4, 8, fallback=False, device=DEV)):
        qr.compute(mat)
        assert qr._scan_kernel
        qr.solve(b)
        qr.apply_q(qr.apply_qt(b))
    counts = profiling.launch_counts()
    assert counts["chain_two_seg"] == 0 and counts["chain_solve"] == 0


def test_route_is_decided_from_the_geometry(monkeypatch):
    """``use_kernel=False`` keeps the plain scans; a geometry beyond the
    kernels' shared memory takes them under "auto" and raises under True;
    the launch shapes stay within a CTA's shared memory."""
    mat = _banded(np.random.default_rng(6), 40, 10, 4, 2)
    assert not qt.BandedBlockedQR(suggested_block_cols=4, use_kernel=False,
                                  device=DEV).compute(mat)._scan_kernel
    seg = qt.SegmentedBandedQR(4, 8, fallback=False, use_kernel=False, device=DEV).compute(mat)
    assert not seg._scan_kernel and not seg._chain_seq.kernel
    monkeypatch.setattr(banded_blocked, "two_segment_fits", lambda *a: False)
    auto = qt.BandedBlockedQR(suggested_block_cols=4, device=DEV).compute(mat)
    assert not auto._scan_kernel and not auto.q_seq.kernel
    with pytest.raises(ValueError, match="chain-scan kernels cannot hold"):
        qt.BandedBlockedQR(suggested_block_cols=4, use_kernel=True, device=DEV).analyze_pattern(mat)
    assert banded_blocked.scan_route("auto", True, "") and not banded_blocked.scan_route(False, True, "")
    # every geometry the solvers build fits, fp64 at A = 512, C = 32 in one stage
    assert cw.two_segment_launch(48, 8, 1, 4) == (1, 2)
    assert cw.two_segment_launch(48, 8, 16, 8) == (2, 2)
    assert cw.two_segment_launch(512, 32, 4, 8) == (2, 1)
    assert bk.solve_chunk_launch(32, 32, 48, 8) == (7, 2)
    for A, C, k, isz in ((512, 32, 48, 8), (88, 32, 5, 8), (4, 1, 3, 4)):
        w, s = cw.two_segment_launch(A, C, k, isz)
        assert (s * (A + C) * (C | 1) + w * (6 * A + 2 * C)) * isz <= bk.SMEM_LIMIT
    assert cw.two_segment_launch(4096, 32, 1, 8) is None


class _OnCuda1(torch.Tensor):
    """A CPU tensor that reports cuda:1, so a wrapper takes its kernel path."""

    @property
    def device(self):
        return torch.device("cuda", 1)


@pytest.fixture
def launch_recorder(monkeypatch):
    """The chain library swapped for a recorder of (name, args); the stream
    of cuda:N reads as 1000 + N.  The launch counters are restored after."""
    calls = []

    class Library:
        def __getattr__(self, name):
            def record(*args):
                calls.append((name, args))
                return 0

            record.__name__ = name
            return record

    monkeypatch.setattr(_build, "load_chain", lambda: Library())
    monkeypatch.setattr(_build, "current_stream", lambda device: 1000 + device)
    for fn in profiling._KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    _build.chain_launcher.cache_clear()
    yield calls
    _build.chain_launcher.cache_clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_wrappers_reach_their_launchers(launch_recorder, dtype):
    """An operand on cuda:1 reaches its launcher with ordinal 1, cuda:1's
    stream, the geometry and the launch shape; each wrapper counts one
    launch."""
    sfx = "f32" if dtype == torch.float32 else "f64"
    rng = np.random.default_rng(7)
    Y, T, s1, s2, sp, M = (_t(a, dtype).as_subclass(_OnCuda1)
                           for a in two_seg_case(rng, 2, 5, 48, 8, 8, 60, 16))
    out = cw.two_segment_apply(Y, T, s1, s2, sp, M, 8, False)
    assert out.shape == (2, 60, 16)
    ((name, args),) = launch_recorder
    assert name == f"qrk_chain_two_seg_{sfx}" and args[0] == 1 and args[-1] == 1001
    assert args[7:-1] == (2, 5, 48, 8, 8, 60 + 8 + 48, 16, 0, 2, 2)
    launch_recorder.clear()
    sops = [_t(a, dtype).as_subclass(_OnCuda1) for a in solve_case(rng, 3, 6, 9, 8, 8, 40, 5)]
    x = bk.banded_solve_chunk(*sops, max_emit=8, max_cols=8)
    assert x.shape == (3, 48, 5)
    ((name, args),) = launch_recorder
    assert name == f"qrk_chain_solve_{sfx}" and args[0] == 1 and args[-1] == 1001
    assert args[8:-1] == (3, 6, 9, 8, 8, 48, 5, 5, 2)
    counts = profiling.launch_counts()
    assert counts["chain_two_seg"] == 1 and counts["chain_solve"] == 1


def _bad_operands():
    """(label, wrapper call) that each wrapper refuses on the card before
    any launch."""
    rng = np.random.default_rng(8)
    Y, T, s1, s2, sp, M = (_t(a).as_subclass(_OnCuda1) for a in two_seg_case(rng, 1, 4, 8, 2, 2, 20, 1))
    yp, V, c, e, nc, act = (_t(a).as_subclass(_OnCuda1) for a in solve_case(rng, 1, 5, 3, 3, 4, 20, 1))
    cpu = lambda t: t.as_subclass(torch.Tensor)  # noqa: E731
    return {
        "k1_int32_index": lambda: cw.two_segment_apply(Y, T, s1.int(), s2, sp, M, 2, True),
        "k1_float32_T": lambda: cw.two_segment_apply(Y, T.float(), s1, s2, sp, M, 2, True),
        "k1_T_shape": lambda: cw.two_segment_apply(Y, T[:, :3], s1, s2, sp, M, 2, True),
        "k1_index_on_cpu": lambda: cw.two_segment_apply(Y, T, cpu(s1), s2, sp, M, 2, True),
        "k1_strided_Y": lambda: cw.two_segment_apply(
            Y.transpose(2, 3).contiguous().transpose(2, 3), T, s1, s2, sp, M, 2, True),
        "k1_h1_zero": lambda: cw.two_segment_apply(Y, T, s1, s2, sp, M, 0, True),
        "k2_bool_cols": lambda: bk.banded_solve_chunk(yp, V, c.bool(), e, nc, act,
                                                      max_emit=3, max_cols=4),
        "k2_float_active": lambda: bk.banded_solve_chunk(yp, V, c, e, nc, act.double(),
                                                         max_emit=3, max_cols=4),
        "k2_panel_width": lambda: bk.banded_solve_chunk(yp, V, c, e, nc, act,
                                                        max_emit=3, max_cols=5),
        "k2_emit_past_panel": lambda: bk.banded_solve_chunk(yp, V, c, e, nc, act,
                                                            max_emit=4, max_cols=4),
        "k2_strided_y": lambda: bk.banded_solve_chunk(
            torch.cat([yp, yp], 2)[:, :, ::2], V, c, e, nc, act, max_emit=3, max_cols=4),
    }


BAD_OPERANDS = [
    "k1_int32_index", "k1_float32_T", "k1_T_shape", "k1_index_on_cpu", "k1_strided_Y",
    "k1_h1_zero", "k2_bool_cols", "k2_float_active", "k2_panel_width", "k2_emit_past_panel",
    "k2_strided_y",
]


@pytest.mark.parametrize("case", BAD_OPERANDS)
def test_wrappers_refuse_bad_operands(launch_recorder, case):
    """Wrong dtypes, shapes, devices, layouts and geometries raise before
    any launch."""
    with pytest.raises((ValueError, TypeError)):
        _bad_operands()[case]()
    assert not launch_recorder and not any(profiling.launch_counts().values())


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and have no CPU mode")
    return torch.device("cuda")


def _tol(dtype):
    return (1e-10, 1e-12) if dtype == torch.float64 else (1e-4, 1e-5)


def _assert_kernel_close(got, want, dtype):
    rtol, atol_rel = _tol(dtype)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol_rel * want.abs().max().item())


def _solver_scans(kind, device, dtype, rng):
    """(label, K1 operands (Y, T, s1, s2, split, h1, m), K2 operands (R
    panels, cols, emit_rows, ncols, active, max_emit, max_cols, n)) of the
    chains a solver built on the card."""
    out = []
    if kind == "plain_config3":  # BASELINE.json config 3's blocks, 300 of them
        qr = qt.BandedBlockedQR(suggested_block_cols=8, device=device, dtype=dtype)
        qr.compute(_banded(rng, 300, 40, 8, 4))
        s, g = qr.q_seq, qr._geom_dev
        out.append(("plain_chain", (s.Y[None], s.T[None], s.s1[None], s.s2[None], s.split[None],
                                    s.h1, s.m),
                    (qr._r_panels[None], g["cols"][None], g["emit_rows"][None], g["ncols"][None],
                     torch.ones((1, s.Y.shape[0]), dtype=torch.bool, device=device),
                     qr._max_emit, qr._max_cols, qr.cols)))
    elif kind == "segmented_config3":  # 10 segments of 32 blocks + the boundary chain
        qr = qt.SegmentedBandedQR(8, 32, fallback=False, device=device, dtype=dtype)
        qr.compute(_banded(rng, 320, 40, 8, 4))
        kw = qr._kw
        out.append(("segments", (qr._Yws, qr._Ts, qr._starts, qr._rows2d, qr._carry2d,
                                 kw["max_carry"], qr._max_seg_rows),
                    (qr._r_panels, qr._starts, qr._emit_d, qr._ncols_d, qr._active_d,
                     qr._max_emit, qr._max_cols, qr._nloc_max)))
        c, cg, ckw = qr._chain_seq, qr._chain_geom_dev, qr._chain_kw
        out.append(("boundary_chain", (c.Y[None], c.T[None], c.s1[None], c.s2[None],
                                       c.split[None], c.h1, c.m),
                    (qr._chain_r[None], cg["cols"][None], cg["emit_rows"][None],
                     cg["ncols"][None], torch.ones((1, c.Y.shape[0]), dtype=torch.bool,
                                                   device=device),
                     ckw["max_emit"], ckw["max_cols"], qr._m2)))
    else:  # the banded ellipse stack's left: 2,000 steps of 4×1 panels
        n = 2000
        vals = rng.uniform(0.5, 2.0, size=3 * n)
        left = qt.SparseCSR.from_triplets(np.arange(3 * n), np.repeat(np.arange(n), 3), vals,
                                          (3 * n + 5, n))
        qr = qt.BandedBlockedQR(3, 1, 0, 1, device=device, dtype=dtype).compute(left)
        s, g = qr.q_seq, qr._geom_dev
        assert tuple(s.Y.shape[1:]) == (4, 1)
        out.append(("ellipse_4x1", (s.Y[None], s.T[None], s.s1[None], s.s2[None], s.split[None],
                                    s.h1, s.m),
                    (qr._r_panels[None], g["cols"][None], g["emit_rows"][None], g["ncols"][None],
                     torch.ones((1, s.Y.shape[0]), dtype=torch.bool, device=device),
                     qr._max_emit, qr._max_cols, qr.cols)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["plain_config3", "segmented_config3", "ellipse_4x1"])
def test_cuda_kernels_match_plain_on_solver_chains(cuda_device, kind, dtype):
    """K1 (Qᵀ and Q) and K2 against their plain versions on the chains a
    solver builds, at 1, 5, 16 and 48 operand columns; Q·(Qᵀb) = b."""
    rng = np.random.default_rng(9)
    for label, (Y, T, s1, s2, sp, h1, m), (V, c, e, nc, act, me, mc, n) in _solver_scans(
            kind, cuda_device, dtype, rng):
        B = Y.shape[0]
        for k in (1, 5, 16, 48):
            M = torch.as_tensor(rng.normal(size=(B, m, k)), dtype=dtype, device=cuda_device)
            profiling.reset_launch_counts()
            qtm = cw.two_segment_apply(Y, T, s1, s2, sp, M, h1, True)
            back = cw.two_segment_apply(Y, T, s1, s2, sp, qtm, h1, False)
            ypad = torch.as_tensor(rng.normal(size=(B, n + mc, k)), dtype=dtype, device=cuda_device)
            x = bk.banded_solve_chunk(ypad, V, c, e, nc, act, max_emit=me, max_cols=mc)
            torch.cuda.synchronize()
            counts = profiling.launch_counts()
            assert (counts["chain_two_seg"], counts["chain_solve"]) == (2, 1), (label, k)
            _assert_kernel_close(qtm, cw._two_segment_apply_plain(Y, T, s1, s2, sp, M, h1, True),
                                 dtype)
            _assert_kernel_close(back, cw._two_segment_apply_plain(Y, T, s1, s2, sp, qtm, h1, False),
                                 dtype)
            rtol = 1e-10 if dtype == torch.float64 else 1e-4
            torch.testing.assert_close(back, M, rtol=rtol, atol=rtol * M.abs().max().item())
            _assert_kernel_close(
                x, bk._banded_solve_chunk_plain(ypad, V, c, e, nc, act, max_emit=me, max_cols=mc),
                dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(TWO_SEG_CASES) + ["wide_c40", "a520_c32_k3"])
def test_cuda_two_segment_edges(cuda_device, case, dtype):
    """K1 against its plain version on the CPU tests' edge geometries, past
    32 panel columns (two column chunks) and past 512 panel rows (one stage
    in fp64); padded steps stay exact no-ops."""
    edges = dict(TWO_SEG_CASES, wide_c40=(1, 5, 50, 40, 6, 90, 3, {}),
                 a520_c32_k3=(1, 3, 520, 32, 16, 600, 3, {"shared": True}))
    B, n, A, C, h1, m, k, opts = edges[case]
    ops = [_t(a, dtype, cuda_device)
           for a in two_seg_case(np.random.default_rng(10), B, n, A, C, h1, m, k, **opts)]
    for transpose in (True, False):
        got = cw.two_segment_apply(*ops, h1, transpose)
        _assert_kernel_close(got, cw._two_segment_apply_plain(*ops, h1, transpose), dtype)
    zero = [torch.zeros_like(ops[0]), torch.zeros_like(ops[1]), *ops[2:]]
    assert torch.equal(cw.two_segment_apply(*zero, h1, True), ops[5])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(SOLVE_CASES) + ["wide_me40"])
def test_cuda_banded_solve_edges(cuda_device, case, dtype):
    """K2 against its plain version on the CPU tests' geometries and past 32
    emitted rows."""
    cases = dict(SOLVE_CASES, wide_me40=(2, 6, 40, 40, 44, 120, 3, 0.3))
    B, L, E, me, mc, n, k, inactive = cases[case]
    ops = [_t(a, dtype, cuda_device)
           for a in solve_case(np.random.default_rng(11), B, L, E, me, mc, n, k, inactive=inactive)]
    got = bk.banded_solve_chunk(*ops, max_emit=me, max_cols=mc)
    _assert_kernel_close(got, bk._banded_solve_chunk_plain(*ops, max_emit=me, max_cols=mc), dtype)


@pytest.mark.cuda
def test_cuda_replay_is_bitwise_eager(cuda_device):
    """Both kernels captured in one CUDA graph: a replay gives the eager
    call's bits (no atomics, a fixed order of every sum)."""
    rng = np.random.default_rng(12)
    ops = [_t(a, torch.float32, cuda_device) for a in two_seg_case(rng, 3, 6, 48, 8, 8, 100, 4)]
    sops = [_t(a, torch.float32, cuda_device) for a in solve_case(rng, 2, 7, 8, 8, 8, 60, 3)]
    eager = (cw.two_segment_apply(*ops, 8, True), bk.banded_solve_chunk(*sops, max_emit=8, max_cols=8))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        cw.two_segment_apply(*ops, 8, True)
        bk.banded_solve_chunk(*sops, max_emit=8, max_cols=8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = (cw.two_segment_apply(*ops, 8, True), bk.banded_solve_chunk(*sops, max_emit=8, max_cols=8))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(out, eager))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_operands(cuda_device):
    """On the card: a non-contiguous factor, an index array on another
    device and a wrong index dtype raise; nothing launches."""
    rng = np.random.default_rng(13)
    Y, T, s1, s2, sp, M = (_t(a, torch.float64, cuda_device)
                           for a in two_seg_case(rng, 1, 4, 8, 2, 2, 20, 1))
    profiling.reset_launch_counts()
    for call in (
        lambda: cw.two_segment_apply(Y.transpose(2, 3).contiguous().transpose(2, 3), T, s1, s2,
                                     sp, M, 2, True),
        lambda: cw.two_segment_apply(Y, T, s1.cpu(), s2, sp, M, 2, True),
        lambda: cw.two_segment_apply(Y, T, s1.int(), s2, sp, M, 2, True),
    ):
        with pytest.raises(ValueError):
            call()
    assert not any(profiling.launch_counts().values())


# --- the chunked forms on the card --------------------------------------------------

def _plans(Y, s1, s2, sp, h1, m, V, c, e, nc, act, me, mc, n, chunk):
    """(K1 Qᵀ plan, K1 Q plan, K2 plan) of a chain on its device (``chunk``
    None: the solvers' rule)."""
    dev = Y.device
    host = [t.cpu().numpy() for t in (s1, s2, sp, c, e, nc, act)]
    k1 = dict(h1=h1, A=Y.shape[2], m=m, device=dev, chunk_steps=chunk)
    return (cp.two_segment_plan(*host[:3], transpose=True, **k1),
            cp.two_segment_plan(*host[:3], transpose=False, **k1),
            cp.solve_plan(*host[3:], max_emit=me, max_cols=mc, rows=n + mc, device=dev,
                          chunk_steps=chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind,chunk", [("plain_config3", 8), ("plain_config3", 32),
                                        ("ellipse_4x1", None)])
def test_cuda_chunked_kernels_match_plain_on_solver_chains(cuda_device, kind, chunk, dtype):
    """K1 (Qᵀ and Q) and K2 in their chunked forms against the serial plain
    versions on the chains a solver builds, at 1, 5, 16 and 48 columns;
    each wrapper call counts one launch."""
    rng = np.random.default_rng(14)
    for label, (Y, T, s1, s2, sp, h1, m), (V, c, e, nc, act, me, mc, n) in _solver_scans(
            kind, cuda_device, dtype, rng):
        pqt, pq, ps = _plans(Y, s1, s2, sp, h1, m, V, c, e, nc, act, me, mc, n, chunk)
        assert pqt is not None and pq is not None and ps is not None
        for k in (1, 5, 16, 48):
            M = torch.as_tensor(rng.normal(size=(Y.shape[0], m, k)), dtype=dtype,
                                device=cuda_device)
            ypad = torch.as_tensor(rng.normal(size=(Y.shape[0], n + mc, k)), dtype=dtype,
                                   device=cuda_device)
            profiling.reset_launch_counts()
            qtm = cw.two_segment_apply(Y, T, s1, s2, sp, M, h1, True, plan=pqt)
            qm = cw.two_segment_apply(Y, T, s1, s2, sp, M, h1, False, plan=pq)
            x = bk.banded_solve_chunk(ypad, V, c, e, nc, act, max_emit=me, max_cols=mc, plan=ps)
            torch.cuda.synchronize()
            counts = profiling.launch_counts()
            assert (counts["chain_two_seg"], counts["chain_solve"]) == (2, 1), (label, k)
            _assert_kernel_close(qtm, cw._two_segment_apply_plain(Y, T, s1, s2, sp, M, h1, True),
                                 dtype)
            _assert_kernel_close(qm, cw._two_segment_apply_plain(Y, T, s1, s2, sp, M, h1, False),
                                 dtype)
            _assert_kernel_close(
                x, bk._banded_solve_chunk_plain(ypad, V, c, e, nc, act, max_emit=me, max_cols=mc),
                dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("chunk", [1, 3])
def test_cuda_chunked_edges(cuda_device, chunk, dtype):
    """The chunked forms on the CPU tests' edge geometries (rows written by
    no step or long before, rows both scatters write, padded and inactive
    steps, several sequences) at 1- and 3-step chunks; padded steps stay
    exact no-ops."""
    for case, (B, n, A, C, h1, m, k, opts) in TWO_SEG_CASES.items():
        arrs = two_seg_case(np.random.default_rng(15), B, n, A, C, h1, m, k, **opts)
        ops = [_t(a, dtype, cuda_device) for a in arrs]
        plans = {}
        for transpose in (True, False):
            plans[transpose] = cp.two_segment_plan(*arrs[2:5], h1=h1, A=A, m=m,
                                                   transpose=transpose, device=cuda_device,
                                                   chunk_steps=chunk)
            got = cw.two_segment_apply(*ops, h1, transpose, plan=plans[transpose])
            _assert_kernel_close(got, cw._two_segment_apply_plain(*ops, h1, transpose), dtype)
        zero = [torch.zeros_like(ops[0]), torch.zeros_like(ops[1]), *ops[2:]]
        assert torch.equal(cw.two_segment_apply(*zero, h1, True, plan=plans[True]), ops[5]), case
    for case, (B, L, E, me, mc, n, k, inactive) in SOLVE_CASES.items():
        arrs = solve_case(np.random.default_rng(16), B, L, E, me, mc, n, k, inactive=inactive)
        ops = [_t(a, dtype, cuda_device) for a in arrs]
        plan = cp.solve_plan(*arrs[2:], max_emit=me, max_cols=mc, rows=n + mc,
                             device=cuda_device, chunk_steps=chunk)
        got = bk.banded_solve_chunk(*ops, max_emit=me, max_cols=mc, plan=plan)
        _assert_kernel_close(got, bk._banded_solve_chunk_plain(*ops, max_emit=me, max_cols=mc),
                             dtype)


@pytest.mark.cuda
def test_cuda_chunked_calls_are_deterministic(cuda_device):
    """The chunked forms on config 3's blocks: two calls give the same bits,
    and a captured replay gives the eager call's (no atomics, a fixed order
    of every sum and of the boundary pass)."""
    rng = np.random.default_rng(17)
    ((_, (Y, T, s1, s2, sp, h1, m), (V, c, e, nc, act, me, mc, n)),) = _solver_scans(
        "plain_config3", cuda_device, torch.float32, rng)
    pqt, pq, ps = _plans(Y, s1, s2, sp, h1, m, V, c, e, nc, act, me, mc, n, 8)
    M = torch.as_tensor(rng.normal(size=(1, m, 3)), dtype=torch.float32, device=cuda_device)
    ypad = torch.as_tensor(rng.normal(size=(1, n + mc, 3)), dtype=torch.float32,
                           device=cuda_device)

    def calls():
        return (cw.two_segment_apply(Y, T, s1, s2, sp, M, h1, True, plan=pqt),
                cw.two_segment_apply(Y, T, s1, s2, sp, M, h1, False, plan=pq),
                bk.banded_solve_chunk(ypad, V, c, e, nc, act, max_emit=me, max_cols=mc, plan=ps))

    first, second = calls(), calls()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = calls()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(out, first))
