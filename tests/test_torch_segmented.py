"""The port's SegmentedBandedQR against qrkit_tpu's (XLA path,
``use_pallas=False``), on the same inputs, fp64.

Two shapes where the port's kernel gates fire (the segment chains B3, the
W-apply B4; the boundary-chain kernel B5 on the first): the tall-block
miniature (64 blocks of 10×4 overlapping 2, 8 per segment) and config 3's
block shape at 160 blocks (40×8 overlapping 4, 32 per segment).  On the CPU
the kernel mode runs the kernels' plain versions.  Oracles:
tests/test_segmented_banded.py, tests/test_pallas_banded.py and
tests/test_factorize_values.py.  The reference solvers are built once per
module (each instance compiles its own programs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrkit_tpu.solvers import SegmentedBandedQR as JSegmented

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import convert

from generators import overlapping_block_diagonal_matrix, tall_banded_matrix

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA

TOL = dict(rtol=1e-10, atol=1e-11)
SHAPES = {  # name -> (nb, br, bc, ov, segment_blocks, suggested_block_cols)
    "tall_64x10x4": (64, 10, 4, 2, 8, 4),
    "config3_block_160": (160, 40, 8, 4, 32, 8),
}


def _port(m):
    return qt.SparseCSR(m.shape, m.indptr, m.indices, m.data)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _solver(name, **kw):
    _, _, _, _, L, sug = SHAPES[name]
    return qt.SegmentedBandedQR(suggested_block_cols=sug, segment_blocks=L, **kw, device=DEV)


@pytest.fixture(scope="module")
def references():
    """Shape name -> (matrix, reference solver), each built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            nb, br, bc, ov, L, sug = SHAPES[name]
            m = tall_banded_matrix(nb, np.random.default_rng(21), br=br, bc=bc, ov=ov)
            jq = JSegmented(suggested_block_cols=sug, segment_blocks=L, use_pallas=False)
            cache[name] = (m, jq.compute(m))
        return cache[name]

    return get


@pytest.fixture(params=list(SHAPES))
def case(request, references):
    """(shape name, matrix, reference solver)."""
    return (request.param, *references(request.param))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["general", "kernel_plain"])
def test_segmented_factors_match(case, use_kernel):
    name, m, jq = case
    tq = _solver(name, use_kernel=use_kernel).compute(_port(m))
    assert tq._delegate is None and jq._delegate is None
    assert tq._kernel_gate and tq._p2w is not None  # B3 and B4 gates fire
    assert (tq._chain_kernel is not None) == (name == "tall_64x10x4")
    assert tq._fac_kernel == use_kernel
    assert tq.info() == qt.ComputationInfo.SUCCESS
    soa = lambda a: np.moveaxis(_np(a), -1, 0)  # noqa: E731  reference: segment axis last
    pairs = [
        (tq._Yws, soa(jq._Yws)), (tq._Ts, soa(jq._Ts)), (tq._r_panels, soa(jq._r_panels)),
        (tq._j2_top, _np(jq._j2_top).transpose(0, 2, 1)), (tq._Yb, jq._Yb), (tq._Tb, jq._Tb),
        (tq._chain_r, jq._chain_r),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tq.r_diagonal()), _np(jq.r_diagonal()), **TOL)
    np.testing.assert_array_equal(tq.cols_permutation().indices, jq.cols_permutation().indices)


def test_segmented_contract(case):
    """Qᵀ (P_r A P_c) = R, R upper triangular, Q Qᵀ v = v, the solve, and
    the diagonal and sparse exports against the dense R."""
    name, m, _ = case
    rng = np.random.default_rng(22)
    tq = _solver(name, use_kernel=True).compute(_port(m))
    dense = m.to_dense()
    pAP = tq.rows_permutation().apply(dense)[:, tq.cols_permutation().indices]
    R = _np(tq.matrix_r_dense())
    np.testing.assert_allclose(_np(tq.apply_qt(torch.as_tensor(pAP))), R, rtol=0, atol=1e-9)
    assert np.abs(np.tril(R, -1)).max() == 0.0
    v = rng.normal(size=m.nrows)
    np.testing.assert_allclose(_np(tq.apply_q(tq.apply_qt(torch.as_tensor(v)))), v, rtol=0, atol=1e-10)
    np.testing.assert_allclose(_np(tq.r_diagonal()), np.diag(R)[: m.ncols], rtol=0, atol=1e-12)
    np.testing.assert_allclose(tq.matrix_r_sparse().to_dense(), R, rtol=0, atol=1e-12)
    X = rng.normal(size=(m.ncols, 3))
    B = tq.rows_permutation().apply(dense @ X)
    np.testing.assert_allclose(_np(tq.solve(torch.as_tensor(B))), X, rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(tq.solve(torch.as_tensor(B[:, 1]))), X[:, 1], rtol=0, atol=1e-8)
    z = rng.normal(size=m.ncols)
    np.testing.assert_allclose(R[: m.ncols] @ _np(tq.solve_r(torch.as_tensor(z))), z, rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def tall(references):
    """The tall miniature with a rhs and the reference's solution."""
    m, jq = references("tall_64x10x4")
    b = np.random.default_rng(24).normal(size=m.nrows)
    return m, jq, b, _np(jq.solve(jnp.asarray(b)))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["general", "kernel_plain"])
def test_segmented_solve_matches_jax(tall, use_kernel):
    m, _, b, want = tall
    tq = _solver("tall_64x10x4", use_kernel=use_kernel).compute(_port(m))
    np.testing.assert_allclose(_np(tq.solve(torch.as_tensor(b))), want, **TOL)


def test_segmented_convert_roundtrip(tall):
    """The reference's factors installed in the port solve as the reference."""
    m, jq, b, want = tall
    cs = jq._chain_seq
    state = dict(
        Yws=jq._Yws, Ts=jq._Ts, r_panels=jq._r_panels, j2_top=jq._j2_top, Yb=jq._Yb,
        Tb=jq._Tb, chain_Yf=cs.Yf, chain_Tf=cs.Tf, chain_r=jq._chain_r,
    )
    state = {k: np.asarray(v) for k, v in state.items()}
    tq = convert.segmented_banded_qr_from_numpy(_port(m), state, suggested_block_cols=4, segment_blocks=8, device=DEV)
    assert tq.info() == qt.ComputationInfo.SUCCESS
    np.testing.assert_allclose(_np(tq.solve(torch.as_tensor(b))), want, **TOL)
    np.testing.assert_allclose(_np(tq.r_diagonal()), _np(jq.r_diagonal()), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["general", "kernel_plain"])
def test_segmented_factorize_values_matches_compute(tall, use_kernel):
    m = tall[0]
    tq = _solver("tall_64x10x4", use_kernel=use_kernel).compute(_port(m))
    scaled = qt.SparseCSR(m.shape, m.indptr, m.indices, m.data * 0.6)
    tq.factorize_values(torch.as_tensor(scaled.data))
    ref = _solver("tall_64x10x4", use_kernel=use_kernel).compute(scaled)
    for name in ("_r_panels", "_chain_r", "_j2_top", "_Yb"):
        np.testing.assert_allclose(_np(getattr(tq, name)), _np(getattr(ref, name)), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="values must be"):
        tq.factorize_values(np.ones(m.nnz - 1))


def test_segmented_grouped_boundary_chain_contract():
    """A long chain groups the boundary chain (G > 1); the general and the
    kernel paths agree and solve."""
    m = _port(tall_banded_matrix(96, np.random.default_rng(25), br=10, bc=4, ov=2))
    qs = [qt.SegmentedBandedQR(4, 4, use_kernel=k, device=DEV).compute(m) for k in (False, True)]
    assert qs[0]._chain_group > 1 and qs[1]._chain_kernel is not None
    np.testing.assert_allclose(_np(qs[0]._chain_r), _np(qs[1]._chain_r), **TOL)
    x_true = np.random.default_rng(26).normal(size=m.ncols)
    b = m.to_dense() @ x_true
    for q in qs:
        np.testing.assert_allclose(_np(q.solve(torch.as_tensor(b))), x_true, rtol=0, atol=1e-8)


def test_segmented_delegates_short_chain():
    """A chain shorter than 2L delegates to the plain solver (compute,
    solve, factorize_values forward); fallback=False raises instead."""
    rng = np.random.default_rng(27)
    m = _port(overlapping_block_diagonal_matrix(32, 112, rng, permute_rows=False))
    qr = qt.SegmentedBandedQR(suggested_block_cols=2, segment_blocks=32, device=DEV).compute(m)
    assert isinstance(qr._delegate, qt.BandedBlockedQR)
    assert qr.info() == qt.ComputationInfo.SUCCESS
    x_true = rng.normal(size=m.ncols)
    scaled = qt.SparseCSR(m.shape, m.indptr, m.indices, m.data * 2.5)
    qr.factorize_values(torch.as_tensor(scaled.data))
    b = qr.rows_permutation().apply(scaled.to_dense() @ x_true)
    np.testing.assert_allclose(_np(qr.solve(torch.as_tensor(b))), x_true, rtol=0, atol=1e-8)
    with pytest.raises(ValueError, match="BandedBlockedQR"):
        qt.SegmentedBandedQR(suggested_block_cols=2, segment_blocks=32, fallback=False, device=DEV).compute(m)


def test_segmented_use_kernel_true_raises_without_gate(tall):
    qr = _solver("tall_64x10x4", use_kernel=True)
    qr.analyze_pattern(_port(tall[0]))
    qr._kernel_gate = False  # as on a plan with a non-uniform column step
    with pytest.raises(ValueError, match="use_kernel"):
        qr.compute(_port(tall[0]))
