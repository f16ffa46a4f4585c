"""The port's blocked thin solvers and the library-QR route of panel_qr_yt
against qrkit_tpu, fp64.

``panel_qr_yt_lapack`` (``torch.geqrf`` against ``jnp.linalg.qr(mode="raw")``),
the wide ColPiv QR (the reference's scanned form), ``BlockedThinDenseQR``
(panel loop and the wide route) and ``BlockedThinSparseQR`` (orderings,
per-panel pivots, ragged last panel, rank, deficient columns and the
rank-deficient repair) on the same NumPy inputs: factors and solutions to
rtol 1e-10, permutations and ranks exactly.  No kernel runs on these paths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrkit_tpu.ops import householder as jh
from qrkit_tpu.solvers import BlockedThinDenseQR as JDense
from qrkit_tpu.solvers import BlockedThinSparseQR as JSparse
from qrkit_tpu.sparse import SparseCSR as JCSR

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import convert
from qrkit_tpu_torch.ops import householder as th

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA

TOL = dict(rtol=1e-10, atol=1e-10)


def close(got, want, **tol):
    np.testing.assert_allclose(
        got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), **(tol or TOL),
    )


def _port(m):
    return qt.SparseCSR(m.shape, m.indptr, m.indices, m.data)


@pytest.mark.parametrize("shape", [(120, 40), (64, 64), (300, 100)])
def test_panel_qr_yt_lapack_matches(rng, shape):
    a = rng.normal(size=shape)
    for got, want in zip(th.panel_qr_yt_lapack(torch.as_tensor(a)),
                         jh.panel_qr_yt_lapack(jnp.asarray(a))):
        close(got, want)
    # panel_qr_yt delegates past 32 columns, as the reference does
    for got, want in zip(th.panel_qr_yt(torch.as_tensor(a)), jh.panel_qr_yt(jnp.asarray(a))):
        close(got, want)
    Y, T, R = th.panel_qr_yt(torch.as_tensor(a))
    q = th.form_q(Y, T).numpy()
    np.testing.assert_allclose(q @ R.numpy(), a, atol=1e-12)


def test_colpiv_wide_matches_scanned_form(rng):
    a = rng.normal(size=(70, 56))  # past the reference's 48-column unroll
    got = th.colpiv_householder_qr(torch.as_tensor(a))
    want = jh.colpiv_householder_qr(jnp.asarray(a))
    for g, w in zip(got[:3], want[:3]):
        close(g, w)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def _check_thin(tqr, jqr, rng):
    m = tqr.rows
    close(tqr.q_seq.Y, jqr.q_seq.Y)
    close(tqr.q_seq.T, jqr.q_seq.T)
    np.testing.assert_array_equal(tqr.q_seq.start.numpy(), np.asarray(jqr.q_seq.start))
    close(tqr.matrix_r_dense(), jqr.matrix_r_dense())
    np.testing.assert_array_equal(tqr.cols_permutation().indices, jqr.cols_permutation().indices)
    np.testing.assert_array_equal(tqr.rows_permutation().indices, jqr.rows_permutation().indices)
    assert tqr.rank == jqr.rank
    assert tqr.info() == qt.ComputationInfo.SUCCESS
    b = rng.normal(size=m)
    M = rng.normal(size=(m, 3))
    close(tqr.solve(torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))
    close(tqr.apply_qt(torch.as_tensor(M)), jqr.apply_qt(jnp.asarray(M)))
    close(tqr.apply_q(torch.as_tensor(M)), jqr.apply_q(jnp.asarray(M)))


@pytest.mark.parametrize("shape,c", [((60, 11), 2), ((30, 7), 3), ((150, 70), 2)],
                         ids=["panels-c2", "ragged-c3", "wide-geqrf"])
def test_thin_dense_matches(rng, shape, c):
    a = rng.normal(size=shape)
    tqr = qt.BlockedThinDenseQR(suggested_block_cols=c, device=DEV).compute(a)
    jqr = JDense(suggested_block_cols=c).compute(jnp.asarray(a))
    assert tqr._R.device.type == "cpu" and tqr._R.dtype == torch.float64
    _check_thin(tqr, jqr, rng)
    x_true = rng.normal(size=shape[1])
    close(tqr.solve(torch.as_tensor(a @ x_true)), x_true, rtol=0, atol=1e-9)


def _sparse_tall(rng, m=80, n=10, density=0.3):
    """tests/test_blocked_thin.py's fixture: random pattern, no empty row
    or column, one dense column."""
    mask = rng.uniform(size=(m, n)) < density
    mask[np.arange(n), np.arange(n)] = True
    mask[:, -1] = True
    vals = rng.normal(size=(m, n)) * mask
    for i in range(m):
        if not mask[i].any():
            vals[i, rng.integers(n)] = rng.normal()
    return JCSR.from_dense(vals)


@pytest.mark.parametrize("c,fused", [(2, True), (3, True), (2, False)],
                         ids=["c2", "c3-ragged", "c2-eager"])
def test_thin_sparse_matches(rng, c, fused):
    mat = _sparse_tall(rng, m=90, n=11)
    tqr = qt.BlockedThinSparseQR(suggested_block_cols=c, fused=fused, device=DEV).compute(_port(mat))
    jqr = JSparse(suggested_block_cols=c, fused=fused).compute(mat)
    assert tqr._panel_heights(tqr._analyze(_port(mat))[0]) == jqr._panel_heights(
        jqr._analyze(mat)[0])
    _check_thin(tqr, jqr, rng)
    assert tqr.rank == mat.ncols
    assert tqr.house_cols_permutation().is_identity()
    np.testing.assert_array_equal(tqr.deficient_cols(), jqr.deficient_cols())


def test_thin_sparse_rank_deficient_matches(rng):
    m, n = 40, 8
    A = rng.normal(size=(m, n))
    A[:, 6] = A[:, 2]
    A[:, 7] = 2.0 * A[:, 0]
    b = rng.normal(size=m)
    tqr = qt.BlockedThinSparseQR(suggested_block_cols=3, device=DEV).compute(qt.SparseCSR.from_dense(A))
    jqr = JSparse(suggested_block_cols=3).compute(JCSR.from_dense(A))
    assert tqr.rank == jqr.rank == 6
    np.testing.assert_array_equal(tqr.deficient_cols(), jqr.deficient_cols())
    np.testing.assert_array_equal(tqr.house_cols_permutation().indices,
                                  jqr.house_cols_permutation().indices)
    np.testing.assert_array_equal(tqr.cols_permutation().indices, jqr.cols_permutation().indices)
    # the live part of the factorization; a dead pivot's reflector is roundoff
    close(tqr.matrix_r_dense(), jqr.matrix_r_dense(), rtol=1e-10, atol=1e-9)
    # which of two equal columns carries the basic solution is a roundoff
    # tie-break of the repair's pivot search; the fitted values are unique
    x = tqr.solve(torch.as_tensor(b))
    close(A @ x.numpy(), A @ np.asarray(jqr.solve(jnp.asarray(b))))
    assert int((x.numpy() == 0).sum()) == 2
    # residual-optimal against lstsq
    r_opt = np.linalg.norm(A @ np.linalg.lstsq(A, b, rcond=None)[0] - b)
    assert np.linalg.norm(A @ x.numpy() - b) <= r_opt * (1 + 1e-8)


def test_thin_sparse_dense_and_tensor_input(rng):
    a = rng.normal(size=(40, 6))
    jqr = JSparse(suggested_block_cols=3).compute(jnp.asarray(a))
    for inp in (a, torch.as_tensor(a)):
        tqr = qt.BlockedThinSparseQR(suggested_block_cols=3, device=DEV).compute(inp)
        close(tqr.matrix_r_dense(), jqr.matrix_r_dense())


def test_convert_blocked_thin(rng):
    """Carrying a computed reference solver's state through NumPy gives a
    port solver that solves like it."""
    mat = _sparse_tall(rng, m=70, n=9)
    a = rng.normal(size=(50, 7))
    b_sp, b_d = rng.normal(size=70), rng.normal(size=50)
    for jqr, b in ((JSparse(suggested_block_cols=2).compute(mat), b_sp),
                   (JDense(suggested_block_cols=2).compute(jnp.asarray(a)), b_d)):
        state = {"Y": jqr.q_seq.Y, "T": jqr.q_seq.T, "start": jqr.q_seq.start,
                 "R": jqr.matrix_r_dense()}
        if isinstance(jqr, JSparse):
            state.update(col_perm=jqr.cols_permutation().indices,
                         row_perm=jqr.rows_permutation().indices)
        tqr = convert.blocked_thin_qr_from_numpy(state, device=DEV)
        assert isinstance(tqr, qt.BlockedThinSparseQR if "col_perm" in state else qt.BlockedThinDenseQR)
        assert tqr.info() == qt.ComputationInfo.SUCCESS
        assert tqr.rank == jqr.rank
        close(tqr.solve(torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))
        close(tqr.apply_q(torch.as_tensor(b)), jqr.apply_q(jnp.asarray(b)))
