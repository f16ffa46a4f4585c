"""The port's BandedBlockedQR and compact-WY sequences against qrkit_tpu's
(XLA path, ``use_pallas=False``), on the same inputs, fp64.

Oracles: tests/test_banded.py and tests/test_factorize_values.py.  The
matrices are tall random blocks (every panel full rank): on the overlapping
7×2 fixture each panel's overlap columns are exactly rank-deficient, so
their reflectors are roundoff noise that two summation orders legitimately
resolve differently (the solve still agrees).  The reference solvers are
built once per module (each instance compiles its own programs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrkit_tpu.ops import compact_wy as jwy
from qrkit_tpu.ops.householder import panel_qr_yt_soa as j_panel_qr_yt_soa
from qrkit_tpu.solvers import BandedBlockedQR as JBanded
from qrkit_tpu.sparse import Permutation as JPermutation

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import convert
from qrkit_tpu_torch.ops import compact_wy as twy
from qrkit_tpu_torch.ops.householder import panel_qr_yt_soa

from generators import block_diagonal_matrix, overlapping_block_diagonal_matrix, tall_banded_matrix

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA

TOL = dict(rtol=1e-10, atol=1e-11)


def _port(m):
    return qt.SparseCSR(m.shape, m.indptr, m.indices, m.data)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module", params=[False, True], ids=["sorted", "rowpermuted"])
def pair(request):
    """(matrix, reference solver) on 40 tall 9×4 blocks overlapping 2."""
    rng = np.random.default_rng(11)
    m = tall_banded_matrix(40, rng, br=9, bc=4, ov=2)
    if request.param:
        m = m.permute_rows(JPermutation(rng.permutation(m.nrows)))
    return m, JBanded(suggested_block_cols=4, use_pallas=False).compute(m)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["general", "kernel_plain"])
def test_banded_factors_match(pair, use_kernel):
    m, jq = pair
    tq = qt.BandedBlockedQR(suggested_block_cols=4, use_kernel=use_kernel, device=DEV).compute(_port(m))
    assert tq._fac_kernel == use_kernel and tq._chain_kernel is not None
    assert tq.info() == qt.ComputationInfo.SUCCESS
    np.testing.assert_array_equal(tq.rows_permutation().indices, jq.rows_permutation().indices)
    nb = tq.plan.num_blocks
    np.testing.assert_allclose(_np(tq.q_seq.Y).reshape(nb, -1), _np(jq.q_seq.Yf), **TOL)
    np.testing.assert_allclose(_np(tq.q_seq.T).reshape(nb, -1), _np(jq.q_seq.Tf), **TOL)
    np.testing.assert_allclose(_np(tq.r_panels), _np(jq.r_panels), **TOL)
    np.testing.assert_allclose(_np(tq.r_diagonal()), _np(jq.r_diagonal()), **TOL)
    np.testing.assert_allclose(_np(tq.matrix_r_dense()), _np(jq.matrix_r_dense()), **TOL)


def test_banded_solves_and_products_match(pair):
    m, jq = pair
    rng = np.random.default_rng(12)
    tq = qt.BandedBlockedQR(suggested_block_cols=4, device=DEV).compute(_port(m))
    x_true = rng.normal(size=m.ncols)
    b = tq.rows_permutation().apply(m.to_dense() @ x_true)
    x = _np(tq.solve(torch.as_tensor(b)))
    np.testing.assert_allclose(x, _np(jq.solve(jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(x, x_true, rtol=0, atol=1e-9)
    B = rng.normal(size=(m.nrows, 3))
    np.testing.assert_allclose(_np(tq.solve(torch.as_tensor(B))), _np(jq.solve(jnp.asarray(B))), **TOL)
    for port_fn, jax_fn in ((tq.apply_qt, jq.apply_qt), (tq.apply_q, jq.apply_q)):
        np.testing.assert_allclose(_np(port_fn(torch.as_tensor(B))), _np(jax_fn(jnp.asarray(B))), **TOL)
    y = rng.normal(size=m.ncols)
    np.testing.assert_allclose(_np(tq.solve_r(torch.as_tensor(y))), _np(jq.solve_r(jnp.asarray(y))), **TOL)


def test_banded_sparse_exports_match(pair):
    m, jq = pair
    tq = qt.BandedBlockedQR(suggested_block_cols=4, device=DEV).compute(_port(m))
    np.testing.assert_allclose(tq.matrix_r_sparse().to_dense(), jq.matrix_r_sparse().to_dense(), **TOL)
    Q = tq.matrix_q_sparse().to_dense()
    np.testing.assert_allclose(Q, jq.matrix_q_sparse().to_dense(), **TOL)
    pA = tq.rows_permutation().apply(m.to_dense())
    np.testing.assert_allclose(Q @ _np(tq.matrix_r_dense()), pA, rtol=0, atol=1e-10)


@pytest.mark.parametrize("as_tensor", [True, False], ids=["device_tensor", "numpy"])
def test_banded_factorize_values_matches_compute(pair, as_tensor):
    m, jq = pair
    tq = qt.BandedBlockedQR(suggested_block_cols=4, device=DEV).compute(_port(m))
    scaled = qt.SparseCSR(m.shape, m.indptr, m.indices, m.data * 1.7)
    vals = torch.as_tensor(scaled.data) if as_tensor else scaled.data
    tq.factorize_values(vals)  # original stored order
    ref = qt.BandedBlockedQR(suggested_block_cols=4, device=DEV).compute(scaled)
    np.testing.assert_allclose(_np(tq.r_panels), _np(ref.r_panels), rtol=0, atol=1e-12)
    jq2 = JBanded(suggested_block_cols=4, use_pallas=False).compute(m)
    jq2.factorize_values(jnp.asarray(scaled.data))
    np.testing.assert_allclose(_np(tq.r_panels), _np(jq2.r_panels), **TOL)
    with pytest.raises(ValueError, match="values must be"):
        tq.factorize_values(np.ones(m.nnz + 1))


def test_banded_static_pattern_matches():
    rng = np.random.default_rng(13)
    m = block_diagonal_matrix(128, 448, rng, permute_rows=False)
    jq = JBanded(block_rows=7, block_cols=2, block_overlap=0).compute(m)
    tq = qt.BandedBlockedQR(block_rows=7, block_cols=2, block_overlap=0, device=DEV).compute(_port(m))
    assert [b.astuple() for b in tq.plan.blocks] == [b.astuple() for b in jq.plan.blocks]
    assert tq.rows_permutation().is_identity()
    np.testing.assert_allclose(_np(tq.matrix_r_dense()), _np(jq.matrix_r_dense()), **TOL)
    b = rng.normal(size=m.nrows)
    np.testing.assert_allclose(_np(tq.solve(torch.as_tensor(b))), _np(jq.solve(jnp.asarray(b))), **TOL)


def test_banded_degenerate_overlap_fixture_solves():
    """The reference's overlapping 7×2 fixture (rank-deficient overlap
    columns in every panel): R's emitted rows agree up to the sign of a row
    (a reflector on a roundoff-level column may flip), the solution
    agrees."""
    rng = np.random.default_rng(14)
    m = overlapping_block_diagonal_matrix(128, 448, rng, permute_rows=False)
    jq = JBanded(suggested_block_cols=2, use_pallas=False).compute(m)
    tq = qt.BandedBlockedQR(suggested_block_cols=2, use_kernel=True, device=DEV).compute(_port(m))
    np.testing.assert_allclose(np.abs(_np(tq.r_panels)), np.abs(_np(jq.r_panels)), rtol=0, atol=1e-12)
    x_true = rng.normal(size=m.ncols)
    b = m.to_dense() @ x_true
    np.testing.assert_allclose(_np(tq.solve(torch.as_tensor(b))), x_true, rtol=0, atol=1e-8)


def test_banded_use_kernel_true_raises_on_short_chain():
    rng = np.random.default_rng(15)
    m = _port(overlapping_block_diagonal_matrix(32, 112, rng, permute_rows=False))
    with pytest.raises(ValueError, match="use_kernel"):
        qt.BandedBlockedQR(suggested_block_cols=2, use_kernel=True, device=DEV).compute(m)
    qr = qt.BandedBlockedQR(suggested_block_cols=2, device=DEV).compute(m)  # "auto": general path
    assert qr._chain_kernel is None and not qr._fac_kernel


def test_banded_convert_roundtrip(pair):
    """The reference's factors installed in the port: solve, Q products and
    diagonal equal the reference's."""
    m, jq = pair
    state = dict(Yf=np.asarray(jq.q_seq.Yf), Tf=np.asarray(jq.q_seq.Tf), r_panels_f=np.asarray(jq._r_panels_f))
    tq = convert.banded_qr_from_numpy(_port(m), state, suggested_block_cols=4, device=DEV)
    assert tq.info() == qt.ComputationInfo.SUCCESS
    b = np.random.default_rng(16).normal(size=m.nrows)
    np.testing.assert_allclose(_np(tq.solve(torch.as_tensor(b))), _np(jq.solve(jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(_np(tq.apply_qt(torch.as_tensor(b))), _np(jq.apply_qt(jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(_np(tq.r_diagonal()), _np(jq.r_diagonal()), **TOL)


@pytest.mark.parametrize("transpose", [False, True], ids=["q", "qt"])
def test_wy_sequences_match(transpose):
    """TwoSegmentWYSeq and CompactWYSeq on random factors (segments that
    overlap in padding rows, zero gap rows) against the reference's."""
    rng = np.random.default_rng(17)
    nb, A, C, h1, m = 6, 7, 3, 3, 30
    Y, T = rng.normal(size=(nb, A, C)), rng.normal(size=(nb, C, C))
    s1 = np.array([0, 2, 4, 6, 8, 10])
    split = np.array([0, 3, 2, 3, 1, 3])
    s2 = s1 + split + rng.integers(0, 3, size=nb)
    M = rng.normal(size=(m, 2))
    j2 = jwy.TwoSegmentWYSeq(jnp.asarray(Y), jnp.asarray(T), jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(split), h1=h1, m=m)
    t2 = twy.TwoSegmentWYSeq(torch.as_tensor(Y), torch.as_tensor(T), s1, s2, split, h1=h1, m=m)
    fn = "apply_qt" if transpose else "apply_q"
    for x in (M, M[:, 0]):
        np.testing.assert_allclose(_np(getattr(t2, fn)(torch.as_tensor(x))), _np(getattr(j2, fn)(jnp.asarray(x))), **TOL)
    start = np.array([0, 3, 5, 9, 14, 20])
    jc = jwy.CompactWYSeq(jnp.asarray(Y), jnp.asarray(T), jnp.asarray(start, dtype=jnp.int32), m)
    tc = twy.CompactWYSeq(torch.as_tensor(Y), torch.as_tensor(T), start, m)
    np.testing.assert_allclose(_np(getattr(tc, fn)(torch.as_tensor(M))), _np(getattr(jc, fn)(jnp.asarray(M))), **TOL)
    both = twy.CompactWYSeq.concat(tc, twy.CompactWYSeq.single(torch.as_tensor(Y[0]), torch.as_tensor(T[0]), 2, m))
    jboth = jwy.CompactWYSeq.concat(jc, jwy.CompactWYSeq.single(jnp.asarray(Y[0]), jnp.asarray(T[0]), 2, m))
    np.testing.assert_allclose(_np(both.to_dense_q()), _np(jboth.to_dense_q()), **TOL)
    np.testing.assert_allclose(tc.to_sparse_q(chunk=7).to_dense(), _np(jc.to_dense_q()), **TOL)


def test_panel_qr_yt_soa_matches():
    rng = np.random.default_rng(18)
    A = rng.normal(size=(11, 4, 5))
    for got, want in zip(panel_qr_yt_soa(torch.as_tensor(A)), j_panel_qr_yt_soa(jnp.asarray(A))):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
