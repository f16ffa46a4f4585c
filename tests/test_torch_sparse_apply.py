"""The port's sparse-operand Q products and the chunked sparse-A2
block-angular composition against qrkit_tpu, fp64.

Both banded solvers (``BandedBlockedQR``, and ``SegmentedBandedQR`` with its
kernel gates on: on the CPU the kernels' plain versions run) on the same
tall banded matrix: the structural fill arrays equal the reference's exactly
in both directions, the pruned sparse products agree with the reference's
pattern for pattern and to rtol 1e-10 in value, and ``BlockAngularQR`` with a
banded or segmented left and a sparse A2 solves like the reference's to rtol
1e-10.  Oracle: tests/test_sparse_apply.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qrkit_tpu as jq
from qrkit_tpu.solvers import sparse_apply as jsa

import qrkit_tpu_torch as qt
from qrkit_tpu_torch.solvers import sparse_apply as tsa

from generators import block_angular_matrix, tall_banded_matrix

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA

TOL = dict(rtol=1e-10, atol=1e-12)
NB, BR, BC, OV, L, SUG = 64, 10, 4, 2, 8, 4


def _port(m):
    return qt.SparseCSR(m.shape, m.indptr, m.indices, m.data)


def _sparse_operand(rng, m, m2=7):
    """tests/test_sparse_apply.py's operand: 5-nonzero columns and one
    spread column (early and late fill triggers)."""
    r_, c_, v_ = [], [], []
    for j in range(m2 - 1):
        r_.extend(rng.choice(m, size=5, replace=False))
        c_.extend([j] * 5)
        v_.extend(rng.normal(size=5))
    spread = list(range(0, m, 3))
    r_.extend(spread)
    c_.extend([m2 - 1] * len(spread))
    v_.extend(rng.normal(size=len(spread)))
    return jq.SparseCSR.from_triplets(r_, c_, v_, (m, m2))


def _make(kind, port: bool):
    if kind == "banded":
        return (qt.BandedBlockedQR(suggested_block_cols=SUG, device=DEV) if port
                else jq.BandedBlockedQR(suggested_block_cols=SUG))
    if port:
        return qt.SegmentedBandedQR(suggested_block_cols=SUG, segment_blocks=L, fallback=False,
                                    use_kernel=True, device=DEV)
    return jq.SegmentedBandedQR(suggested_block_cols=SUG, segment_blocks=L, fallback=False,
                                use_pallas=False)


@pytest.fixture(scope="module")
def solvers():
    """kind -> (matrix, port solver, reference solver), built on first use."""
    cache = {}

    def get(kind):
        if kind not in cache:
            mat = tall_banded_matrix(NB, np.random.default_rng(5), br=BR, bc=BC, ov=OV)
            cache[kind] = (mat, _make(kind, True).compute(_port(mat)), _make(kind, False).compute(mat))
        return cache[kind]

    return get


@pytest.mark.parametrize("kind", ["banded", "segmented"])
@pytest.mark.parametrize("transpose", [True, False], ids=["qt", "q"])
def test_structural_fill_equals_reference(solvers, rng, kind, transpose):
    mat, tqr, jqr = solvers(kind)
    S = _sparse_operand(rng, mat.nrows)
    row_map = rng.permutation(mat.nrows)
    for rm in (None, row_map):
        got = tqr._sparse_apply_parts(transpose)[0](_port(S), rm)
        want = jqr._sparse_apply_parts(transpose)[0](S, rm)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    if kind == "banded":  # the fill function itself, on the same geometry
        got = tsa.banded_structural_fill(tqr.geom, tqr.plan.num_blocks, mat.nrows, _port(S), transpose)
        want = jsa.banded_structural_fill(jqr.geom, jqr.plan.num_blocks, mat.nrows, S, transpose)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["banded", "segmented"])
def test_sparse_products_match(solvers, rng, kind):
    mat, tqr, jqr = solvers(kind)
    S = _sparse_operand(rng, mat.nrows)
    for name in ("apply_qt_sparse", "apply_q_sparse"):
        got, want = getattr(tqr, name)(_port(S)), getattr(jqr, name)(S)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, want.data, **TOL)
        # the structural fill holds every numeric nonzero of the dense product
        dense = (tqr.apply_qt if name == "apply_qt_sparse" else tqr.apply_q)(
            torch.as_tensor(S.to_dense())).numpy()
        np.testing.assert_allclose(got.to_dense(), dense, **TOL)
        assert got.nnz == int((dense != 0).sum())


def test_sparse_product_plan_cache_and_byte_cap(solvers, rng, monkeypatch):
    """A second product on one layout reuses the plan and runs no dense
    apply of its own; a byte cap below the stacked operand splits it into
    chunk groups with the same result."""
    mat, tqr, _ = solvers("banded")
    m = mat.nrows
    S = jq.SparseCSR.from_triplets(np.arange(300) % m, np.arange(300), rng.normal(size=300), (m, 300))
    out1 = tqr.apply_qt_sparse(_port(S))
    ent = tqr._sparse_apply_cache[True]
    assert (ent["plan"]["w"], ent["plan"]["T"]) == (128, 3)
    S2 = qt.SparseCSR(S.shape, S.indptr, S.indices, S.data * 2.0)
    calls = []
    orig = tqr.q_seq.apply_qt
    tqr.q_seq.apply_qt = lambda M: calls.append(M.shape) or orig(M)
    try:
        out2 = tqr.apply_qt_sparse(S2)
    finally:
        del tqr.q_seq.apply_qt
    assert tqr._sparse_apply_cache[True] is ent
    assert calls == [(m, 384)]  # the three chunks stacked into one apply
    np.testing.assert_allclose(out2.to_dense(), 2.0 * out1.to_dense(), **TOL)
    fill_fn, apply_fn = tqr._sparse_apply_parts(True)
    fr, fc = fill_fn(_port(S), None)
    full = ent["plan"]
    monkeypatch.setattr(tsa, "BYTE_CAP", 1)  # one chunk an apply
    small = tsa.build_fused_sparse_apply(apply_fn, fr, fc, _port(S), m, device=DEV)
    vals = torch.as_tensor(S.data)
    sel = torch.arange(full["T"] * int(full["maps"]["out_rows"].shape[1]))
    (a,) = small["run"](tqr.q_seq, {}, vals, small["maps"], (sel,))
    (b,) = full["run"](tqr.q_seq, {}, vals, full["maps"], (sel,))
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_protocol_default_sparse_products(rng):
    a = rng.normal(size=(12, 6))
    S = jq.SparseCSR.from_dense(np.where(rng.random((12, 4)) < 0.3, 1.0, 0.0))
    tqr = qt.DenseHouseholderQR().compute(torch.as_tensor(a))
    jqr = jq.DenseHouseholderQR().compute(jnp.asarray(a))
    for name in ("apply_qt_sparse", "apply_q_sparse"):
        got, want = getattr(tqr, name)(_port(S)), getattr(jqr, name)(S)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, want.data, **TOL)
    np.testing.assert_allclose(tqr.matrix_q_dense().numpy(), np.asarray(jqr.matrix_q_dense()), **TOL)
    np.testing.assert_allclose(tqr.matrix_q_sparse().to_dense(), jqr.matrix_q_sparse().to_dense(),
                               **TOL)
    assert tqr.validate() == qt.ComputationInfo.SUCCESS
    assert tqr.validate(rtol=2.0) == qt.ComputationInfo.NUMERICAL_ISSUE


@pytest.mark.parametrize("kind", ["banded", "segmented"])
def test_block_angular_sparse_a2_chunked_matches(rng, kind):
    npar, nang = 96, 5
    mat = block_angular_matrix(npar, nang, 7 * (npar // 2), rng)
    left_m = mat.slice_cols(0, npar)
    dense_r = mat.hstack_dense_block(npar, nang)
    a2 = jq.SparseCSR.from_dense(np.where(rng.random(dense_r.shape) < 0.4, dense_r, 0.0))
    tqr = qt.BlockAngularQR(_make(kind, True), qt.DenseColPivQR())
    jqr = jq.BlockAngularQR(_make(kind, False), jq.DenseColPivQR())
    tqr.compute(qt.BlockMatrix1x2(_port(left_m), _port(a2)))
    jqr.compute(jq.BlockMatrix1x2(left_m, a2))
    ent = tqr._plan_cache["banded_a2"]
    np.testing.assert_array_equal(tqr.rows_permutation().indices, jqr.rows_permutation().indices)
    np.testing.assert_array_equal(tqr._top_cols, jqr._top_cols)
    np.testing.assert_allclose(tqr._top_vals_dev.numpy(), np.asarray(jqr._top_vals_dev), **TOL)
    b = rng.normal(size=mat.nrows)
    bp = qt.Permutation(tqr.rows_permutation().indices).apply(b)
    x = tqr.solve(torch.as_tensor(bp))
    np.testing.assert_allclose(x.numpy(), np.asarray(jqr.solve(jnp.asarray(bp))), **TOL)
    Ad = np.concatenate([left_m.to_dense(), a2.to_dense()], axis=1)
    np.testing.assert_allclose(x.numpy(), np.linalg.lstsq(Ad, b, rcond=None)[0], atol=1e-9)
    # a recompute on the same layout reuses the plan
    scaled = qt.SparseCSR(a2.shape, a2.indptr, a2.indices, a2.data * 1.7)
    tqr.compute(qt.BlockMatrix1x2(_port(left_m), scaled))
    assert tqr._plan_cache["banded_a2"] is ent
    Ad2 = np.concatenate([left_m.to_dense(), 1.7 * a2.to_dense()], axis=1)
    np.testing.assert_allclose(tqr.solve(torch.as_tensor(bp)).numpy(),
                               np.linalg.lstsq(Ad2, b, rcond=None)[0], atol=1e-9)
